"""The yardstick's byte arithmetic and table of peaks.

LZ4 does byte and integer work, so no operation bound applies; a call's
least time is its bytes, each read once and written once, at the card's
published memory bandwidth. The bytes come from the cell's data, never
from the program's padded buffers:

- compress: the uncompressed input plus the compressed sizes returned;
- decompress: the compressed input plus the uncompressed output.
"""
from __future__ import annotations

#: published HBM bandwidth in bytes a second, by `torch.cuda.
#: get_device_name()` (NVIDIA's data sheets; at the full power limit)
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,     # H100 SXM5
}


def call_bytes(in_bytes: int, out_bytes: int) -> int:
    """Bytes a call must move at least: its input read once and its
    output written once."""
    return in_bytes + out_bytes


def least_seconds(total_bytes: int, device_kind: str) -> float | None:
    """Least time of `total_bytes` on the card, None for a card the
    table does not hold."""
    peak = PEAK_BYTES_PER_S.get(device_kind)
    return None if peak is None else total_bytes / peak
