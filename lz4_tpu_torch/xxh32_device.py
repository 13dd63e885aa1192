"""Batched XXH32 on the device: kernel B6 (`csrc/xxh32.cu`) and its plain
PyTorch version.

Contract of `lz4_tpu.xxh32_device.xxh32_blocks` (and of
`xxh32_blocks_pallas`, which computes the same function): data
uint8[B, cap], lens int32[B], seed in [0, 2^32) -> the XXH32 of each row's
first lens[b] bytes. cap must be a multiple of 16; bytes past a row's
length are ignored. The values come back as an int64 tensor holding
[0, 2^32), since torch's uint32 has few operations.

Used to check a decoded batch on the device against host hashes of the
source blocks without copying the batch back (the port's bench).
"""
from __future__ import annotations

import torch

from lz4_tpu_torch.block.batch import resolve_device

P1 = 2654435761
P2 = 2246822519
P3 = 3266489917
P4 = 668265263
P5 = 374761393
_M32 = 0xFFFFFFFF

#: kernel launches made by `xxh32_blocks` (and nowhere else)
launches = 0


def _check(data, lens, seed, cap):
    if not isinstance(data, torch.Tensor) or data.dtype != torch.uint8 \
            or data.dim() != 2:
        raise TypeError("data must be a uint8[B, cap] tensor")
    if cap <= 0 or cap % 16 or data.shape[1] != cap:
        raise ValueError(f"data must be uint8[B, {cap}] with cap a positive "
                         f"multiple of 16, got {tuple(data.shape)}")
    if not isinstance(lens, torch.Tensor) or lens.dtype != torch.int32 \
            or tuple(lens.shape) != (data.shape[0],):
        raise TypeError("lens must be an int32[B] tensor")
    for name, t in (("data", data), ("lens", lens)):
        if t.device != data.device:
            raise ValueError(f"{name} is on {t.device}, not {data.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 <= int(seed) <= _M32:
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")


def xxh32_blocks(data, lens, seed: int = 0, *, cap: int) -> torch.Tensor:
    """XXH32 of each row (see the module docstring). CPU tensors run the
    plain version; CUDA tensors launch B6. numpy arrays go to the GPU
    (raising where there is none)."""
    global launches
    if not isinstance(data, torch.Tensor):
        device = resolve_device(None)
        data = torch.as_tensor(data).to(device)
        lens = torch.as_tensor(lens).to(device)
    _check(data, lens, seed, cap)
    if data.device.type == "cpu":
        return xxh32_blocks_plain(data, lens, seed, cap=cap)
    if data.device.type != "cuda":
        raise ValueError(f"no B6 kernel for device {data.device}")
    if data.data_ptr() % 16:
        raise ValueError("data must start on a 16-byte boundary (B6 reads "
                         "16-byte stripes)")
    B = data.shape[0]
    out = torch.empty(B, dtype=torch.int64, device=data.device)
    if B == 0:
        return out
    from lz4_tpu_torch import _build
    fn = _build.load("xxh32")
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = fn(data.data_ptr(), lens.data_ptr(), out.data_ptr(), B, cap,
                int(seed), stream)
    if rc != 0:
        raise RuntimeError(f"B6 xxh32 launch failed: CUDA error {rc}")
    launches += 1
    return out


# --------------------------------------------------------------------------
# plain version: the stripe scan with a [B, 4] carry, in int64 masked to
# 32 bits (products split so that none overflows)
# --------------------------------------------------------------------------

def _mul(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2^32 for a in [0, 2^32) and a constant k < 2^32."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _round(acc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _mul(_rotl((acc + _mul(w, P2)) & _M32, 13), P1)


def xxh32_blocks_plain(data: torch.Tensor, lens: torch.Tensor,
                       seed: int = 0, *, cap: int) -> torch.Tensor:
    """Plain PyTorch version of B6 on CPU tensors (the JAX scan and its
    finalization)."""
    B = data.shape[0]
    d = data.to(torch.int64)
    w = d[:, 0::4] | (d[:, 1::4] << 8) | (d[:, 2::4] << 16) | \
        (d[:, 3::4] << 24)                                  # [B, cap/4]
    n = lens.to(torch.int64).clamp(0, cap)
    seed = int(seed) & _M32
    acc = torch.tensor([(seed + P1 + P2) & _M32, (seed + P2) & _M32, seed,
                        (seed - P1) & _M32], dtype=torch.int64)
    acc = acc.repeat(B, 1)                                   # [B, 4]
    stripes = w.reshape(B, cap // 16, 4)
    for s in range(cap // 16):
        active = ((s + 1) * 16 <= n)[:, None]
        acc = torch.where(active, _round(acc, stripes[:, s]), acc)
    h_big = (_rotl(acc[:, 0], 1) + _rotl(acc[:, 1], 7)
             + _rotl(acc[:, 2], 12) + _rotl(acc[:, 3], 18)) & _M32
    h = torch.where(n >= 16, h_big, torch.full_like(n, (seed + P5) & _M32))
    h = (h + n) & _M32
    tail = (n // 16) * 16
    nw = (n - tail) // 4
    widx = tail // 4
    for k in range(3):
        wk = w.gather(1, (widx + k).clamp(max=w.shape[1] - 1)[:, None])[:, 0]
        h = torch.where(nw > k, _mul(_rotl((h + _mul(wk, P3)) & _M32, 17),
                                     P4), h)
    bstart = tail + nw * 4
    nb = n - bstart
    for k in range(3):
        bk = d.gather(1, (bstart + k).clamp(max=cap - 1)[:, None])[:, 0]
        h = torch.where(nb > k, _mul(_rotl((h + _mul(bk, P5)) & _M32, 11),
                                     P1), h)
    h = _mul(h ^ (h >> 15), P2)
    h = _mul(h ^ (h >> 13), P3)
    return h ^ (h >> 16)
