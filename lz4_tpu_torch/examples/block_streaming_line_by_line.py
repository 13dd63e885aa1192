"""Line-by-line streaming — the blockStreaming_lineByLine.c analog.

Each text line is one tiny block compressed against the rolling history
of previous lines; tiny-block compression only pays off because the
64 KB window spans lines.

    python -m lz4_tpu_torch.examples.block_streaming_line_by_line
"""
import io

from lz4_tpu_torch.block.backend import HostBackend
from lz4_tpu_torch.constants import LZ4_DISTANCE_MAX
from lz4_tpu_torch.utils.datagen import gen_text


def main():
    backend = HostBackend()
    text = gen_text(64 * 1024, seed=7)
    # cut the lorem text into ~72-char "lines" at word boundaries
    lines, cur = [], bytearray()
    for word in text.split(b" "):
        cur += word + b" "
        if len(cur) >= 72:
            lines.append(bytes(cur[:-1] + b"\n"))
            cur.clear()
    if cur:
        lines.append(bytes(cur))

    history = bytearray()
    packed = []
    for ln in lines:
        prefix = bytes(history[-LZ4_DISTANCE_MAX:])
        comp = backend.compress_batch([ln], dict_prefixes=[prefix or None])[0]
        packed.append((len(ln), comp))
        history += ln

    history = bytearray()
    out = io.BytesIO()
    for raw_len, comp in packed:
        prefix = bytes(history[-LZ4_DISTANCE_MAX:])
        dec = backend.decompress_batch(
            [comp], [raw_len], dict_prefixes=[prefix or None])[0]
        out.write(dec)
        history += dec

    assert out.getvalue() == b"".join(lines)
    total = sum(len(ln) for ln in lines)
    ctotal = sum(len(c) for _, c in packed)
    print(f"{len(lines)} lines, {total} -> {ctotal} bytes "
          f"({100.0 * ctotal / total:.1f}%): OK")


if __name__ == "__main__":
    main()
