"""Host-tier frame decode, end to end: `decompress_frame` on `HostBackend`
and the CLI's `--backend host -d`, with the frame pump on and off.

    PYTHONPATH=<checkout> python <this file> [--mb 16] [--runs 3]

Times the `lz4_tpu_torch` package that Python finds first, so one command
line can time two checkouts side by side (run this file by its path with
`PYTHONPATH` naming the checkout; it reports the package's path). A
package without `FrameDecompressor.frame_pump` is timed on its Python
walk only. Frames of the real-file corpus, made on the host C tier:
4 MB linked blocks with a content checksum, 64 KB independent blocks with
block and content checksums, and 64 KB linked blocks against a 64 KB
dictionary with a content checksum; the CLI decodes the file its default
`-1` writes. Each figure is host-clock ms, best of `--runs` after a
warm-up, the pump and the walk taking turns. Prints one JSON line with
the card's name and power limit beside them. Needs one CUDA GPU (the
card the figures are recorded against; the work itself runs on the
host).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

import lz4_tpu_torch
from lz4_tpu_torch import cli
from lz4_tpu_torch.block.backend import HostBackend
from lz4_tpu_torch.frame.format import FrameInfo, Preferences
from lz4_tpu_torch.frame.reader import FrameDecompressor, decompress_frame
from lz4_tpu_torch.frame.writer import CDict, compress_frame
from lz4_tpu_torch.utils.realcorpus import real_corpus

FRAMES = {
    "4MB_linked_csum": (dict(block_size_id=7, block_independent=False,
                             content_checksum=True), False),
    "64KB_indep_bsum_csum": (dict(block_size_id=4, block_checksum=True,
                                  content_checksum=True), False),
    "64KB_linked_dict64k": (dict(block_size_id=4, block_independent=False,
                                 content_checksum=True), True),
}


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def best_ms(fns: dict, runs: int) -> dict:
    """{name: best host-clock ms of `runs` calls of fns[name]()}, after one
    warm-up call of each; the fns take turns, and which goes first
    alternates from round to round."""
    for fn in fns.values():
        fn()
    names = list(fns)
    best = dict.fromkeys(names, float("inf"))
    for r in range(runs):
        for name in names if r % 2 == 0 else names[::-1]:
            t0 = time.perf_counter()
            fns[name]()
            best[name] = min(best[name], (time.perf_counter() - t0) * 1e3)
    return best


def has_pump() -> bool:
    return hasattr(FrameDecompressor, "frame_pump")


@contextlib.contextmanager
def pump(on: bool):
    """FrameDecompressor.frame_pump set to `on` inside the block."""
    was = FrameDecompressor.frame_pump
    FrameDecompressor.frame_pump = on
    try:
        yield
    finally:
        FrameDecompressor.frame_pump = was


def modes(fn) -> dict:
    """{"pump": fn with the pump on, "walk": fn with it off}, or only
    {"walk": fn} for a package without the pump."""
    if not has_pump():
        return {"walk": fn}

    def with_pump(on):
        def run():
            with pump(on):
                return fn()
        return run
    return {"pump": with_pump(True), "walk": with_pump(False)}


def make_frames(data: bytes, dict_content: bytes, host) -> dict:
    """{name: (frame, dict or None)} of FRAMES over `data`."""
    out = {}
    for name, (info, with_dict) in FRAMES.items():
        d = dict_content if with_dict else None
        out[name] = (compress_frame(
            data, prefs=Preferences(frame_info=FrameInfo(**info)),
            backend=host, cdict=CDict(d) if d else None), d)
    return out


def time_frames(frames: dict, data: bytes, host, runs: int) -> dict:
    """{name: {"pump": ms, "walk": ms}} of decompress_frame on `host`
    (the pump where the package has one); each decode is checked."""
    out = {}
    for name, (frame, d) in frames.items():
        def run():
            if decompress_frame(frame, backend=host, dict_content=d) != data:
                raise AssertionError(f"{name}: decode differs")
        out[name] = best_ms(modes(run), runs)
    return out


def time_cli(data: bytes, runs: int) -> dict:
    """{"compress_ms": ..., "-d": {"pump": ms, "walk": ms}} of the CLI on
    the host tier on a file of `data`; the decoded file is compared."""
    with tempfile.TemporaryDirectory() as tdir:
        src = os.path.join(tdir, "corpus.bin")
        dst, back = src + ".lz4", os.path.join(tdir, "back.bin")
        with open(src, "wb") as f:
            f.write(data)

        def run(*args):
            rc = cli.main(["lz4", "--backend", "host", "-q", "-f", *args])
            if rc:
                raise AssertionError(f"CLI {args} exited {rc}")
        def decode():
            run("-d", dst, back)
            with open(back, "rb") as f:
                if f.read() != data:
                    raise AssertionError("CLI -d output differs")
        out = {"compress_ms": best_ms(
            {"c": lambda: run("-1", src, dst)}, runs)["c"]}
        out["-d"] = best_ms(modes(decode), runs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=16, help="at most 47")
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("host_frame: no CUDA device", file=sys.stderr)
        return 2
    corpus = real_corpus(48 << 20)
    data = corpus[: args.mb << 20]
    host = HostBackend()
    frames = make_frames(data, corpus[-65536:], host)
    print(json.dumps({
        "probe": "host_frame", "card": card(),
        "package": lz4_tpu_torch.__file__, "pump": has_pump(),
        "bytes": len(data), "runs": args.runs,
        "decompress_frame_ms": time_frames(frames, data, host, args.runs),
        "cli": time_cli(data, args.runs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
