"""Time-bounded randomized torture: the port's copy of the JAX package's
`tools/torture.py` (the reference's `fuzzer -T90s`, tests/fuzzer.c:147-300)
with DIFFERENTIAL decode testing. Every stream, and every mutated copy of
it, goes to the host C decoder and to the card's decoders; their
accept/reject verdicts and output bytes must agree.

    python -m lz4_tpu_torch.probes.torture --seconds 90 [--seed N]
        [--device {cuda,cpu}] [--no-device] [--kernels] [--wave]

Legs of a cycle (`run_cycle`), each on the port's own entry points:

- encode: the host C tier (`HostBackend.compress_batch`, the tool's level,
  acceleration, dict and `favor_dec_speed` draws) or the device encoder:
  the sort/scan encoder (`block/encode_sortscan.py`; 8 candidates, lazy,
  where the tool asks for level 2's graph), or with `--kernels` kernel B1
  on the tool's one 64 KB shape (acceleration 8 for the tool's `lite`);
- decode: host C is the leg of record; the device leg is the sort/scan
  decoder, or with `--kernels` kernel B2 (the tool's capacity tiers of
  64 KB times powers of 4); `--wave` adds the C wave splitter and kernel
  B3 on no-dict streams (on the CPU up to 8 KB in 8 pieces, the tool's
  limits, which keep the plain version quick; on the card up to 64 KB at
  the wave route's 64 pieces), and on the card the linked ring
  (`wave_decode_linked`) and the batch frames (`compress_frames_wave`,
  kernel B4, and `decompress_frames_wave`);
- a mutated copy of every stream longer than 4 bytes (`mutate`): host C
  and the device decoder agree exactly (verdict, and bytes where both
  accept); the wave leg never accepts what host C rejects and gives its
  bytes where both accept;
- frame torture: a frame with random options, one byte flipped; the
  `TorchBackend` decode and the `HostBackend` decode give the same bytes
  or both raise.

The tool runs the mutated-stream leg only where liblz4 exists (`if
len(comp) > 4 and oracle`), so without it no mutated stream reaches a
device decoder, and its frame leg checks nothing of a damaged frame's
outcome (`assert out == raw or True`). Here the mutated leg runs for
every stream, and only the liblz4 comparisons stay behind the oracle,
which is looked up (never built) by `find_oracle`: this does not change
what the tool tests, it stops the oracle's absence from switching the
device legs off. Where none is found the run prints `oracle: none` and
runs every other leg.

Prints `[torture] master seed N` first and the per-leg counters last (a
JSON line ends the output); on a disagreement `FAILED at cycle c seed s
(master m)` and exit 1. Runs on the card unless given `--device cpu`
(each kernel's plain version) and raises without a GPU otherwise.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from lz4_tpu_torch.block import (decode_cuda, decode_sortscan, decode_wave,
                                 encode_cuda, encode_sortscan, encode_wave)
from lz4_tpu_torch.block.backend import BlockDecodeError, HostBackend
from lz4_tpu_torch.block.batch import pack_blocks, resolve_device, \
    to_device_batch
from lz4_tpu_torch.constants import compress_bound
from lz4_tpu_torch.frame.format import FrameError, FrameInfo, Preferences
from lz4_tpu_torch.frame.reader import decompress_frame
from lz4_tpu_torch.frame.writer import compress_frame
from lz4_tpu_torch.utils.datagen import gen_buffer, gen_text

#: the kernel wrappers whose launches a run counts
KERNELS = {"B1": encode_cuda, "B2": decode_cuda, "B3": decode_wave,
           "B4": encode_wave}
#: the wave leg's stream limit and pieces: (CPU, card)
WAVE_LIMIT = {"cpu": 8192, "cuda": 65536}
WAVE_PIECES = {"cpu": 8, "cuda": 64}


class Disagreement(AssertionError):
    """Two decoders, or a decoder and the original, disagree."""


class Oracle:
    """liblz4 and its CLI from an existing build (`find_oracle`)."""

    def __init__(self, cli: str, lib: str):
        self.cli = cli
        self.lib = ctypes.CDLL(lib)
        for name, args in (
                ("LZ4_compress_default", [ctypes.c_char_p, ctypes.c_char_p,
                                          ctypes.c_int, ctypes.c_int]),
                ("LZ4_compress_HC", [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int]),
                ("LZ4_decompress_safe", [ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_int, ctypes.c_int]),
                ("LZ4_decompress_safe_usingDict", [
                    ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_char_p, ctypes.c_int])):
            fn = getattr(self.lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args

    def compress(self, data: bytes, level: int) -> bytes:
        bound = len(data) + len(data) // 255 + 16
        dst = ctypes.create_string_buffer(bound)
        if level >= 2:
            n = self.lib.LZ4_compress_HC(data, dst, len(data), bound, level)
        else:
            n = self.lib.LZ4_compress_default(data, dst, len(data), bound)
        if n <= 0:
            raise RuntimeError("liblz4 compression failed")
        return dst.raw[:n]

    def decode(self, comp: bytes, cap: int, d: bytes | None):
        """The decoded bytes, or None where liblz4 rejects the stream."""
        dst = ctypes.create_string_buffer(max(cap, 1))
        if d:
            n = self.lib.LZ4_decompress_safe_usingDict(
                comp, dst, len(comp), cap, d, len(d))
        else:
            n = self.lib.LZ4_decompress_safe(comp, dst, len(comp), cap)
        return None if n < 0 else dst.raw[:n]

    def cli_decode(self, frame: bytes) -> bytes:
        return subprocess.run([self.cli, "-d", "-c"], input=frame,
                              capture_output=True, timeout=60).stdout


def find_oracle() -> Oracle | None:
    """liblz4 where a build of it already exists (`LZ4_REF_BUILD`, else
    `refbuild` in the temporary directory, as the JAX package's tests
    look for it); nothing is built."""
    build = os.environ.get("LZ4_REF_BUILD",
                           os.path.join(tempfile.gettempdir(), "refbuild"))
    cli, lib = os.path.join(build, "lz4"), os.path.join(build, "liblz4.so")
    if os.path.exists(cli) and os.path.exists(lib):
        return Oracle(cli, lib)
    return None


@dataclass
class Options:
    """What a run drives: `device` the card ("cuda") or the plain
    versions ("cpu"); `no_device` host C only; `kernels` B1/B2 in place of
    the sort/scan codec; `wave` the wave legs."""
    device: str = "cuda"
    no_device: bool = False
    kernels: bool = False
    wave: bool = False
    oracle: Oracle | None = None
    host: HostBackend = field(default_factory=HostBackend)
    backend: object = None

    def __post_init__(self):
        if not self.no_device:
            from lz4_tpu_torch.parallel.engine import TorchBackend
            self.device = resolve_device(self.device)
            self.backend = TorchBackend(self.device)

    @property
    def dev_leg(self) -> str:
        return "B2" if self.kernels else "sortscan"

    @property
    def on_card(self) -> bool:
        return not self.no_device and self.device.type == "cuda"


def rand_payload(r: random.Random) -> bytes:
    """The tool's payload draws (tools/torture.py:117-129)."""
    kind = r.randrange(4)
    size = r.choice([0, 1, 7, 13, 100, 4096, 65536, 70000, 200000])
    if kind == 0:
        return gen_buffer(size, match_prob=r.choice([0.0, 0.4, 0.9]),
                          seed=r.randrange(1 << 30))
    if kind == 1:
        return gen_text(size, seed=r.randrange(1 << 30))
    if kind == 2:
        return bytes([r.randrange(4)]) * size
    return random.Random(r.randrange(1 << 30)).randbytes(size)


def mutate(comp: bytes, r: random.Random) -> bytes:
    """1-3 bit flips, then a truncation in 3 of 10 (the tool's :285-290)."""
    m = bytearray(comp)
    for _ in range(r.randrange(1, 4)):
        m[r.randrange(len(m))] ^= 1 << r.randrange(8)
    if r.random() < 0.3:
        m = m[: r.randrange(1, len(m))]
    return bytes(m)


def host_decode(comp: bytes, cap: int, d: bytes | None, opts: Options):
    """Host C: the decoded bytes, or None where it rejects the stream."""
    try:
        return opts.host.decompress_batch([comp], [cap],
                                          dict_prefixes=[d])[0]
    except BlockDecodeError:
        return None


def _one_row(raw: bytes, d: bytes | None, cap: int, device):
    return to_device_batch(*pack_blocks([raw], [d], cap=cap,
                                        with_dict=bool(d)), device=device)


def device_encode(raw: bytes, d: bytes | None, opts: Options, *,
                  lite: bool = False, n_cand: int = 2,
                  lazy: bool = False) -> bytes:
    """B1 on one 64 KB row (`--kernels`; `lite` is acceleration 8, the
    tool's :83-93), else the sort/scan encoder."""
    if opts.kernels:
        out, cs, _ = encode_cuda.encode_blocks(
            *_one_row(raw, d, 65536, opts.device), cap_n=65536,
            acceleration=8 if lite else 1)
        return out[0, : int(cs[0])].cpu().numpy().tobytes()
    return encode_sortscan.encode_blocks_host(
        [raw], [d] if d else None, n_cand=n_cand, lazy=lazy, lite=lite,
        device=opts.device)[0]


def device_decode(comp: bytes, cap: int, d: bytes | None, opts: Options):
    """The device leg: B2 at the tool's capacity tier (`--kernels`,
    :95-109), else the sort/scan decoder; None where it rejects."""
    if not opts.kernels:
        try:
            return decode_sortscan.decode_blocks_host(
                [comp], [cap], [d] if d else None, device=opts.device)[0]
        except BlockDecodeError:
            return None
    tier = 65536
    while tier < cap:
        tier *= 4
    o, ol, er = decode_cuda.decode_blocks(
        *_one_row(comp, d, max(compress_bound(tier), len(comp)),
                  opts.device), cap_out=tier)
    if int(er[0]):
        return None
    out = o[0, : int(ol[0])].cpu().numpy().tobytes()
    return None if len(out) > cap else out


def wave_decode(comp: bytes, cap: int, opts: Options):
    """The C wave splitter, then B3; None where the splitter rejects."""
    from lz4_tpu_torch.native import blockcodec
    pieces = WAVE_PIECES[opts.device.type]
    r = blockcodec.wave_split(comp, max_pieces=pieces, out_cap=cap)
    if r is None:
        return None
    arena, ol = r
    arenas = np.zeros((1, pieces, decode_wave.WCAP), np.uint8)
    arenas[0, : arena.shape[0]] = arena
    return decode_wave.wave_decode_batch(arenas, [ol],
                                         device=opts.device)[0]


def _outcome(fn):
    try:
        return fn()
    except (FrameError, BlockDecodeError):
        return None


def run_cycle(cseed: int, opts: Options, counters: Counter) -> None:
    """One cycle of the tool's loop (tools/torture.py:227-343) from the
    cycle seed; raises `Disagreement`, naming the seed, where two legs
    disagree."""
    r = random.Random(cseed)

    def check(ok, what):
        if not ok:
            raise Disagreement(f"{what} (seed {cseed})")

    counters["cycles"] += 1
    raw = rand_payload(r)
    d = rand_payload(r)[: r.choice([0, 100, 65536])] or None
    level = r.choice([0, 1, 1, 2, 3, 9, 12])
    accel = r.choice([1, 1, 8])
    favor = r.random() < 0.2
    enc = "B1" if opts.kernels else "sortscan"

    # --- compress on a random path, decode every way --------------------
    path = r.randrange(3) if not opts.no_device else 2
    if len(raw) > 65536:
        # the device encoders take the 64 KB tier; bigger blocks go
        # through the engine's segmented path, which its tests cover
        path = 2
    if path == 0 and level < 2:
        comp = device_encode(raw, d, opts, lite=accel > 1)
        counters[f"encode.{enc}"] += 1
    elif path == 1 and level >= 2 and not opts.no_device:
        comp = device_encode(raw, d, opts, n_cand=8, lazy=True)
        counters[f"encode.{enc}"] += 1
    else:
        comp = opts.host.compress_batch(
            [raw], level=level, acceleration=accel, dict_prefixes=[d],
            favor_dec_speed=favor)[0]
        counters["encode.host"] += 1

    cap = len(raw)
    counters["decode.host"] += 1
    check(host_decode(comp, cap, d, opts) == raw, "host decode mismatch")
    oracle = opts.oracle
    if oracle:
        counters["decode.oracle"] += 1
        check(oracle.decode(comp, cap, d) == raw,
              "liblz4 rejects our stream")
        # and the mirror: liblz4's streams decode through ours
        if raw:
            rc = oracle.compress(raw, max(1, min(level, 12)))
            check(host_decode(rc, cap, None, opts) == raw,
                  "our decoder rejects a liblz4 stream")
    if not opts.no_device and r.random() < 0.3:
        counters[f"decode.{opts.dev_leg}"] += 1
        check(device_decode(comp, cap, d, opts) == raw,
              "device decode mismatch")
    wave_ok = opts.wave and not opts.no_device and d is None
    limit = WAVE_LIMIT[opts.device.type] if wave_ok else 0
    if wave_ok and 0 < len(raw) <= limit:
        counters["decode.wave"] += 1
        check(wave_decode(comp, len(raw), opts) == raw,
              "wave decode mismatch")
    if opts.wave and opts.on_card and r.random() < 0.1:
        _wave_linked_check(r, opts, check)
        counters["linked"] += 1
    if opts.wave and opts.on_card and r.random() < 0.08:
        _frames_batch_check(r, opts, check)
        counters["frames_batch"] += 1

    # --- differential decode of a MUTATED stream ------------------------
    if len(comp) > 4:
        m = mutate(comp, r)
        a = host_decode(m, cap, d, opts)
        counters["mutated.host"] += 1
        counters["mutated.host.rejects"] += a is None
        if oracle:
            b = oracle.decode(m, cap, d)
            counters["mutated.oracle"] += 1
            counters["mutated.oracle.rejects"] += b is None
            # sound-subset contract: we may reject MORE than liblz4 (its
            # safe decoder tolerates spec-invalid offset-0 sequences); we
            # never accept what it rejects, and when both accept the
            # bytes are identical
            check(not (a is not None and b is None),
                  "we accept what liblz4 rejects")
            check(a is None or b is None or a == b,
                  "mutated-decode divergence")
        if wave_ok and 0 < cap <= limit:
            w2 = wave_decode(m, cap, opts)
            counters["mutated.wave"] += 1
            counters["mutated.wave.rejects"] += w2 is None
            # the splitter holds the strict host contract
            check(not (w2 is not None and a is None),
                  "wave accepts what host rejects")
            check(w2 is None or a is None or w2 == a,
                  "wave/host divergence")
        if not opts.no_device and r.random() < 0.25:
            c2 = device_decode(m, cap, d, opts)
            counters[f"mutated.{opts.dev_leg}"] += 1
            counters[f"mutated.{opts.dev_leg}.rejects"] += c2 is None
            check((c2 is None) == (a is None) and (c2 is None or c2 == a),
                  "device/host decoder divergence")

    # --- frame torture ----------------------------------------------------
    if r.random() < 0.25:
        prefs = Preferences(frame_info=FrameInfo(
            block_size_id=r.choice([4, 5, 6, 7]),
            block_independent=r.random() < 0.5,
            block_checksum=r.random() < 0.5,
            content_checksum=r.random() < 0.8))
        blob = compress_frame(raw, level=min(level, 9), prefs=prefs,
                              backend=opts.host)
        counters["frames"] += 1
        check(decompress_frame(blob, backend=opts.host) == raw,
              "frame round trip failed")
        if not opts.no_device:
            check(decompress_frame(blob, backend=opts.backend) == raw,
                  "frame round trip on TorchBackend failed")
        mb = bytearray(blob)
        if len(mb) > 8:
            mb[r.randrange(4, len(mb))] ^= 0xFF
            mb = bytes(mb)
            # an undetected flip still decodes without crashing (the
            # tool's check); the two backends give one outcome
            h = _outcome(lambda: decompress_frame(mb, backend=opts.host))
            counters["frames.damaged"] += 1
            counters["frames.damaged.rejects"] += h is None
            if not opts.no_device:
                t = _outcome(lambda: decompress_frame(
                    mb, backend=opts.backend))
                check(t == h, "damaged frame: TorchBackend and "
                              "HostBackend disagree")


def _wave_linked_check(r: random.Random, opts: Options, check) -> None:
    """A random linked stream (exact 64 KB blocks and a short tail,
    capped or full-window offsets) through the ring tier against the
    input (the tool's :162-192)."""
    from lz4_tpu_torch.native import blockcodec as bc
    nblk = r.randrange(1, 4)
    tail = r.choice([0, 13, 5000])
    total = nblk * 65536 + tail
    raw = b"".join(rand_payload(r) for _ in range(6))
    reps = -(-total // max(1, len(raw)))
    raw = (raw * (reps + 1))[:total]
    raw = raw + bytes(total - len(raw))
    maxd = r.choice([0, 2000])
    blocks, hist = [], b""
    for off in range(0, len(raw), 65536):
        seg = raw[off: off + 65536]
        if maxd:
            blocks.append(bc.compress_maxd(seg, maxd,
                                           dict_prefix=hist or None))
        else:
            blocks.append(bc.compress(seg, dict_prefix=hist or None))
        hist = (hist + seg)[-65536:]
    outs = decode_wave.wave_decode_linked([blocks], device=opts.device)
    check(outs[0] == raw, "wave linked mismatch")


def _frames_batch_check(r: random.Random, opts: Options, check) -> None:
    """Random payloads through the batch frame surfaces (B4, then B3)
    and the sequential decoder (the tool's :194-215)."""
    from lz4_tpu_torch.frame.batch import (compress_frames_wave,
                                           decompress_frames_wave)
    datas = []
    for _ in range(r.randrange(2, 5)):
        raw = rand_payload(r)
        reps = r.choice([1, 1, 3])
        datas.append((raw * reps)[: r.randrange(1, 200000)] if raw else b"")
    indep = r.random() < 0.4
    frames = compress_frames_wave(datas, block_independent=indep,
                                  device=opts.device)
    check(decompress_frames_wave(frames, device=opts.device) == datas,
          "frames batch wave decode mismatch")
    check([decompress_frame(f, backend=opts.host) for f in frames] == datas,
          "frames batch sequential decode mismatch")
    if opts.oracle and r.random() < 0.3:
        i = r.randrange(len(frames))
        check(opts.oracle.cli_decode(frames[i]) == datas[i],
              "liblz4 rejects a batch frame")


def read_launches() -> dict:
    return {k: mod.launches for k, mod in KERNELS.items()}


def run(opts: Options, seconds: float, seed: int | None = None,
        counters: Counter | None = None) -> tuple[int, Counter]:
    """Cycles for `seconds` from the master seed (a random one when
    None); returns (master seed, counters). On a disagreement prints the
    cycle and its seed and re-raises."""
    seed0 = seed if seed is not None else random.randrange(1 << 30)
    rng = random.Random(seed0)
    counters = Counter() if counters is None else counters
    print(f"[torture] master seed {seed0}", flush=True)
    t_end = time.monotonic() + seconds
    while time.monotonic() < t_end:
        cseed = rng.randrange(1 << 30)
        try:
            run_cycle(cseed, opts, counters)
        except Disagreement:
            counters["disagreements"] += 1
            print(f"[torture] FAILED at cycle {counters['cycles']} seed "
                  f"{cseed} (master {seed0})", flush=True)
            raise
    return seed0, counters


def summary(counters: Counter) -> list[str]:
    """The per-leg counter lines."""
    c = counters

    def legs(prefix):
        return sorted({k.split(".")[1] for k in c if k.startswith(prefix)})

    lines = ["encode: " + ", ".join(f"{k} {c[f'encode.{k}']}"
                                    for k in legs("encode.")),
             "decode (valid): " + ", ".join(f"{k} {c[f'decode.{k}']}"
                                            for k in legs("decode.")),
             "mutated: " + ", ".join(
                 f"{k} {c[f'mutated.{k}']} (rejects "
                 f"{c[f'mutated.{k}.rejects']})" for k in legs("mutated.")),
             f"linked {c['linked']}, batch frames {c['frames_batch']}, "
             f"frames {c['frames']} (damaged {c['frames.damaged']}, "
             f"rejected {c['frames.damaged.rejects']})",
             f"disagreements {c['disagreements']}"]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=90.0)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the card, or the kernels' plain versions")
    ap.add_argument("--no-device", action="store_true",
                    help="host C (and liblz4) only")
    ap.add_argument("--kernels", action="store_true",
                    help="B1 and B2 in place of the sort/scan codec")
    ap.add_argument("--wave", action="store_true",
                    help="the wave splitter and B3, and on the card the "
                         "linked ring and the batch frames")
    args = ap.parse_args(argv)
    oracle = find_oracle()
    opts = Options(device=args.device, no_device=args.no_device,
                   kernels=args.kernels, wave=args.wave, oracle=oracle)
    before = read_launches()
    try:
        seed0, counters = run(opts, args.seconds, args.seed)
    except Disagreement as e:
        print(f"[torture] {e}", flush=True)
        return 1
    launches = {k: v - before[k] for k, v in read_launches().items()}
    print(f"[torture] survived {counters['cycles']} cycles in "
          f"{args.seconds:.0f}s (master seed {seed0}); oracle: "
          f"{'liblz4' if oracle else 'none'}", flush=True)
    for line in summary(counters):
        print(f"[torture] {line}", flush=True)
    print(f"[torture] launches {launches}", flush=True)
    print(json.dumps({"torture": {
        "master_seed": seed0, "seconds": args.seconds,
        "device": "none" if opts.no_device else str(opts.device),
        "oracle": bool(oracle), "counters": dict(counters),
        "launches": launches}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
