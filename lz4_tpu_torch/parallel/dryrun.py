"""Entry points of the multi-GPU engine, and its multi-process demo (the
port's counterparts of `__graft_entry__.py` and `tools/multihost_demo.py`).

- `entry()`: the batched block-encode step (the sort/scan encoder) with
  example arguments, on one device.
- `dryrun_multichip(n)`: on every rank of an initialized process group
  of n ranks, one linked-mode data-parallel compression step
  (`linked_encode_step`: the shards' encodes, the history carried from
  rank to rank, the ordered assembly), the sharded linked decode, its
  error path, the sharded kernels behind `TorchBackend(codec=...)` and
  the sharded wave encode, each verified.
- `python -m lz4_tpu_torch.parallel.dryrun --spawn N [--device cpu]`:
  N processes, one rank each, joined by a file store: NCCL with one GPU
  a rank (cuda:rank % device_count, the default), or gloo on the CPU with
  `--device cpu`. Prints rank 0's line, which ends in "verified", and
  exits 0 when every rank did. `--cap` sets the block size (64 KB by
  default), `--out FILE` saves rank 0's results (.npz).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from lz4_tpu_torch.block.batch import DICT_CAP


def entry(device=None):
    """Returns (fn, example_args): the batched block-encode step (the
    sort/scan encoder, 4 blocks of 4 KB) with its arguments on `device`
    (the GPU when None)."""
    from lz4_tpu_torch.block.batch import to_device_batch
    from lz4_tpu_torch.block.encode_sortscan import encode_blocks
    from lz4_tpu_torch.utils.datagen import gen_buffer

    cap_n = 4096
    B = 4

    def fn(src, lens, dict_bufs, dict_lens):
        return encode_blocks(src, lens, dict_bufs, dict_lens, cap_n=cap_n,
                             has_dict=False)

    src = np.zeros((B, cap_n), np.uint8)
    for i in range(B):
        src[i] = np.frombuffer(gen_buffer(cap_n, match_prob=0.6, seed=i),
                               np.uint8)
    example_args = to_device_batch(
        src, np.full(B, cap_n, np.int32), np.zeros((B, DICT_CAP), np.uint8),
        np.zeros(B, np.int32), device=device)
    return fn, example_args


def dryrun_multichip(n_devices: int, *, cap_n: int = 65536,
                     per_rank: int = 0, device=None, group=None,
                     out: str | None = None) -> str:
    """One full multi-rank step on the initialized process group (of
    n_devices ranks), every rank passing the same batches of per_rank
    blocks a rank (0: one, or two on a single rank, so that the error
    path's corrupted block has a neighbour); returns the line that ends
    in "verified". Raises on any mismatch."""
    import torch.distributed as dist

    from lz4_tpu_torch.block.encode_wave import (emit_from_decisions,
                                                 pack_input)
    from lz4_tpu_torch.native import blockcodec
    from lz4_tpu_torch.parallel.engine import (ShardedCodec, TorchBackend,
                                               linked_encode_step,
                                               wave_encode_sharded)
    from lz4_tpu_torch.utils.datagen import gen_buffer

    world = dist.get_world_size(group)
    if world != n_devices:
        raise ValueError(f"need {n_devices} ranks, have {world}")
    codec = ShardedCodec(group, device)
    saved = {}

    # frame-tier shapes, per_rank blocks a rank
    B = n_devices * (per_rank or (2 if n_devices == 1 else 1))
    data = gen_buffer(B * cap_n, match_prob=0.7, seed=3)
    src = np.frombuffer(data, np.uint8).reshape(B, cap_n).copy()
    lens = np.full(B, cap_n, np.int32)
    head_dict = np.zeros((1, DICT_CAP), np.uint8)
    head_len = np.zeros(1, np.int32)

    # linked-mode data-parallel encode step: the shards' encodes, the
    # history carried from rank to rank, the ordered assembly
    comp, csizes, offsets, total = (t.cpu().numpy() for t in
                                    linked_encode_step(
                                        src, lens, head_dict, head_len,
                                        cap_n=cap_n, group=group,
                                        device=codec.device))
    total = int(total[0])
    if not ((np.diff(offsets) >= 0).all() and total == csizes.sum()):
        raise AssertionError("ordered assembly: offsets or total wrong")
    # each block decodes against the previous block's raw bytes
    for i in range(B):
        prefix = src[i - 1].tobytes() if i > 0 else None
        dec = blockcodec.decompress(comp[i, : csizes[i]].tobytes(), cap_n,
                                    dict_prefix=prefix)
        if dec != src[i].tobytes():
            raise AssertionError(f"linked block {i} round trip")
    saved.update(src=src, comp=comp, csizes=csizes, offsets=offsets,
                 total=np.int64(total))

    # sharded LINKED decode: each rank decodes its blocks against the
    # previous block's 64 KB history (the sort/scan decoder)
    cap_in = cap_n + cap_n // 255 + 32
    comp_in = np.zeros((B, cap_in), np.uint8)
    clens = np.zeros(B, np.int32)
    for i in range(B):
        comp_in[i, : csizes[i]] = comp[i, : csizes[i]]
        clens[i] = csizes[i]
    dbufs = np.zeros((B, DICT_CAP), np.uint8)
    dlens = np.zeros(B, np.int32)
    for i in range(1, B):
        h = src[i - 1][-DICT_CAP:]
        dbufs[i, DICT_CAP - len(h):] = h
        dlens[i] = len(h)
    dout, dlen, derr = (t.cpu().numpy() for t in codec.decode(
        comp_in, clens, dbufs, dlens, cap_out=cap_n, has_dict=True))
    if derr.any() or not (dlen == cap_n).all() or \
            dout.tobytes() != src.tobytes():
        raise AssertionError("sharded linked decode")

    # error path: a corrupted block raises its own flag only
    bad = comp_in.copy()
    bad[1, 4:10] = 0xFF
    bad_lens = clens.copy()
    bad_lens[1] = min(int(bad_lens[1]), 24)      # truncate mid-sequence
    errs_bad = codec.decode(bad, bad_lens, dbufs, dlens, cap_out=cap_n,
                            has_dict=True)[2].cpu().numpy()
    if not errs_bad[1] or errs_bad[0] or errs_bad[2:].any():
        raise AssertionError(f"error path flags {errs_bad.tolist()}")
    saved.update(dout=dout, dlen=dlen, derr=derr, errs_bad=errs_bad)

    # the sharded sort/scan encoder, round-tripped by the sharded decode
    eout, esize, _ = (t.cpu().numpy() for t in codec.encode(
        src, lens, None, None, cap_n=cap_n, has_dict=False, n_cand=2))
    e_in = np.zeros((B, cap_in), np.uint8)
    for i in range(B):
        e_in[i, : esize[i]] = eout[i, : esize[i]]
    rt = codec.decode(e_in, esize, None, None, cap_out=cap_n,
                      has_dict=False)[0].cpu().numpy()
    if rt.tobytes() != src.tobytes():
        raise AssertionError("sharded encode round trip")
    saved.update(eout=eout, esize=esize)

    # the kernels on each rank's shard behind TorchBackend(codec=...):
    # B1, then B2 with the wave tier off; bytes equal the single device's
    be = TorchBackend(codec=codec)
    single = TorchBackend(codec.device)
    pblocks = [gen_buffer(4096, match_prob=0.6, seed=100 + i)
               for i in range(B)]
    pcomp = be.compress_batch(pblocks, level=1)
    if pcomp != single.compress_batch(pblocks, level=1):
        raise AssertionError("sharded B1 differs from one device")
    be.wave_decode = False
    if be.decompress_batch(pcomp, [4096] * B) != pblocks:
        raise AssertionError("sharded B2 round trip")
    saved["pcomp_sizes"] = np.asarray([len(c) for c in pcomp])
    saved["pcomp"] = np.frombuffer(b"".join(pcomp), np.uint8)

    # the sharded wave encode: B4 on each rank's shard, the decisions
    # emitted on the host and round-tripped
    wblocks = [gen_buffer(4096, match_prob=0.7, seed=200 + i)
               for i in range(B)]
    winp, wlens = pack_input(wblocks, 1024)
    wdec = wave_encode_sharded(winp, wlens, max_dist=2048, hash_bits=9,
                               group=group, device=codec.device)
    wdec = wdec.cpu().numpy()
    for i, b in enumerate(wblocks):
        if blockcodec.decompress(emit_from_decisions(b, wdec[i]),
                                 len(b)) != b:
            raise AssertionError(f"wave shard {i} round trip")
    saved["wdec"] = wdec

    if out and dist.get_rank(group) == 0:
        np.savez(out, **saved)
    return (f"dryrun_multichip({n_devices}): linked encode {B}x{cap_n}B "
            f"-> {total}B, sharded linked decode + error path + sharded "
            "kernels + sharded wave encode verified")


def worker(rank: int, world: int, store: str, device: str, cap_n: int,
           out: str | None) -> None:
    """One rank of `spawn`: joins the group through the file store, runs
    `dryrun_multichip` and prints its line on rank 0."""
    import torch.distributed as dist
    dev = None if device == "cuda" else device
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        line = dryrun_multichip(world, cap_n=cap_n, device=dev, out=out)
        if rank == 0:
            print(line, flush=True)
    finally:
        dist.destroy_process_group()


def spawn(nprocs: int, *, device: str = "cuda", cap_n: int = 65536,
          out: str | None = None, timeout: float = 600) -> int:
    """Run `worker` in nprocs processes; print rank 0's line; 0 when
    every rank exited 0."""
    if device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device (use --device cpu for gloo)",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tdir:
        store = os.path.join(tdir, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "lz4_tpu_torch.parallel.dryrun",
             "--worker", str(r), "--world", str(nprocs), "--store", store,
             "--device", device, "--cap", str(cap_n)]
            + (["--out", out] if out else []),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(nprocs)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if any(p.returncode for p in procs):
        for r, (p, o) in enumerate(zip(procs, outs)):
            if p.returncode:
                print(f"rank {r} exited {p.returncode}:\n{o}",
                      file=sys.stderr)
        return 1
    line = outs[0].strip().splitlines()[-1] if outs[0].strip() else ""
    print(line)
    return 0 if line.endswith("verified") else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spawn", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cap", type=int, default=65536)
    ap.add_argument("--out")
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--worker", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--store")
    a = ap.parse_args(argv)
    if a.worker is not None:
        worker(a.worker, a.world, a.store, a.device, a.cap, a.out)
        return 0
    return spawn(a.spawn, device=a.device, cap_n=a.cap, out=a.out,
                 timeout=a.timeout)


if __name__ == "__main__":
    sys.exit(main())
