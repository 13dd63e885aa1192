"""Data-parallel linked compression over a process group, the analog of
the reference CLI's `-T8` multithreaded mode (lz4io.c:1125-1368): each
rank encodes its contiguous shard of the blocks (`linked_encode_step`,
the sort/scan encoder), the history crosses from rank to rank, and every
rank gets the ordered sizes and offsets back.

Run under an initialized `torch.distributed` group (one GPU a rank, NCCL),
or alone: it then makes a one-process group itself (NCCL on the GPU,
gloo with `device="cpu"`) and closes it at the end.

    python -m lz4_tpu_torch.examples.sharded_batch
"""
import os
import tempfile

import numpy as np
import torch.distributed as dist

from lz4_tpu_torch.block.batch import DICT_CAP
from lz4_tpu_torch.parallel.engine import linked_encode_step, rank_device
from lz4_tpu_torch.utils.datagen import mixed_corpus


def encode(device=None):
    world = dist.get_world_size()
    cap = 16384
    B = 4 * world
    data = mixed_corpus(B * cap, seed=7)
    src = np.frombuffer(data, np.uint8).reshape(B, cap).copy()
    comp, csizes, offsets, total = linked_encode_step(
        src, np.full(B, cap, np.int32), np.zeros((1, DICT_CAP), np.uint8),
        np.zeros(1, np.int32), cap_n=cap, device=device)
    total = int(total.cpu()[0])
    if dist.get_rank() == 0:
        print(f"{world} devices: {B * cap} -> {total} bytes "
              f"({100 * total / (B * cap):.1f}%), "
              f"offsets {offsets.cpu().numpy()[:4]}...")


def main(device=None):
    if dist.is_initialized():
        encode(device)
        return
    backend = "nccl" if rank_device(0, device).type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tdir:
        store = dist.FileStore(os.path.join(tdir, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
        try:
            encode(device)
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
