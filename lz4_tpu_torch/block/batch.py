"""Batch arrays of the block codec: the state that crosses from the host
to the device and back.

The codec has no weights. What it carries is the batch itself (blocks
padded into one `uint8[B, cap]` array with their lengths) and, in
dict/linked mode, each block's 64 KB history, right-aligned in a
`uint8[B, 65536]` array with its valid length. These are exactly the
numpy arrays the JAX package's wrappers take, so one test can hand the
same arrays to both packages.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

#: dict/linked history window (the LZ4 format's 64 KB)
DICT_CAP = 65536


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller
    names another. Raises where no GPU is present and none was named:
    the port never drops to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "lz4_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def pack_blocks(blocks: Sequence[bytes],
                dict_prefixes: Sequence[bytes | None] | None = None, *,
                cap: int, with_dict: bool = False):
    """Pad `blocks` into the batch arrays (lz4_tpu engine.py:461-474).

    Returns numpy `(src uint8[B, cap], lens int32[B], dict_bufs,
    dict_lens)` for B = len(blocks). The dict arrays are None unless
    `with_dict`; then `dict_bufs uint8[B, 65536]` holds the last 64 KB of
    each prefix right-aligned and `dict_lens int32[B]` its length (0 where
    the prefix is None or empty).
    """
    rows = len(blocks)
    src = np.zeros((rows, cap), np.uint8)
    lens = np.zeros(rows, np.int32)
    for i, blk in enumerate(blocks):
        if len(blk) > cap:
            raise ValueError(f"block {i} holds {len(blk)} bytes > cap {cap}")
        src[i, : len(blk)] = np.frombuffer(blk, np.uint8)
        lens[i] = len(blk)
    if not with_dict:
        return src, lens, None, None
    dict_bufs = np.zeros((rows, DICT_CAP), np.uint8)
    dict_lens = np.zeros(rows, np.int32)
    for i, d in enumerate(dict_prefixes or ()):
        if d:
            d = bytes(d)[-DICT_CAP:]
            dict_bufs[i, DICT_CAP - len(d):] = np.frombuffer(d, np.uint8)
            dict_lens[i] = len(d)
    return src, lens, dict_bufs, dict_lens


def _tensor(a, dtype: torch.dtype, ndim: int, name: str,
            device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, not {device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        t = a
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: expected a {ndim}-d {dtype} array, got "
                        f"{t.dim()}-d {t.dtype}")
    return t.to(device)


def to_device_batch(src, lens, dict_bufs=None, dict_lens=None, *,
                    device=None):
    """Move the batch arrays to `device` (the GPU when None).

    Takes what the JAX wrappers take: `src uint8[B, cap]`, `lens
    int32[B]`, and optionally `dict_bufs uint8[B, 65536]` (right-aligned
    history) with `dict_lens int32[B]`, as numpy arrays or as contiguous
    tensors already on `device`. Returns the same four as tensors on the
    device (the dict pair stays None when not given). Raises on a wrong
    type, shape, device or layout.
    """
    device = resolve_device(device)
    src_t = _tensor(src, torch.uint8, 2, "src", device)
    lens_t = _tensor(lens, torch.int32, 1, "lens", device)
    if lens_t.shape[0] != src_t.shape[0]:
        raise ValueError("lens must hold one length per row of src")
    if (dict_bufs is None) != (dict_lens is None):
        raise ValueError("dict_bufs and dict_lens go together")
    if dict_bufs is None:
        return src_t, lens_t, None, None
    db_t = _tensor(dict_bufs, torch.uint8, 2, "dict_bufs", device)
    dl_t = _tensor(dict_lens, torch.int32, 1, "dict_lens", device)
    if tuple(db_t.shape) != (src_t.shape[0], DICT_CAP) or \
            dl_t.shape[0] != src_t.shape[0]:
        raise ValueError("dict_bufs must be uint8[B, 65536] with "
                         "dict_lens int32[B]")
    return src_t, lens_t, db_t, dl_t
