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

from lz4_tpu_torch.spans import span

#: dict/linked history window (the LZ4 format's 64 KB)
DICT_CAP = 65536
_NUMPY = {torch.uint8: np.uint8, torch.int32: np.int32}


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


def bucket_cap(n: int) -> int:
    """The capacity buckets of the JAX package's bytes facades
    (`encode_blocks_host`, `decode_blocks_host`): 256 doubled up to n."""
    cap = 256
    while cap < n:
        cap *= 2
    return cap


def pack_blocks(blocks: Sequence[bytes],
                dict_prefixes: Sequence[bytes | None] | None = None, *,
                cap: int, with_dict: bool = False, pinned: bool = False):
    """Pad `blocks` into the batch arrays (lz4_tpu engine.py:461-474).

    Returns numpy `(src uint8[B, cap], lens int32[B], dict_bufs,
    dict_lens)` for B = len(blocks). The dict arrays are None unless
    `with_dict`; then `dict_bufs uint8[B, 65536]` holds the last 64 KB of
    each prefix right-aligned and `dict_lens int32[B]` its length (0 where
    the prefix is None or empty). With `pinned` the four are page-locked
    CPU tensors from torch's caching host allocator, holding the same
    bytes, which `to_device_batch` copies to the GPU without a wait.
    """
    with span("lz4t.pack"):
        rows = len(blocks)
        shapes = [((rows, cap), torch.uint8), ((rows,), torch.int32)]
        if with_dict:
            shapes += [((rows, DICT_CAP), torch.uint8), ((rows,), torch.int32)]
        if pinned:
            arrays = [torch.empty(shape, dtype=dt, pin_memory=True)
                      for shape, dt in shapes]
            views = [a.numpy() for a in arrays]
        else:
            arrays = views = [np.empty(shape, _NUMPY[dt])
                              for shape, dt in shapes]
        pack_into(blocks, dict_prefixes, *views)
        return tuple(arrays) if with_dict else (*arrays, None, None)


def pack_into(blocks: Sequence[bytes],
              dict_prefixes: Sequence[bytes | None] | None, src: np.ndarray,
              lens: np.ndarray, dict_bufs: np.ndarray | None = None,
              dict_lens: np.ndarray | None = None) -> None:
    """Write the batch into arrays of `pack_blocks`' shapes whatever they
    held before: every byte of every row is written, the pad past a
    block (and before a right-aligned prefix) with zeros, so the rows
    equal `pack_blocks`' byte for byte."""
    cap = src.shape[1]
    for i, blk in enumerate(blocks):
        n = len(blk)
        if n > cap:
            raise ValueError(f"block {i} holds {n} bytes > cap {cap}")
        src[i, :n] = np.frombuffer(blk, np.uint8)
        src[i, n:] = 0
        lens[i] = n
    if dict_bufs is None:
        return
    dict_lens[:] = 0
    prefixes = list(dict_prefixes or ())
    for i in range(len(blocks)):
        d = prefixes[i] if i < len(prefixes) else None
        d = bytes(d)[-DICT_CAP:] if d else b""
        dict_bufs[i, : DICT_CAP - len(d)] = 0
        if d:
            dict_bufs[i, DICT_CAP - len(d):] = np.frombuffer(d, np.uint8)
            dict_lens[i] = len(d)


def _tensor(a, dtype: torch.dtype, ndim: int, name: str,
            device: torch.device) -> torch.Tensor:
    staged = False
    if isinstance(a, torch.Tensor):
        staged = (a.device.type == "cpu" and device.type == "cuda"
                  and a.is_pinned())
        if a.device != device and not staged:
            raise ValueError(f"{name} is on {a.device}, not {device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        t = a
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: expected a {ndim}-d {dtype} array, got "
                        f"{t.dim()}-d {t.dtype}")
    return t.to(device, non_blocking=staged)


def to_device_batch(src, lens, dict_bufs=None, dict_lens=None, *,
                    device=None):
    """Move the batch arrays to `device` (the GPU when None).

    Takes what the JAX wrappers take: `src uint8[B, cap]`, `lens
    int32[B]`, and optionally `dict_bufs uint8[B, 65536]` (right-aligned
    history) with `dict_lens int32[B]`, as numpy arrays or as contiguous
    tensors already on `device`; page-locked CPU tensors (`pack_blocks`
    with `pinned`) go to a GPU on its current stream without a wait.
    Returns the same four as tensors on the device (the dict pair stays
    None when not given). Raises on a wrong type, shape, device or
    layout. Only a batch that moves opens the `lz4t.h2d` span: one
    already on `device` is checked and returned as it is.
    """
    device = resolve_device(device)
    arrays = (src, lens, dict_bufs, dict_lens)
    if all(a is None or isinstance(a, torch.Tensor) and a.device == device
           for a in arrays):
        return _checked_batch(*arrays, device)
    with span("lz4t.h2d"):
        return _checked_batch(*arrays, device)


def _checked_batch(src, lens, dict_bufs, dict_lens, device):
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


def result_rows(rows: int, width: int, device) -> tuple:
    """A batch kernel's outputs on `device`, not initialised: uint8[rows,
    width] and two int32[rows] (B1's and B5's out, csizes, trailing; B2's
    out, olen, err)."""
    return (torch.empty((rows, width), dtype=torch.uint8, device=device),
            torch.empty(rows, dtype=torch.int32, device=device),
            torch.empty(rows, dtype=torch.int32, device=device))
