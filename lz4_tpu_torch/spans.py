"""Named spans inside the port, on `torch.profiler`'s clock.

`span(name)` returns `torch.profiler.record_function(name)` while a
profiler runs in the process, and one shared `contextlib.nullcontext()`
otherwise, so a span costs a flag test when nothing traces (an ungated
`record_function` costs 8-16 us even with no profiler running). There
is no switch of its own: run under `torch.profiler` to see the spans.
The profiler keeps them in memory beside the CUDA kernels and memcpys it
records, and writes them out with its trace. A span's parent is the
innermost span open on the same thread.

The compress path's spans (`lz4t.` names):

- `lz4t.compress_batch`: one `TorchBackend.compress_batch` call, its
  route choice included; the spans below sit inside it;
- `lz4t.pack`: `block.batch.pack_blocks`, padding the blocks into the
  batch arrays (page-locked ones on a GPU);
- `lz4t.h2d`: `block.batch.to_device_batch` where the batch moves, its
  checks and the moves to the device (enqueued without a wait from
  page-locked arrays); a batch already on its device opens none;
- `lz4t.launch`: `_build.launch`, the launch of any of B1-B6 (the plain
  version on the CPU);
- `lz4t.d2h`: the engine's copies of a batch's results to the host
  (`TorchBackend._fetch`, the decode routes' too), with the call's one
  wait for the kernel and the copies;
- `lz4t.to_bytes`: cutting each result row to its stream (`_cut`);
- `lz4t.build`: a kernel build at first use (`_build.load`, `module`).
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager that marks `name` in a running profiler's trace,
    and does nothing when no profiler runs."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
