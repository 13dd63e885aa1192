"""The per-layer quantities of a traced window, one function each. A
metric's reader (`metrics/<name>.py`) is one of these; the split by the
end-to-end metric a quantity moves (`.compress`, `.decompress`) lies in
which cells report it. Each returns None where the trace holds nothing
to read.
"""
from __future__ import annotations

from benchmark.trace import View, busy_us, covered, union


def host_ms(view: View) -> float | None:
    """The engine's host side: mean per call of the call's wall time
    less the part of it in which the device ran a kernel or a copy."""
    if not view.calls or not view.ops:
        return None
    dev = union(view.in_window())
    per = [(e - s) - covered(dev, s, e) for s, e in view.calls]
    return sum(per) / len(per) * 1e-3


def copy_ms(view: View) -> float | None:
    """Batch and copies: device time of the memcpys (host to device and
    back) per call."""
    a, b = view.window
    spans = view.in_window("memcpy")
    if not spans:
        return None
    total = sum(min(e, b) - max(s, a) for s, e in spans)
    return total / len(view.calls) * 1e-3


def kernel_roofline(view: View) -> float | None:
    """Kernels: the least time of the window's bytes (read once and
    written once at the card's peak bandwidth) over the device time of
    all its kernels, in percent."""
    a, b = view.window
    spans = view.in_window("kernel")
    if not spans or view.least_s is None:
        return None
    kernel_s = sum(min(e, b) - max(s, a) for s, e in spans) * 1e-6
    return view.least_s / kernel_s * 100.0


def device_idle(view: View) -> float | None:
    """Device: the share of the window in which no kernel and no copy
    ran, in percent."""
    if not view.ops:
        return None
    a, b = view.window
    return (1.0 - busy_us(view) / (b - a)) * 100.0
