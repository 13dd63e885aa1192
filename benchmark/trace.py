"""Reduction of a traced window (`--trace 1`) to what the per-layer
readers, `device.busy_s` and the breakdown read.

The window runs under `torch.profiler` with CPU and CUDA activity. The
harness marks each call into the program with a `record_function` span
(`bench.call`); the device's operations are the trace's kernels,
memcpys and memsets. Times are the trace's microseconds. Spans inside
the program are not read here.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

CALL_SPAN = "bench.call"
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
               "gpu_memset": "memset"}


@dataclass
class View:
    """A traced window: `ops` the device operations (name, kind, start,
    end) and `calls` the call spans (start, end), in microseconds;
    `least_s` the cell's least time for the window's bytes at the card's
    peak (None where the card has no entry in the table of peaks)."""
    ops: list = field(default_factory=list)
    calls: list = field(default_factory=list)
    least_s: float | None = None

    @property
    def window(self) -> tuple[float, float]:
        return self.calls[0][0], self.calls[-1][1]

    def in_window(self, kind: str | None = None) -> list:
        a, b = self.window
        return [(s, e) for _, k, s, e in self.ops
                if (kind is None or k == kind) and e > a and s < b]


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(disjoint, a: float, b: float) -> float:
    """Length of [a, b] that the disjoint intervals cover."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in disjoint)


def busy_us(view: View) -> float:
    a, b = view.window
    return covered(union(view.in_window()), a, b)


def from_profile(prof, least_s: float | None) -> View:
    """The View of a finished `torch.profiler.profile`. The trace is
    exported to a temporary file, read and deleted."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return from_events(events, least_s)


def from_events(events, least_s: float | None) -> View:
    ops, calls = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append((ev["name"], DEVICE_CATS[cat], s, e))
        elif cat == "user_annotation" and ev.get("name") == CALL_SPAN:
            calls.append((s, e))
    return View(ops=sorted(ops, key=lambda o: o[2]), calls=sorted(calls),
                least_s=least_s)


def breakdown(view: View, label: str, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and
    the longest idle gaps of the device, each named by what the host was
    in at the gap's middle: `label` (a call into the program) or
    "between calls". Seconds."""
    a, b = view.window
    by_name: dict[str, float] = {}
    for name, _, s, e in view.ops:
        d = max(0.0, min(e, b) - max(s, a))
        if d > 0:
            by_name[name] = by_name.get(name, 0.0) + d * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, t = [], a
    for s, e in union(view.in_window()) + [(b, b)]:
        if s > t:
            gaps.append((t, min(s, b)))
        t = max(t, e)
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        inside = any(cs <= mid <= ce for cs, ce in view.calls)
        named.append([label if inside else "between calls", (e - s) * 1e-6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
