"""The program's own spans in a traced window: the host time of each step
of a call, and the device's idle gaps named by the step the host was in.

The program marks its steps with `lz4t.` spans (`lz4_tpu_torch/spans.py`)
while `torch.profiler` runs. The harness's `View` (`trace.py`) keeps the
device's operations and the `bench.call` spans only, and a per-layer
reader is given the View alone, so the steps are read here, from the same
trace events:

    python -m benchmark.program_spans --workload <name> --seed <n>
                                      --seconds <s>

runs the cell's traced window as `python -m benchmark.run ... --trace 1`
does (`run.execute`, unchanged), keeps the events that `trace.from_events`
reads, and prints the run's `info` lines and one JSON line: the result,
each step's host time a call, their sum against `host_ms`, the longest
idle gaps named by step, and the kernel builds the process ran. It exits
2 without a CUDA card.

A span's self time is its length less its child spans; its host time is
its self time less the part in which the device ran a kernel or a copy,
`host_ms`'s own rule. The self times of `bench.call`, the program's
spans and their children part each call, so the host times of every
span add up to `host_ms`. Times in the events are microseconds.
"""
from __future__ import annotations

import argparse
import bisect
import io
import json
import sys
from unittest import mock

from benchmark import layers, run, trace
from benchmark.cells import load_cell
from benchmark.trace import union

PREFIX = "lz4t."
#: the host steps of a `compress_batch` call, in the order they run
STEPS = ("lz4t.pack", "lz4t.h2d", "lz4t.launch", "lz4t.d2h",
         "lz4t.to_bytes")


def spans_of(events) -> list[tuple[str, float, float]]:
    """The `(name, start, end)` of each program span (a complete
    `user_annotation` event named `lz4t.*`), parents before children."""
    out = []
    for ev in events:
        name = ev.get("name", "")
        if (ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
                and name.startswith(PREFIX)):
            s = float(ev["ts"])
            out.append((name, s, s + float(ev.get("dur", 0.0))))
    return sorted(out, key=lambda x: (x[1], -x[2]))


def with_calls(view: trace.View, spans) -> list[tuple[str, float, float]]:
    """The program's spans inside the window, with the harness's call
    spans as their parents, in the order of `spans_of`."""
    a, b = view.window
    inside = [x for x in spans if a <= x[1] and x[2] <= b]
    calls = [(trace.CALL_SPAN, s, e) for s, e in view.calls]
    return sorted(inside + calls, key=lambda x: (x[1], -x[2]))


def self_intervals(spans, i: int) -> list[tuple[float, float]]:
    """The parts of span `i` that no child span covers; `spans` in the
    order of `spans_of`, nested as one thread's spans are."""
    _, s, e = spans[i]
    kids = []
    for j in range(i + 1, len(spans)):
        if spans[j][1] >= e:
            break
        if spans[j][2] <= e:
            kids.append(spans[j][1:])
    out, t = [], s
    for a, b in union(kids):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if e > t:
        out.append((t, e))
    return out


def _covered(dev, ends, a: float, b: float) -> float:
    """`trace.covered(dev, a, b)`, starting at the first of the sorted
    disjoint intervals `dev` (their ends `ends`) that ends after a."""
    total, i = 0.0, bisect.bisect_right(ends, a)
    while i < len(dev) and dev[i][0] < b:
        s, e = dev[i]
        total += min(e, b) - max(s, a)
        i += 1
    return total


def host_ms_by_span(view: trace.View, spans) -> dict[str, float]:
    """Mean per call of each span name's host time (ms), `bench.call`'s
    own (the harness's part of a call) included; a name the window does
    not hold is absent, and the whole is empty where it has no call."""
    if not view.calls:
        return {}
    dev = union(view.in_window())
    ends = [e for _, e in dev]
    every = with_calls(view, spans)
    total: dict[str, float] = {}
    for i, (name, _, _) in enumerate(every):
        host = sum((b - a) - _covered(dev, ends, a, b)
                   for a, b in self_intervals(every, i))
        total[name] = total.get(name, 0.0) + host
    return {n: v / len(view.calls) * 1e-3 for n, v in total.items()}


def innermost(spans, t: float) -> str | None:
    """The name of the innermost span open at `t`, or None."""
    best = None
    for name, s, e in spans:
        if s > t:
            break
        if e >= t:
            best = name
    return best


def named_gaps(view: trace.View, spans, label: str,
               top: int = 10) -> list:
    """`trace.breakdown`'s idle gaps, each inside a call named
    `<label>/<innermost span>` where a program span covers its middle;
    every other gap keeps the breakdown's name."""
    a, b = view.window
    gaps, t = [], a
    for s, e in union(view.in_window()) + [(b, b)]:
        if s > t:
            gaps.append((t, min(s, b)))
        t = max(t, e)
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        if any(cs <= mid <= ce for cs, ce in view.calls):
            step = innermost(spans, mid)
            name = label if step is None else f"{label}/{step}"
        else:
            name = "between calls"
        named.append([name, (e - s) * 1e-6])
    return named


def report(view: trace.View, spans, label: str) -> dict:
    """The steps of a traced window: the mean call (ms), host time a call
    by span, the five steps' sum and its share of `host_ms`, span counts
    a call, and the named idle gaps."""
    by_span = host_ms_by_span(view, spans)
    steps = {n: by_span[n] for n in STEPS if n in by_span}
    host = layers.host_ms(view)
    total = sum(steps.values())
    counts: dict[str, int] = {}
    for name, _, _ in with_calls(view, spans):
        counts[name] = counts.get(name, 0) + 1
    call_ms = sum(e - s for s, e in view.calls) / len(view.calls) * 1e-3
    return {"call_ms": call_ms, "steps_ms": steps,
            "other_ms": {n: v for n, v in by_span.items() if n not in steps},
            "steps_sum_ms": total, "host_ms": host,
            "steps_share": total / host if host else None,
            "per_call": {n: c / max(1, len(view.calls))
                         for n, c in counts.items()},
            "idle_gaps": named_gaps(view, spans, label)}


def traced_run(cell, seed: int, seconds: float, *, device="cuda",
               out=sys.stdout) -> dict:
    """One traced run of `cell` through `run.execute`, with the program's
    spans read from the same events."""
    kept = []
    from_events = trace.from_events

    def keep(events, least_s):
        kept.append(events)
        return from_events(events, least_s)

    with mock.patch.object(trace, "from_events", keep):
        result = run.execute(cell, seed, seconds, True, device=device,
                             out=out)
    view = from_events(kept[-1], None)
    from lz4_tpu_torch import _build
    return {"workload": cell.name, "seed": seed, "result": result,
            **report(view, spans_of(kept[-1]), cell.entry_class().label),
            "builds": getattr(_build, "built", None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.program_spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("benchmark: no CUDA card is available; the benchmark runs "
              "on the card only", file=sys.stderr)
        return 2
    info = io.StringIO()
    rep = traced_run(cell, args.seed, args.seconds, out=info)
    sys.stdout.write(info.getvalue())
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
