"""The benchmark of `lz4_tpu_torch`: one run of one cell.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s>
                            --trace <0|1>

from the root of a checkout. The run loads the cell's configuration and
traffic mix by name (`benchmark/cells.py`), makes the corpus from
`--seed` on the card, builds the entry's inputs, warms up one call of
the cell's shape (and times a second where the entry reserves room
for its sample), and then calls the entry in a closed loop with one
caller for `--seconds` seconds: each call waits for the one before, and
the calls cycle through the corpus a batch at a time. The window opens
at the first timed call and closes when the last call that started
inside `--seconds` returns. After it, the sampled answers are held to
the benchmark's reference (`benchmark/check.py`).

The last line of standard output is one JSON object: `correct`,
`attempted` and `failed` (blocks), `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics), `device`, with
`--trace 1` `breakdown`, and last `checks`, each compared number beside
its limit. Earlier lines (`info ...`) carry the counts, the program's
route and launch counters, the window's page faults, context switches
and CPU seconds (`getrusage`), and the card's power limit. The compared
numbers are also the last lines of standard error.

Without a CUDA card, or with fewer than the cell asks for, the run
exits with code 2 and prints no result; it never falls back to the CPU.
It exits with code 3, and prints no result, where JAX or the JAX
package has been loaded into the process.
"""
from __future__ import annotations

import os
import time


def process_age() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE_AT_IMPORT = process_age()
_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

_T_TORCH = time.perf_counter()

from benchmark import check, corpus, roofline, trace  # noqa: E402
from benchmark.cells import Cell, load_cell  # noqa: E402

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "lz4_tpu")


@dataclass
class Run:
    """What an entry is given: the cell, the corpus (`data` on the run's
    device, `host` a numpy copy), its batches and the device."""
    cell: Cell
    seed: int
    device: torch.device
    data: torch.Tensor | None
    host: np.ndarray
    batch_blocks: int
    n_batches: int

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def block_bytes(self) -> int:
        return self.cell.config["block_bytes"]

    def rows(self, k: int) -> slice:
        return slice(k * self.batch_blocks, (k + 1) * self.batch_blocks)


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def p95(values) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def card_limits() -> str | None:
    """nvidia-smi's name and power limit of the card, or None."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() or None


def host_usage() -> dict:
    """This process's page faults, context switches and CPU seconds."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"minflt": r.ru_minflt, "majflt": r.ru_majflt,
            "nvcsw": r.ru_nvcsw, "nivcsw": r.ru_nivcsw,
            "utime_s": r.ru_utime, "stime_s": r.ru_stime}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    """What the timed loop saw: each call's latency (ms), uncompressed
    and compressed bytes, the kept answers, and the failures."""
    lat: list
    unc: list
    comp: list
    kept: list
    raised: int
    missing: int
    errors: list
    seconds: float
    setup_s: float
    prof: object
    usage: dict


def _window(entry, picks, n_batches: int, bs: int, seconds: float,
            traced: bool, cuda: bool) -> Window:
    """Calls `entry` in a closed loop, batch after batch, until the last
    call that started inside `seconds` returns. With `traced`, under
    `torch.profiler`, each call inside a `bench.call` span."""
    w = Window([], [], [], [], 0, 0, [], 0.0, 0.0, None, {})
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        w.prof = torch.profiler.profile(activities=acts, acc_events=True)
        w.prof.__enter__()
    span = (lambda: torch.profiler.record_function(trace.CALL_SPAN)) \
        if traced else contextlib.nullcontext
    limit_ns = int(seconds * 1e9)
    t_first = None
    i = 0
    while t_first is None or time.perf_counter_ns() - t_first < limit_ns:
        k = i % n_batches
        t_a = time.perf_counter_ns()
        if t_first is None:
            t_first = t_a
            w.setup_s = _AGE_AT_IMPORT + (t_a * 1e-9 - _T_IMPORT)
            w.usage = host_usage()
        try:
            with span():
                res = entry.call(k)
        except Exception as e:      # a failed call is counted, not fatal
            res = None
            w.raised += 1
            if len(w.errors) < 3:
                w.errors.append(f"call {i}: {type(e).__name__}: {e}")
        t_b = time.perf_counter_ns()
        w.lat.append((t_b - t_a) * 1e-6)
        if res is None:
            w.missing += bs
        else:
            returned, u, c = entry.tally(k, res)
            w.missing += max(0, bs - returned)
            w.unc.append(u)
            w.comp.append(c)
            w.kept.extend(entry.keep(k, res, picks(i)))
        del res
        i += 1
    w.seconds = (t_b - t_first) * 1e-9
    end = host_usage()
    w.usage = {k: end[k] - v for k, v in w.usage.items()}
    return w


def execute(cell: Cell, seed: int, seconds: float, traced: bool, *,
            device="cuda", out=sys.stdout) -> dict:
    """One run of `cell`; returns the result object (printing `info`
    lines to `out`)."""
    marks = [("python", _T_IMPORT), ("import_torch", _T_TORCH)]
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.init()
        torch.empty(1, device=device)
    marks.append(("device_init", time.perf_counter()))
    mix = cell.mix
    n_blocks = cell.config["corpus_blocks"]
    bs = mix["batch_blocks"]
    if n_blocks % bs:
        raise ValueError(f"{n_blocks} blocks are not whole batches of {bs}")
    data, _ = corpus.make_corpus(cell.corpus, seed, n_blocks,
                                 cell.config["block_bytes"], device)
    host = data.cpu().numpy()
    marks.append(("corpus", time.perf_counter()))
    run = Run(cell=cell, seed=seed, device=device, data=data, host=host,
              batch_blocks=bs, n_batches=n_blocks // bs)
    entry = cell.entry_class()(run)
    marks.append(("entry", time.perf_counter()))
    run.data = None
    del data
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    entry.call(0)                               # warm-up: the cell's shape
    _sync(device)
    if hasattr(entry, "reserve"):   # room for the sample, from a warm call
        t_w = time.perf_counter()
        entry.call(1 % run.n_batches)
        _sync(device)
        entry.reserve(int(seconds / (time.perf_counter() - t_w) * 1.5) + 8)
    marks.append(("warm_up", time.perf_counter()))
    gc.collect()

    picks = check.Picks(seed, mix["checks_per_call"], bs)
    w = _window(entry, picks, run.n_batches, bs, seconds, traced, cuda)
    _sync(device)
    if w.prof is not None:
        w.prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kept = entry.finish(w.kept)
    counters = entry.counters()
    kind, label = entry.kind, entry.label
    del entry
    gc.collect()

    unc_total = int(sum(w.unc))
    comp_total = int(sum(int(c.sum()) if isinstance(c, torch.Tensor) else c
                         for c in w.comp))
    dev_kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    view = None
    if w.prof is not None:
        view = trace.from_profile(w.prof, roofline.least_seconds(
            roofline.call_bytes(unc_total, comp_total), dev_kind))

    def source(k, j):
        return host[k * bs + j].tobytes()

    t_c = time.perf_counter()
    bad, notes = check.verify(kind, kept, source)
    nums = check.numbers(bad, w.missing, w.raised)
    check_s = time.perf_counter() - t_c

    names = mix["report"]
    e2e = {"setup_s": w.setup_s, names["rate"]: unc_total / w.seconds / 1e6}
    if "tail" in names:
        e2e[names["tail"]] = p95(w.lat)
    if "ratio" in names and comp_total:
        e2e[names["ratio"]] = unc_total / comp_total
    metrics = {}
    if traced:
        for m in cell.per_layer:
            v = cell.reader(m["name"])(view) if view is not None else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e:            # no ratio where nothing came
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": dev_kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    if view is not None:
        a, b = view.window
        dev["busy_s"] = trace.busy_us(view) * 1e-6
        dev["window_s"] = (b - a) * 1e-6

    info = {"workload": cell.name, "seed": seed, "calls": len(w.lat),
            "window_s": w.seconds, "call_p50_ms": float(np.median(w.lat)),
            "call_p95_ms": p95(w.lat),
            "uncompressed_bytes": unc_total, "compressed_bytes": comp_total,
            "checked_blocks": len(kept), "check_s": check_s,
            "window_host": w.usage,
            "counters": counters,
            "setup_steps_s": {"before_import": _AGE_AT_IMPORT, **{
                name: t - marks[n][1]
                for n, (name, t) in enumerate(marks[1:])}},
            "card": card_limits() if cuda else None}
    print("info " + json.dumps(info), file=out)
    for line in w.errors + notes:
        print("info fault " + line, file=out)
    result = {"correct": check.passed(nums),
              "attempted": len(w.lat) * bs,
              "failed": w.missing + bad,
              "metrics": metrics, "device": dev}
    if view is not None:
        result["breakdown"] = trace.breakdown(view, label)
    result["checks"] = nums
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA card is available; the benchmark runs "
              "on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA cards, "
              f"{torch.cuda.device_count()} are present", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; nothing it "
              "runs may import JAX or the JAX package", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
