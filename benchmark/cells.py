"""Finds the pieces of a cell by name, so that a new configuration,
traffic mix, entry or per-layer metric is a new file and an entry in
`BENCHMARK.json`, and no file here changes:

- `BENCHMARK.json` at the checkout's root: the cells and metrics;
- `benchmark/configs/<config>.json`: a configuration;
- `benchmark/corpora/<corpus>.json`: the data a configuration names;
- `benchmark/mixes/<traffic>.json`: a traffic mix, which names its entry;
- `benchmark/entries/<entry>.py`: the code that drives one entry of the
  program (a class `Entry`);
- `benchmark/metrics/<metric>.py`: the reader of one per-layer metric
  (a function `read(view)`).
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    if not os.path.exists(path):
        raise FileNotFoundError(f"benchmark: no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell of `BENCHMARK.json` with everything its name leads to."""
    name: str
    chips: int
    config: dict
    mix: dict
    corpus: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    bench_dir: str = BENCH_DIR

    def entry_class(self):
        path = os.path.join(self.bench_dir, "entries",
                            f"{self.mix['entry']}.py")
        return _module(path, f"benchmark_entry_{self.mix['entry']}").Entry

    def reader(self, metric: str):
        path = os.path.join(self.bench_dir, "metrics", f"{metric}.py")
        return _module(path, f"benchmark_metric_{metric}").read


def _applies(metric: dict, cell: str) -> bool:
    """Whether `metric` is reported in `cell`: every cell, or those its
    `workloads` list."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT,
              bench_dir: str = BENCH_DIR) -> Cell:
    """The cell `name` of `BENCHMARK.json` at `root`."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"benchmark: no workload {name!r}; the cells are "
                       f"{sorted(cells)}")
    return cell_of(cells[name], bench, bench_dir)


def cell_of(w: dict, bench: dict, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell of workload entry `w` (name, config, traffic, chips), with
    the metrics that `bench` gives it."""
    name = w["name"]
    config = _json(os.path.join(bench_dir, "configs", f"{w['config']}.json"))
    mix = _json(os.path.join(bench_dir, "mixes", f"{w['traffic']}.json"))
    corpus = _json(os.path.join(bench_dir, "corpora",
                                f"{config['corpus']}.json"))
    return Cell(
        name=name, chips=w["chips"], config=config, mix=mix, corpus=corpus,
        end_to_end=[m for m in bench["end_to_end"]
                    if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"]
                   if _applies(m, name)],
        bench_dir=bench_dir)
