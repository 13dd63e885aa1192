"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found by its name, so that an addition edits no file."""
import json
import os
import re
import shutil

import pytest

from benchmark import cells
from benchmark.tests.small import WORKLOADS

ROOT = cells.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_keys_are_the_contract_s():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_names_units_and_text():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [r for c in BENCH["configs"] for r in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = [c["source"] for c in BENCH["configs"]] + \
        [x["why"] for k in ("configs", "workloads") for x in BENCH[k]] + \
        [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    for p in BENCH["paths"] + [c["file"] for c in BENCH["configs"]]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_bounds_and_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 runs a cell of run_seconds + 60
    # seconds each, 2 x 90 s a cell to compile and 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@pytest.mark.parametrize("name", WORKLOADS)
def test_every_cell_finds_its_pieces(name):
    cell = cells.load_cell(name)
    assert cell.chips == 1
    entry = cell.entry_class()
    assert entry.kind in ("stream", "block") and entry.label
    report = cell.mix["report"]
    want = {"setup_s", report["rate"], report.get("tail"),
            report.get("ratio")}
    assert {m["name"] for m in cell.end_to_end} == want - {None}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))
        assert m["moves"] == report["rate"]
    assert os.path.isfile(os.path.join(
        ROOT, next(c["file"] for c in BENCH["configs"]
                   if c["name"] == cell.config["name"])))
    cfg = cell.config
    assert cfg["corpus_bytes"] == cfg["corpus_blocks"] * cfg["block_bytes"]
    assert cfg["corpus_blocks"] % cell.mix["batch_blocks"] == 0
    assert cfg["corpus_blocks"] % cell.corpus["stratum_blocks"] == 0


def test_a_per_layer_metric_lists_only_cells_that_report_what_it_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])


def test_an_addition_edits_no_file(tmp_path):
    """A new configuration, mix, entry and per-layer metric are new files
    and new entries in BENCHMARK.json: the copy's existing files stay as
    they were, and the new cell finds every piece."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(cells.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    (bench_dir / "configs" / "dummy-4k.json").write_text(json.dumps(
        dict(json.load(open(bench_dir / "configs" / "lz4-64k.json")),
             name="dummy-4k", block_bytes=4096)))
    (bench_dir / "mixes" / "dummy-mix.json").write_text(json.dumps(
        {"entry": "dummy_entry", "batch_blocks": 16, "checks_per_call": 1,
         "report": {"rate": "compress_MBs", "tail": "call_p95_ms"}}))
    (bench_dir / "entries" / "dummy_entry.py").write_text(
        "class Entry:\n    label = 'dummy'\n    kind = 'stream'\n"
        "\n")
    (bench_dir / "metrics" / "dummy_ms.compress.py").write_text(
        "def read(view):\n    return 1.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "dummy-4k", "source": "x",
                             "file": "benchmark/configs/dummy-4k.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy-4k.dummy-mix",
                               "config": "dummy-4k", "traffic": "dummy-mix",
                               "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("dummy-4k.dummy-mix")
    bench["per_layer"].append({"name": "dummy_ms.compress", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "dummy", "moves": "compress_MBs",
                               "workloads": ["dummy-4k.dummy-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load_cell("dummy-4k.dummy-mix", root=str(tmp_path),
                           bench_dir=str(bench_dir))
    assert cell.config["block_bytes"] == 4096
    assert cell.entry_class().label == "dummy"
    assert [m["name"] for m in cell.per_layer] == ["dummy_ms.compress"]
    assert cell.reader("dummy_ms.compress")(None) == 1.0
    assert "compress_MBs" in {m["name"] for m in cell.end_to_end}
    for name in WORKLOADS:
        old = cells.load_cell(name, root=str(tmp_path),
                              bench_dir=str(bench_dir))
        assert "dummy_ms.compress" not in {m["name"] for m in old.per_layer}
    after = {p: p.read_bytes() for p in before}
    assert after == before
