"""The run as a whole: it refuses to run without a card, and drives every
cell through the timed path to a correct result (on the CPU here, with
the program's plain versions, at a small size)."""
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import cells, run
from benchmark.tests.small import WORKLOADS, small_cell


def test_exits_without_a_card_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "lz4-64k.compress", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=cells.ROOT, capture_output=True, text=True,
        timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "no CUDA card" in r.stderr


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("traced", [False, True])
def test_a_small_run_is_correct(name, traced):
    out = io.StringIO()
    r = run.execute(small_cell(name), 2**31 + 99, 0.3, traced,
                    device="cpu", out=out)
    assert r["correct"] and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert all(v == {"value": 0, "limit": 0} for v in r["checks"].values())
    info = json.loads(out.getvalue().splitlines()[0][len("info "):])
    assert info["checked_blocks"] > 0
    assert r["attempted"] == info["calls"] * small_cell(name).mix[
        "batch_blocks"]
    if traced:
        assert "breakdown" in r and "window_s" in r["device"]
    else:
        assert set(r["metrics"]) == {m["name"]
                                     for m in cells.load_cell(name).end_to_end}
        for m in r["metrics"].values():
            assert m["value"] > 0


def test_the_run_needs_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails."""
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = ("from benchmark import run\n"
            "from benchmark.tests.small import small_cell\n"
            "run.execute(small_cell('lz4-64k.compress'), 1, 0.1, False, "
            "device='cpu')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert r.returncode != 0
    assert "lz4_tpu_torch" in r.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("name", WORKLOADS)
def test_a_short_run_on_the_card(card, name):
    r = run.execute(cells.load_cell(name), 2**31 + 5, 1.0, True,
                    device=card, out=io.StringIO())
    assert r["correct"]
    assert r["device"]["busy_s"] > 0
    assert r["device"]["platform"] == "gpu"
