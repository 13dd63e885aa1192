"""Nothing the benchmark runs imports JAX or the JAX package (`lz4_tpu`),
compared by whole top-level module names: the program, `lz4_tpu_torch`,
is allowed, and its name begins with the JAX package's. The reference
and the comparison import nothing of the program."""
import ast
import pathlib
import subprocess
import sys

import pytest

from benchmark import cells, run

BENCH = pathlib.Path(cells.BENCH_DIR)
FORBIDDEN = {"jax", "jaxlib", "flax", "lz4_tpu"}


def imported(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.JoinedStr | ast.Constant):
            arg = node.args[0]
            text = arg.value if isinstance(arg, ast.Constant) else \
                "".join(v.value for v in arg.values
                        if isinstance(v, ast.Constant))
            out.add(text.split(".")[0])
    return out


def harness_files():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def test_whole_name_rule():
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "lz4_tpu")
    saved = dict(sys.modules)
    try:
        sys.modules["lz4_tpu_torch.fake"] = object()
        assert run.forbidden_modules() == []
        sys.modules["lz4_tpu.fake"] = object()
        assert run.forbidden_modules() == ["lz4_tpu.fake"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


@pytest.mark.parametrize("path", harness_files(), ids=lambda p: p.name)
def test_no_harness_file_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "check.py", "corpus.py",
                                  "frozen_encoder.py", "roofline.py",
                                  "trace.py", "layers.py"])
def test_the_yardstick_imports_nothing_of_the_program(name):
    assert "lz4_tpu_torch" not in imported(BENCH / name)


def test_no_harness_file_reads_the_jax_package():
    for path in harness_files() + [BENCH / "frozen_encoder.c"]:
        text = path.read_text()
        assert "lz4_tpu/" not in text and "lz4_tpu." not in text, path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole (small) run of each cell on the CPU, in a process where
    importing JAX or the JAX package fails, leaves none of them loaded."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'lz4_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from benchmark import run\n"
        "from benchmark.tests.small import small_cell, WORKLOADS\n"
        "for w in WORKLOADS:\n"
        "    r = run.execute(small_cell(w), 5, 0.2, w.endswith('device-"
        "compress'), device='cpu')\n"
        "    assert r['correct'], r\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None\n"
        "       and m.split('.')[0] in run.FORBIDDEN]\n"
        "print('loaded', bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "loaded []" in r.stdout
