"""Nothing the benchmark runs loads JAX or the JAX package, the reference
loads nothing of the program, and a run without a card prints no result."""

import ast
import json
import shutil
import subprocess
import sys
import types

from benchmark import run as runner
from benchmark.tests.helpers import REPO

REFERENCE_SIDE = ("reference.py", "judge.py", "sampler.py", "counts.py", "measure.py")


def _py(code: str, cwd=REPO, timeout=300):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "plasma_control_tpu_torch_fake", types.ModuleType("x"))
    assert runner.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert runner.loaded_forbidden() == ["jax"]


def test_a_run_on_the_cpu_loads_no_jax():
    """Build a small cell's program, run two of its steps and the reference,
    then list the top-level names in sys.modules."""
    code = (
        "import sys, json; sys.path.insert(0, '.')\n"
        "from benchmark.tests.helpers import tiny_cell\n"
        "from benchmark import harness\n"
        "r = harness.run(tiny_cell('two_stream_n100k.mpc_twin_graph', steps=8), 5, 0.01, False,"
        " 'cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = _py(code)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "plasma_control_tpu_torch" in names
    assert not names & set(runner.FORBIDDEN)


def test_the_reference_side_imports_nothing_of_the_program():
    for name in REFERENCE_SIDE:
        tree = ast.parse((REPO / "benchmark" / name).read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            for mod in mods:
                assert mod.split(".")[0] not in ("plasma_control_tpu_torch",
                                                 *runner.FORBIDDEN), (name, mod)
    out = _py("import sys; sys.path.insert(0, '.')\n"
              "import benchmark.reference, benchmark.judge, benchmark.sampler\n"
              "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert out.returncode == 0 and "plasma_control_tpu" not in out.stdout


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "bump_on_tail_n5k.mpc_graph", "--seed", "2147483659", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/ lacks the program."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from benchmark import harness\n"
            "from benchmark.cell import load_cell\n"
            "harness.run(load_cell('bump_on_tail_n5k.mpc_graph'), 1, 1.0, False, 'cpu')\n"
            "print('{}')\n")
    out = _py(code, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "plasma_control_tpu_torch" in out.stderr
