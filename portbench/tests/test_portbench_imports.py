"""What the benchmark may load: no JAX and no JAX package anywhere, nothing of
the program in the reference, nothing of the JAX package's old benchmark; and
no run without a card or without the program."""
import ast
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from portbench import harness

HERE = harness.HERE
OLD_BENCHMARKS = "benchmarks" + "/"    # the JAX package's benchmark, which nothing reads
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            names.update(a.value for a in node.args if isinstance(a, ast.Constant))
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package_import(path):
    """Compared by the whole top-level name: ``repro_torch`` is not ``repro``."""
    bad = {m for m in _imported(path) if m.split(".")[0] in harness.FORBIDDEN}
    assert not bad, f"{path} imports {sorted(bad)}"
    assert OLD_BENCHMARKS not in path.read_text()


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    top = {m.split(".")[0] for m in _imported(path)}
    assert top <= {"__future__", "contextlib", "typing", "torch"}, top


def test_forbidden_modules_compare_whole_names(monkeypatch):
    for name in ("repro_torch", "repro_torchx", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == [m for m in sorted(sys.modules)
                                           if m.split(".")[0] in harness.FORBIDDEN]
    monkeypatch.setitem(sys.modules, "repro.engine", types.ModuleType("repro.engine"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    found = harness.forbidden_modules()
    assert "repro.engine" in found and "jax" in found
    assert not any(m.startswith(("repro_torch", "jaxtyping", "flaxen")) for m in found)


def test_the_command_refuses_to_run_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPYCACHEPREFIX=str(tmp_path))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "f64d6.bulk",
                          "--seed", str(2**32 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_a_checkout_of_the_benchmark_alone_runs_nothing(tmp_path):
    """With only BENCHMARK.json and portbench/, the program is missing: the run
    fails and prints no result (here on the CPU, past the look for a card)."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import json, time, torch\n"
            "from portbench import harness\n"
            "print(json.dumps(harness.run_cell('f32d2.latency', 1, 0.1, False,"
            " torch.device('cpu'), time.perf_counter(), {'pool': 2, 'reference_block': 2})))\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "repro_torch" in out.stderr
