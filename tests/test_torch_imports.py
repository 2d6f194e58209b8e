"""The PyTorch port stands alone: it imports without jax and without the JAX
package, and its entry points default to the GPU with no CPU fallback."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
print("IMPORTED", len(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_every_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split("IMPORTED")[1]) >= 20


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("repro", "jax", "jaxlib", "flax")}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_resolve_device_has_no_cpu_fallback():
    from repro_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_entry_points_default_to_cuda():
    """Engine, service, params and the launcher all go through resolve_device."""
    from repro_torch import AnomalyService, build_engine, get_config, params_from_numpy

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device resolves")
    cfg = get_config("lstm-ae-f32-d2")
    for make in (lambda: build_engine(cfg, "fused"),
                 lambda: AnomalyService(cfg, "fused"),
                 lambda: params_from_numpy({"w": [1.0]})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                          "lstm-ae-f32-d2", "--requests", "1"], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    """chip_smoke.py prints no result and exits non-zero without a GPU, and
    in a directory that holds nothing else of the repository."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: chip_smoke.py would run in full")
    script = (ROOT / "chip_smoke.py").read_text()
    (tmp_path / "chip_smoke.py").write_text(script)
    for cwd, path in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        out = subprocess.run([sys.executable, str(path)], cwd=cwd, capture_output=True,
                             text=True, timeout=300, env={**os.environ, "PYTHONPATH": ""})
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
