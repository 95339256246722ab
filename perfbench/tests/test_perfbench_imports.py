"""What the benchmark loads and imports: no module of JAX or of the JAX
package (`sharp_tpu`, compared as a whole top-level name, since the port's
`sharp_tpu_torch` begins with it), a reference that imports nothing of the
program, and no file that imports the repository's older benches,
scripts or tests."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "sharp_tpu"}


def _imports(path: Path):
    """Top-level names of the modules a file imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_loaded_modules_hold_no_jax():
    """A fresh interpreter that imports every module of the harness, every
    traffic driver and metric reader through the registry, and the port."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import importlib, pkgutil
import perfbench.run, perfbench.control
from perfbench.lib import registry
for sub in ("lib", "reference", "data"):
    pkg = importlib.import_module("perfbench." + sub)
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"perfbench.{{sub}}.{{m.name}}")
for cell in registry.names("workloads"):
    registry.driver(registry.workload(cell))
for name in registry.names("metrics"):
    registry.metric(name)
import sharp_tpu_torch, sharp_tpu_torch.api, sharp_tpu_torch.core.large, sharp_tpu_torch.parallel.streaming
print(sorted({{m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r}}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_forbidden_module_names():
    from perfbench.run import forbidden_modules

    sys.modules["sharp_tpu_fake_probe"] = None          # a prefix of no forbidden name
    try:
        assert "sharp_tpu_fake_probe" not in forbidden_modules()
    finally:
        del sys.modules["sharp_tpu_fake_probe"]


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    bad = _imports(path) & (FORBIDDEN | {"sharp_tpu_torch"})
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_old_benches_scripts_or_tests(path):
    bad = _imports(path) & ({"bench_torch", "bench", "chip_smoke", "scripts", "tests"} | FORBIDDEN)
    assert not bad, f"{path.relative_to(BENCH)} imports {bad}"
