"""The port stands alone: importing every module of repro_torch loads neither
jax, nor anything of the JAX package (repro), nor ml_dtypes (which the card's
machine lacks), builds no kernel, and no source of the port or chip_smoke.py
names them in an import."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")
from torch_threads import pin_threads  # noqa: E402

pin_threads()

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "repro", "ml_dtypes"))
from repro_torch.kernels import _build
print(len(names), bad, int(_build._module is not None))
"""


def test_importing_the_port_loads_no_jax_and_no_repro():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr
    # "<modules imported> <jax/repro modules loaded> <kernels built>"
    line = res.stdout.strip().splitlines()[-1]
    assert line.endswith("[] 0"), line
    assert int(line.split()[0]) >= 80, line


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert not bad, (path, bad)
