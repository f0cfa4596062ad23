"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole: ``repro_torch`` begins with ``repro``), and the plain
reference loads nothing of the program."""
import subprocess
import sys

from portbench.harness import isolation
from portbench.harness.spec import ROOT

_PROBE = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import importlib
for name in {mods!r}:
    importlib.import_module(name)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _loaded(mods):
    code = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT), mods=mods)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    return set(eval(res.stdout.strip().splitlines()[-1]))


def test_harness_drivers_and_program_load_no_jax():
    top = _loaded(["portbench.harness.spec", "portbench.harness.trace",
                   "portbench.drivers.train", "portbench.drivers.serve", "portbench.refs.lm",
                   "repro_torch.train", "repro_torch.serve.engine", "repro_torch.models.lm"])
    assert "repro_torch" in top
    assert not isolation.loaded_forbidden(top), top


def test_reference_loads_no_program():
    top = _loaded(["portbench.refs.lm", "portbench.harness.compare"])
    assert not isolation.loaded_forbidden(top) and "repro_torch" not in top, top
    assert isolation.refs_imports() == {}


def test_names_are_compared_whole():
    assert isolation.loaded_forbidden(["repro_torch.models.lm", "reprolib"]) == []
    assert isolation.loaded_forbidden(["repro.core.api", "jax.numpy", "flax"]) == [
        "flax", "jax", "repro"]
