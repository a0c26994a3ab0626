"""No module a cell loads is JAX or the JAX package: the top-level name of
every module (the part before the first dot) is compared whole, so the
port, whose name begins with the JAX package's, passes."""

import subprocess
import sys

import pytest

from conftest import ROOT, cells
from cardbench import harness

DRIVE = """
import io, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import small_cell
from cardbench import harness
harness.run(small_cell({name!r}), 5, 0.1, {trace}, device="cpu",
            out=io.StringIO(), err=sys.stderr)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", cells())
def test_a_cells_modules(name, trace):
    code = DRIVE.format(root=str(ROOT), tests=str(ROOT / "cardbench" / "tests"),
                        name=name, trace=trace)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tops = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "arnoldimethod_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_a_loaded_jax_refuses_the_result():
    code = DRIVE.format(root=str(ROOT), tests=str(ROOT / "cardbench" / "tests"),
                        name="lap2d1m.host", trace=0)
    code = "import sys, types; sys.modules['jaxlib.x'] = types.ModuleType('x')\n" + code
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 3
    assert "jaxlib" in proc.stderr
