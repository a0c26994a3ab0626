"""An installed copy of the port: the package built by pip from the
repository's sources into a read-only target directory (the layout of
site-packages, with no checkout around it).  It must ship and build its
own C++ dense core (History.dense_layer == "native") and put its build
products in the user's cache, never beside the installed package.  Also
the ARNOLDI_TPU_DEBUG checks of the host method: with the variable set, a
solve whose operator returns NaN raises FloatingPointError.
"""

import json
import os
import shutil
import stat
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import arnoldimethod_torch as tam
from arnoldimethod_torch import _device, driver
from arnoldimethod_torch.models.operators import FunctionOperator

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


PROBE = textwrap.dedent("""
    import json, os, numpy as np
    import arnoldimethod_torch as tam
    from arnoldimethod_torch import _build
    from arnoldimethod_torch.dense import native
    from arnoldimethod_torch.models.problems import laplacian_1d
    ok = native.available()
    d, h = tam.partial_schur(laplacian_1d(50, device="cpu"), nev=4, which="SR",
                             tol=1e-8, device="cpu")
    print(json.dumps(dict(
        package=str(_build.PACKAGE_DIR), build_dir=str(_build.BUILD_DIR),
        available=ok, error=native.build_error, layer=h.dense_layer,
        converged=h.converged,
        writable=os.access(_build.BUILD_DIR, os.W_OK))))
""")


def test_installed_copy_builds_its_dense_core(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("the dense core needs g++")
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "setup.py", "README.md"):
        shutil.copy2(REPO / name, src / name)
    (src / "native").mkdir()
    shutil.copy2(REPO / "native" / "arnoldi_dense.cpp", src / "native")
    ignore = shutil.ignore_patterns("__pycache__", "*.so")
    for pkg in ("arnoldimethod_tpu", "arnoldimethod_torch"):
        shutil.copytree(REPO / pkg, src / pkg, ignore=ignore)
    target = tmp_path / "site"
    subprocess.run([sys.executable, "-m", "pip", "install", "--no-deps",
                    "--no-build-isolation", "--no-index", "--no-cache-dir", "-q",
                    "--target", str(target), str(src)], check=True,
                   capture_output=True,
                   cwd=tmp_path, timeout=600)
    installed = target / "arnoldimethod_torch"
    assert (installed / "dense" / "arnoldi_dense.cpp").is_file()
    assert {p.name for p in (installed / "csrc").glob("*.cu")} >= {
        "stencil5.cu", "bsr.cu", "df.cu", "dense_restart.cu"}
    # site-packages is read-only to the user who runs the package.
    for d, _, _ in os.walk(target):
        os.chmod(d, stat.S_IRUSR | stat.S_IXUSR)
    cache = tmp_path / "cache"
    env = dict(os.environ, PYTHONPATH=str(target), XDG_CACHE_HOME=str(cache),
               HOME=str(tmp_path / "home"), ARNOLDI_TPU_NATIVE="1")
    try:
        out = subprocess.run([sys.executable, "-c", PROBE], check=True,
                             capture_output=True, text=True, env=env,
                             cwd=tmp_path, timeout=600)
    finally:
        for d, _, _ in os.walk(target):
            os.chmod(d, stat.S_IRWXU)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert Path(got["package"]) == installed.resolve()
    assert got["available"], got["error"]
    assert got["layer"] == "native" and got["converged"]
    build = Path(got["build_dir"])
    assert build == cache / "arnoldimethod_torch" / "build"
    assert got["writable"]
    assert target not in build.parents
    assert list(build.glob("libarnoldi_dense-*.so"))


def test_checkout_builds_beside_the_package():
    from arnoldimethod_torch import _build

    assert _build.BUILD_DIR == REPO / "build" / "arnoldimethod_torch"


def _nan_after(n, calls):
    def matvec(x):
        calls.append(1)
        y = 2.0 * x - torch.roll(x, 1) - torch.roll(x, -1)
        return y * float("nan") if len(calls) > n else y
    return matvec


def test_debug_checks_catch_a_nan_operator(monkeypatch):
    monkeypatch.setattr(driver, "_DEBUG", True)
    calls = []
    op = FunctionOperator(_nan_after(30, calls), 60, dtype=torch.float64,
                          device="cpu")
    with pytest.raises(FloatingPointError, match="non-finite"):
        tam.partial_schur(op, v1=np.ones(60), nev=4, which="SR", tol=1e-12,
                          maxdim=20)


def test_debug_checks_catch_a_lost_basis(monkeypatch):
    monkeypatch.setattr(driver, "_DEBUG", True)
    real = driver.truncate_and_expand

    def spoiled(op, V, H, Qbig, j0, j1, generator, comm=None):
        syncs = real(op, V, H, Qbig, j0, j1, generator, comm)
        V[j1 - 1] += 0.5 * V[0]
        return syncs

    monkeypatch.setattr(driver, "truncate_and_expand", spoiled)
    with pytest.raises(FloatingPointError, match="orthonormality"):
        tam.partial_schur(np.diag(np.arange(1.0, 61.0)), v1=np.ones(60), nev=4,
                          tol=1e-12, maxdim=20)


def test_debug_checks_pass_a_clean_solve_and_are_off_by_default(monkeypatch):
    assert driver._DEBUG == (os.environ.get("ARNOLDI_TPU_DEBUG", "0") != "0")
    monkeypatch.setattr(driver, "_DEBUG", True)
    d, h = tam.partial_schur(np.diag(np.arange(1.0, 61.0)), v1=np.ones(60),
                             nev=4, tol=1e-10, maxdim=20)
    assert h.converged
    calls = []
    op = FunctionOperator(_nan_after(30, calls), 60, dtype=torch.complex128,
                          device="cpu")
    # Split-complex solves are exempt, as in the JAX package.
    tam.partial_schur(op, v1=np.ones(60) + 0j, nev=4, which="SR", tol=1e-12,
                      maxdim=20, restarts=3, split_complex=True)
