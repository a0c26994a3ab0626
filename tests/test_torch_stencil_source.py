"""The CUDA source of the stencil kernels (arnoldimethod_torch/csrc/
stencil5.cu) run on the CPU: compiled with g++ against
tests/cuda_host_shim.h (a host thread per CUDA thread, blocks in turn,
barriers, shared memory as statics) with -ffp-contract=off, and driven
through ops/stencil.py's own wrapper and filter loop.

The fused Chebyshev run (up to cheb_depth degree steps a launch) is held
bit for bit to the chain of one-step launches of the same source, in
float32 and float64, on ragged grids (one row, one column, narrower than
one strip, wider than one, fewer rows than 2 s, 37 x 45) and at degrees
1, 2, s - 1, s, s + 1 and 2 s + 3, with blocks one to a few rows tall.  A
copy of the source whose run computes the points outside the grid, where
the boundary holds them at zero, must fail.

This checks the kernels' indexing, staging and order of operations where
there is no card; only chip_smoke.py shows that nvcc builds them and that
they run so on an H100.  Sizes are small: every CUDA thread is a host
thread here.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from arnoldimethod_torch import _device
from arnoldimethod_torch.models.operators import Stencil5Operator
from arnoldimethod_torch.ops import stencil
from arnoldimethod_torch.transforms import ChebyshevFilterOperator
from test_torch_df_source import host_source

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CU = REPO / "arnoldimethod_torch" / "csrc" / "stencil5.cu"
LAPLACE = (0.52, -0.13, -0.13, -0.13, -0.13)

# The run's test of the boundary, and the mutant that computes the points
# outside the grid instead of holding them at zero.
IN_GRID = "out[k] = row_ok && in_grid[k] ? v : T(0);"
OUT_OF_GRID = "out[k] = row_ok ? v : T(0);"


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


def _host_build(directory, cu):
    """stencil5.cu's text `cu` built for the host shim into `directory`,
    its entries declared by ops/stencil.py's `bind`."""
    src = directory / "stencil5_host.cpp"
    src.write_text(host_source(cu))
    so = directory / "libstencil5_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-Wno-unknown-pragmas", "-o",
                    str(so), str(src)], check=True, capture_output=True,
                   timeout=300)
    return stencil.bind(ctypes.CDLL(str(so)))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host build of stencil5.cu needs g++")
    return _host_build(tmp_path_factory.mktemp("stencil5_host"),
                       CU.read_text())


@pytest.fixture(scope="module")
def mutant(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host build of stencil5.cu needs g++")
    cu = CU.read_text()
    assert cu.count(IN_GRID) == 1
    return _host_build(tmp_path_factory.mktemp("stencil5_mutant"),
                       cu.replace(IN_GRID, OUT_OF_GRID))


def _host_kernel(library, monkeypatch, slots):
    """ops/stencil.py's kernel wrapper over a host-built library (CPU
    tensors, no stream; `slots` blocks a wave for cheb_plan), with the
    filter's runs routed to it."""
    K = stencil._Stencil5Kernel()

    def launch(entry, x, ptrs, grid, scalars, tail):
        fn = getattr(library, entry + stencil._suffix(x.dtype))
        assert fn(*ptrs, *grid, *(float(v) for v in scalars), *tail,
                  None) == 0

    monkeypatch.setattr(K, "_launch", launch)
    monkeypatch.setattr(K, "cheb_slots", lambda x: slots)

    def run(x, z, *, coeffs, grid, c, inv_e, pq, hi, lo=None):
        K.cheb_run(x, z, lo, hi, coeffs, grid, c, inv_e, pq)
        return lo, hi

    monkeypatch.setattr(stencil, "stencil5_cheb_steps", run)
    return K


def _filter(grid, dtype, degree):
    op = Stencil5Operator(LAPLACE, grid, dtype=dtype)
    return ChebyshevFilterOperator(op, 0.2, 1.05, degree, scale_point=0.01)


def _chain(library, fop, x):
    """The one-step launches of the filter, y_1 .. y_degree (one block a
    strip of 128 columns, the whole grid tall)."""
    ny, nx = fop.op.grid
    step = getattr(library, "stencil5_cheb" + stencil._suffix(x.dtype))
    scalars = (*LAPLACE, (fop.a + fop.b) / 2, 1.0 / ((fop.b - fop.a) / 2))
    prev, y, out = None, x, []
    for p, q in [(fop.first, 0.0), *fop.steps]:
        new = torch.empty_like(x)
        assert step(y.data_ptr(), None if prev is None else prev.data_ptr(),
                    new.data_ptr(), ny, nx, *scalars, p,
                    0.0 if prev is None else q, ny, None) == 0
        prev, y = y, new
        out.append(y)
    return out


GRIDS = [(1, 40), (40, 1), (5, 30), (3, 500), (7, 20), (37, 45)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("grid", GRIDS)
def test_run_source_is_the_one_step_chain(lib, monkeypatch, dtype, grid):
    """The fused run, through the filter loop, against the chain of one-step
    launches: bitwise at degrees 1, 2, s - 1, s, s + 1 and 2 s + 3, every
    launch but the last s steps deep, blocks ~ny / 3 rows tall."""
    s = stencil.cheb_depth(dtype)
    K = _host_kernel(lib, monkeypatch, slots=3)
    n = grid[0] * grid[1]
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n)).to(dtype)
    x0 = x.clone()
    top = 2 * s + 3
    want = _chain(lib, _filter(grid, dtype, top), x)
    launches, steps = K.cheb_launches, K.cheb_steps
    for degree in (1, 2, s - 1, s, s + 1, top):
        y = _filter(grid, dtype, degree).matvec(x)
        assert torch.equal(y, want[degree - 1]), degree
        assert K.cheb_launches - launches == -(-degree // s)
        assert K.cheb_steps - steps == degree
        launches, steps = K.cheb_launches, K.cheb_steps
    assert torch.equal(x, x0)
    assert bool(torch.isfinite(want[-1]).all()) and want[-1].abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_run_source_one_row_blocks(lib, monkeypatch, dtype):
    """Blocks of one row each (every block all warm-up but one row) and
    blocks of the whole grid, both bitwise the chain."""
    grid = (9, 11)
    s = stencil.cheb_depth(dtype)
    n = grid[0] * grid[1]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(n)).to(dtype)
    want = _chain(lib, _filter(grid, dtype, s + 1), x)[-1]
    for slots in (1, 9):
        _host_kernel(lib, monkeypatch, slots)
        assert torch.equal(_filter(grid, dtype, s + 1).matvec(x), want)


def test_run_source_refuses_bad_launches(lib):
    x = torch.zeros(12)
    y = torch.zeros(12)
    p = (ctypes.c_double * 17)(*[1.0] * 17)
    args = [x.data_ptr(), None, None, y.data_ptr(), 3, 4, *LAPLACE, 0.5, 2.0,
            p, p]
    run = lib.stencil5_cheb_run_f32
    assert run(*args, 1, 2, None) == 0
    assert run(*args, 16, 2, None) == 0
    for levels, rows in ((0, 2), (17, 2), (1, 0)):
        assert run(*args, levels, rows, None) != 0
    xd = torch.zeros(12, dtype=torch.float64)
    yd = torch.zeros(12, dtype=torch.float64)
    argd = [xd.data_ptr(), None, None, yd.data_ptr(), *args[4:]]
    assert lib.stencil5_cheb_run_f64(*argd, 8, 2, None) == 0
    assert lib.stencil5_cheb_run_f64(*argd, 9, 2, None) != 0
    bad = list(args)
    bad[3] = None  # no hi
    assert run(*bad, 1, 2, None) != 0


def test_run_source_mutation_fails(mutant, monkeypatch):
    """A run that computes the out-of-grid halo instead of holding it at
    zero differs from the chain: the boundary's zeros are part of the
    arithmetic the test sees."""
    grid = (37, 45)
    n = grid[0] * grid[1]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(n)).float()
    _host_kernel(mutant, monkeypatch, slots=3)
    want = _chain(mutant, _filter(grid, torch.float32, 17), x)[-1]
    assert not torch.equal(_filter(grid, torch.float32, 17).matvec(x), want)
