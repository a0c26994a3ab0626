"""The port's 5-point stencil (arnoldimethod_torch/ops/stencil.py) against
the JAX package's two Pallas kernels, run in interpret mode on the CPU.

On the CPU the port's wrappers take the plain PyTorch version; the CUDA
kernel they launch on a card is compared with that plain version by
chip_smoke.py.  Tolerance, both dtypes: |y_port - y_jax| <=
8 * eps(dtype) * sum|coeff| * max|x|, a few roundings of a five-term sum.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from arnoldimethod_tpu.ops.stencil_pallas import (
    _pick_sliding_rows,
    stencil5_matvec as jax_halo,
    stencil5_matvec_sliding as jax_sliding,
)
from arnoldimethod_torch.models.operators import Stencil5Operator
from arnoldimethod_torch.ops import stencil
from arnoldimethod_torch import _device

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


LAPLACE = (4.0, -1.0, -1.0, -1.0, -1.0)
# convection_diffusion_2d coefficients at nx=128, peclet=10.
_BETA = 10.0 * (1.0 / 129) / 2.0
CONV = (4.0, -1.0 - _BETA, -1.0 + _BETA, -1.0, -1.0)
GRIDS = [(16, 128), (64, 256), (20, 128)]


def _bound(x, coeffs, dtype):
    return 8 * np.finfo(dtype).eps * sum(abs(c) for c in coeffs) * np.abs(x).max()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("coeffs", [LAPLACE, CONV], ids=["laplace", "convdiff"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_plain_matches_pallas_kernels(grid, coeffs, dtype):
    ny, nx = grid
    rng = np.random.default_rng(ny * nx)
    x = rng.standard_normal(ny * nx).astype(dtype)
    xt = torch.from_numpy(x)
    bound = _bound(x, coeffs, dtype)
    y_sliding = np.asarray(
        jax_sliding(jnp.asarray(x), coeffs=coeffs, grid=grid, interpret=True)
    )
    y_halo = np.asarray(
        jax_halo(jnp.asarray(x), coeffs=coeffs, grid=grid, interpret=True)
    )
    port_sliding = stencil.stencil5_matvec_sliding(xt, coeffs=coeffs, grid=grid)
    port_halo = stencil.stencil5_matvec(xt, coeffs=coeffs, grid=grid,
                                        tile_rows=4)
    assert port_sliding.dtype == xt.dtype
    assert np.abs(port_sliding.numpy() - y_sliding).max() <= bound
    assert np.abs(port_halo.numpy() - y_halo).max() <= bound


def test_ragged_grid_is_the_sliding_fallback_case():
    """(20, 128) has no multiple-of-8 row tile, so the JAX sliding kernel
    hands it to the halo kernel; the port's kernel takes any grid."""
    assert _pick_sliding_rows(20, 128, 4) == 0
    assert _pick_sliding_rows(20, 128, 8) == 0


def test_operator_takes_the_wrapper_for_real_dirichlet(monkeypatch):
    calls = []
    real = stencil.stencil5_matvec_sliding

    def spy(x, **kw):
        calls.append(x.dtype)
        return real(x, **kw)

    monkeypatch.setattr(stencil, "stencil5_matvec_sliding", spy)
    x = torch.ones(16 * 8, dtype=torch.float32)
    Stencil5Operator(LAPLACE, (16, 8)).matvec(x)
    Stencil5Operator(LAPLACE, (16, 8), use_pallas=True).matvec(x)
    assert calls == [torch.float32, torch.float32]
    # Explicit opt-out, periodic and complex stencils stay off the kernel.
    Stencil5Operator(LAPLACE, (16, 8), use_pallas=False).matvec(x)
    Stencil5Operator(LAPLACE, (16, 8), boundary="periodic").matvec(x)
    Stencil5Operator((4.0, -1.0, -1.0, -1.0 + 0.5j, -1.0 - 0.5j),
                     (16, 8)).matvec(x.to(torch.complex64))
    assert len(calls) == 2


def test_non_cpu_tensor_never_takes_the_plain_version():
    x = torch.empty(16 * 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        stencil.stencil5_matvec(x, coeffs=LAPLACE, grid=(16, 8))


def test_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from arnoldimethod_torch import partial_schur

    op = Stencil5Operator(LAPLACE, (16, 8), device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        partial_schur(op, nev=2)


def test_kernel_build_raises_without_nvcc(monkeypatch):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        stencil._Stencil5Kernel().load()


@pytest.mark.parametrize(
    "x,grid,err",
    [
        (torch.zeros(8, dtype=torch.float16), (2, 4), TypeError),
        (torch.zeros(2, 4), (2, 4), ValueError),
        (torch.zeros(9), (2, 4), ValueError),
        (torch.zeros(16)[::2], (2, 4), ValueError),
    ],
    ids=["dtype", "2d", "numel", "strided"],
)
def test_kernel_wrapper_rejects_bad_input(x, grid, err):
    with pytest.raises(err):
        stencil._Stencil5Kernel()(x, LAPLACE, grid)


def test_launch_count_starts_at_zero_and_plain_does_not_count():
    k = stencil._Stencil5Kernel()
    assert k.launches == 0
    before = stencil.KERNEL.launches
    stencil.stencil5_matvec(torch.ones(32), coeffs=LAPLACE, grid=(4, 8))
    assert stencil.KERNEL.launches == before
