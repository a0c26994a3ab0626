"""The port's operators and model problems against the JAX package's, on
the same data (convert.operator_from_arrays carries the JAX operators'
arrays across).  Plain elementwise products in the same order: float64
agreement to a few ulps."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import arnoldimethod_tpu.models.problems as jp
from arnoldimethod_tpu.models.operators import (
    DenseOperator as JDense,
    Stencil5Operator as JStencil,
)
import arnoldimethod_torch.models.problems as tp
from arnoldimethod_torch.convert import operator_from_arrays
from arnoldimethod_torch.models.operators import (
    DenseOperator,
    FunctionOperator,
    Stencil5Operator,
    as_operator,
)
from arnoldimethod_torch import _device

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


TOL = 1e-13


def _x(n, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(n)
    return x.astype(dtype)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


@pytest.mark.parametrize(
    "build",
    [
        lambda m: m.laplacian_1d(50),
        lambda m: m.tridiagonal(40, 0.5, -2.0, 1.5),
        lambda m: m.laplacian_2d(8, 6),
        lambda m: m.convection_diffusion_2d(8, 6, peclet=20.0),
    ],
    ids=["laplacian_1d", "tridiagonal", "laplacian_2d", "convdiff_2d"],
)
def test_dia_problems_match(build):
    jop, top = build(jp), build(tp)
    assert top.offsets == jop.offsets and top.shape == jop.shape
    assert top.dtype == torch.float64
    np.testing.assert_array_equal(top.diags.numpy(), np.asarray(jop.diags))
    x = _x(top.shape[0])
    _close(top.matvec(torch.from_numpy(x)).numpy(), jop.matvec(jnp.asarray(x)))


@pytest.mark.parametrize(
    "build",
    [
        lambda m: m.laplacian_2d(8, 6, fmt="stencil"),
        lambda m: m.convection_diffusion_2d(8, 6, fmt="stencil"),
        lambda m: m.convection_diffusion_periodic_2d(8, 6, dtype=np.float64),
    ],
    ids=["laplacian", "convdiff", "periodic"],
)
def test_stencil_problems_match(build):
    jop, top = build(jp), build(tp)
    assert top.coeffs == jop.coeffs and top.grid == jop.grid
    assert top.boundary == jop.boundary and top.nnz == jop.nnz
    x = _x(top.shape[0])
    _close(top.matvec(torch.from_numpy(x)).numpy(), jop.matvec(jnp.asarray(x)))


def test_complex_coefficient_stencil_matches():
    coeffs = (4.0 + 0.5j, -1.0, -1.0 + 0.25j, -1.0, -1.0 - 0.25j)
    jop = JStencil(coeffs, (6, 8), dtype=jnp.float64)
    top = Stencil5Operator(coeffs, (6, 8), dtype=torch.float64)
    assert top.dtype == torch.complex128
    x = _x(48, np.complex128)
    _close(top.matvec(torch.from_numpy(x)).numpy(), jop.matvec(jnp.asarray(x)))


def test_dense_and_convert_match():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((12, 12))
    x = _x(12)
    jy = JDense(jnp.asarray(A)).matvec(jnp.asarray(x))
    for op in (as_operator(A), operator_from_arrays("dense", {"A": A}, {})):
        assert isinstance(op, DenseOperator)
        _close(op.matvec(torch.from_numpy(x)).numpy(), jy)


def test_convert_dia_and_stencil_from_jax_arrays():
    jdia = jp.convection_diffusion_2d(8, 6)
    tdia = operator_from_arrays(
        "dia",
        {"diags": np.asarray(jdia.diags), "offsets": np.asarray(jdia.offsets)},
        {"shape": jdia.shape},
    )
    jst = jp.convection_diffusion_periodic_2d(8, 6, dtype=np.float64)
    tst = operator_from_arrays(
        "stencil",
        {"coeffs": np.asarray(jst.coeffs)},
        {"grid": jst.grid, "boundary": jst.boundary, "dtype": "float64"},
    )
    x = _x(48)
    for jop, top in ((jdia, tdia), (jst, tst)):
        _close(top.matvec(torch.from_numpy(x)).numpy(), jop.matvec(jnp.asarray(x)))
    with pytest.raises(ValueError):
        operator_from_arrays("coo", {}, {})


def test_matmat_is_columnwise_matvec():
    op = tp.laplacian_2d(5, 4, fmt="stencil", dtype=torch.float64)
    X = torch.from_numpy(np.random.default_rng(4).standard_normal((20, 3)))
    Y = op.matmat(X)
    for k in range(3):
        _close(Y[:, k].numpy(), op.matvec(X[:, k]).numpy(), 0)
    _close((op @ X[:, 0]).numpy(), Y[:, 0].numpy(), 0)


def test_as_operator_inputs():
    f = FunctionOperator(lambda x: 2 * x, 5, np.float64)
    assert as_operator(f) is f
    g = as_operator(lambda x: 3 * x, n=4, dtype=np.float32)
    assert g.shape == (4, 4) and g.dtype == torch.float32
    assert as_operator(np.eye(3, dtype=np.int64)).dtype == torch.float64
    assert as_operator(torch.eye(3, dtype=torch.int32)).dtype == torch.float64
    with pytest.raises(ValueError):
        as_operator(lambda x: x)
    with pytest.raises(ValueError):
        as_operator(np.zeros((3, 4)))
    with pytest.raises(ValueError):
        as_operator(np.zeros(3))


def test_not_ported_inputs_raise():
    """Unknown layouts and boundaries raise.  scipy.sparse input and
    fmt="ell", which raised here before the general-sparse operators were
    ported, now build operators (tests/test_torch_sparse.py)."""

    class FakeSparse:
        shape = (3, 4)

        def tocsr(self):
            return self

    with pytest.raises(ValueError, match="not square"):
        as_operator(FakeSparse())
    assert tp.laplacian_1d(10, fmt="ell").nnz == 30
    with pytest.raises(ValueError):
        tp.laplacian_1d(10, fmt="csr")
    with pytest.raises(ValueError):
        Stencil5Operator((4, -1, -1, -1, -1), (4, 4), boundary="neumann")
    with pytest.raises(ValueError):
        Stencil5Operator((4, -1, -1, -1, -1), (4, 4), use_pallas=True,
                         boundary="periodic")
