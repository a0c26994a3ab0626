"""The port's shift-invert family (dense LU, generalized, B-inner-product,
FFT circulant, tridiagonal) against the JAX package's, on the same
numpy-seeded inputs, on the CPU.

Tolerances: float64 solves agree to 1e-10 relative to max|y| (both
packages factor with LAPACK-style partial pivoting or exact FFTs; only the
order of sums differs); float32 to 1e-5.  The tridiagonal solve combines
its affine maps in another tree than JAX's associative scan, so it agrees
to rounding: 1e-12 relative in float64.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import arnoldimethod_tpu as jam
import arnoldimethod_torch as tam
from arnoldimethod_tpu.models.operators import (
    SplitComplexOperator,
    dia_from_diagonals as jdia_from_diagonals,
)
from arnoldimethod_tpu.ops.tridiag import tridiag_lu_solve as jax_solve
from arnoldimethod_torch.convert import operator_from_arrays
from arnoldimethod_torch.models import problems as tp
from arnoldimethod_torch.models.operators import dia_from_diagonals
from arnoldimethod_torch.ops.tridiag import (
    factor_tridiagonal,
    tridiag_lu_solve,
)
from arnoldimethod_tpu.models import problems as jp
from arnoldimethod_torch import _device

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(1.0, np.abs(want).max())


def _vec(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(n)
    return x.astype(dtype)


def _tridiag_dense(dl, d, du):
    return np.diag(d) + np.diag(dl, -1) + np.diag(du, 1)


@pytest.mark.parametrize("sigma,dtype,rtol", [
    (0.3, np.float64, 1e-10),
    (0.3, np.float32, 1e-5),
    (0.3 + 0.2j, np.float64, 1e-10),
], ids=["f64", "f32", "complex_sigma"])
def test_shift_invert_dense_matches_jax(sigma, dtype, rtol):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((40, 40)).astype(dtype)
    jop = jam.ShiftInvertDenseOperator.build(jnp.asarray(A), sigma)
    top = tam.ShiftInvertDenseOperator.build(A, sigma)
    assert str(top.dtype).split(".")[-1] == str(jop.dtype)
    x = _vec(40, np.dtype(str(jop.dtype)))
    _close(top.matvec(torch.from_numpy(x)).numpy(),
           jop.matvec(jnp.asarray(x)), rtol)
    # A matrix of columns solves column by column.
    X = torch.from_numpy(np.stack([x, 2 * x], axis=1))
    _close(top.matvec(X)[:, 1].numpy(), 2 * top.matvec(X[:, 0]).numpy(), rtol)


def test_generalized_shift_invert_matches_jax():
    rng = np.random.default_rng(42)
    A = rng.standard_normal((60, 60))
    B = rng.standard_normal((60, 60))
    for sigma in (0.0, 0.5):
        jop = jam.GeneralizedShiftInvertOperator.build(A, B, sigma=sigma)
        top = tam.GeneralizedShiftInvertOperator.build(A, B, sigma=sigma)
        x = _vec(60, np.float64, 3)
        _close(top.matvec(torch.from_numpy(x)).numpy(),
               jop.matvec(jnp.asarray(x)), 1e-10)
        thetas = np.array([2.0, -0.5 + 1j])
        np.testing.assert_allclose(top.eigenvalues_back(thetas),
                                   np.asarray(jop.eigenvalues_back(thetas)))
    # A Python sigma is weak: a float32 pencil stays float32; a numpy
    # float64 sigma promotes, as in the JAX package.
    A32, B32 = A.astype(np.float32), B.astype(np.float32)
    assert tam.GeneralizedShiftInvertOperator.build(
        A32, B32, sigma=0.5).dtype == torch.float32
    assert str(jam.GeneralizedShiftInvertOperator.build(
        A32, B32, sigma=0.5).dtype) == "float32"
    assert tam.GeneralizedShiftInvertOperator.build(
        A32, B32, sigma=np.float64(0.5)).dtype == torch.float64


def test_generalized_shift_invert_solve():
    """A x = B x lambda through partial_schur :LM and eigenvalues_back
    (the reference's docs example)."""
    rng = np.random.default_rng(42)
    A = rng.standard_normal((100, 100))
    B = rng.standard_normal((100, 100))
    op = tam.GeneralizedShiftInvertOperator.build(A, B, sigma=0.0)
    decomp, history = tam.partial_schur(op, nev=4, which="LM", tol=1e-5,
                                        restarts=100)
    assert history.converged
    thetas, X = tam.partial_eigen(decomp)
    lams = np.asarray(op.eigenvalues_back(np.asarray(thetas)))
    X = np.asarray(X)
    assert np.linalg.norm(A @ X - B @ X @ np.diag(lams)) < 1e-4


@pytest.mark.parametrize("diagonal_b", [True, False],
                         ids=["diagonal_B", "full_B"])
def test_b_inner_product_matches_jax_and_recovers_q(diagonal_b):
    """With the docs' diagonal B the port's operator is the JAX package's;
    with a full s.p.d. B the port applies L^{-1} A L^{-H} (the JAX package
    applies L^{-H} A L^{-1} there), and Q^H A Q = R, Q^H B Q = I hold."""
    rng = np.random.default_rng(7)
    A = rng.standard_normal((100, 100))
    B = np.diag(np.linspace(1.0, 2.0, 100))
    if not diagonal_b:
        B = B + 0.01 * np.ones((100, 100))
    jop = jam.BInnerProductOperator.build(A, B)
    top = tam.BInnerProductOperator.build(A, B)
    x = _vec(100, np.float64, 2)
    L = np.linalg.cholesky(B)
    want = np.linalg.solve(L, A @ np.linalg.solve(L.T, x))
    _close(top.matvec(torch.from_numpy(x)).numpy(), want, 1e-10)
    if diagonal_b:
        _close(top.matvec(torch.from_numpy(x)).numpy(),
               jop.matvec(jnp.asarray(x)), 1e-10)
    Y = np.linalg.qr(rng.standard_normal((100, 4)))[0]
    _close(top.recover_q(torch.from_numpy(Y)).numpy(),
           jop.recover_q(jnp.asarray(Y)), 1e-10)
    decomp, history = tam.partial_schur(top, nev=4, which="LM", tol=1e-10)
    assert history.converged
    Q = top.recover_q(decomp.Q).numpy()
    assert np.linalg.norm(Q.T @ A @ Q - decomp.R) < 1e-8
    assert np.linalg.norm(Q.T @ B @ Q - np.eye(4)) < 1e-10


def _periodic(N, dtype):
    kw = dict(cx=0.15, cy=0.08, scale=0.13)
    return (jp.convection_diffusion_periodic_2d(N, dtype=dtype, **kw),
            tp.convection_diffusion_periodic_2d(
                N, dtype=torch.float32 if dtype == np.float32
                else torch.float64, **kw))


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10),
                                        (np.float32, 1e-5)])
def test_circulant_shift_invert_matches_jax(dtype, rtol):
    jop, top = _periodic(8, dtype)
    jsi = jam.CirculantShiftInvertOperator.build(jop, 1.3)
    tsi = tam.CirculantShiftInvertOperator.build(top, 1.3)
    assert tsi.dtype == (torch.float32 if dtype == np.float32
                         else torch.float64)
    assert tsi.inv.is_complex() and tsi.inv.shape == (8, 8)
    np.testing.assert_allclose(tsi.inv.numpy(),
                               np.asarray(jsi.inv_re) + 1j * np.asarray(jsi.inv_im),
                               rtol=0, atol=0)
    x = _vec(64, dtype, 5)
    y = tsi.matvec(torch.from_numpy(x))
    assert y.dtype == tsi.dtype
    _close(y.numpy(), jsi.matvec(jnp.asarray(x)), rtol)
    # Against the dense solve of the circulant.
    A = np.stack([top.matvec(torch.from_numpy(e.astype(dtype))).numpy()
                  for e in np.eye(64)], axis=1).astype(np.float64)
    np.testing.assert_allclose(y.numpy(), np.linalg.solve(
        A - 1.3 * np.eye(64), x), atol=1e-5 if dtype == np.float32 else 1e-12)
    thetas = np.array([0.5, 2.0 + 1j])
    np.testing.assert_allclose(tsi.eigenvalues_back(thetas),
                               np.asarray(jsi.eigenvalues_back(thetas)))


def test_circulant_shift_invert_rejects():
    with pytest.raises(ValueError, match="periodic"):
        tam.CirculantShiftInvertOperator.build(
            tam.Stencil5Operator((4, -1, -1, -1, -1), (4, 4)), 1.0)
    op = tam.Stencil5Operator((4 + 2j, -1, -1 + 0.5j, -1, -1.25j), (8, 8),
                              boundary="periodic")
    with pytest.raises(NotImplementedError, match="complex"):
        tam.CirculantShiftInvertOperator.build(op, 9.0)


def test_circulant_lm_solve_with_complex_pairs():
    """The periodic convection-diffusion recipe at test size: FFT
    shift-invert near the top, :LM, and the Rayleigh-Ritz back-map on A
    with complex Ritz pairs of the real basis, against the DFT symbol."""
    N, s, cx, cy = 32, 0.13, 0.15, 0.08
    top = tp.convection_diffusion_periodic_2d(N, cx=cx, cy=cy, scale=s,
                                              dtype=torch.float64)
    th = 2 * np.pi * np.arange(N) / N
    se = (s * ((2 - 2 * np.cos(th))[:, None] + (2 - 2 * np.cos(th))[None, :]
               + 2j * (cx * np.sin(th)[:, None] + cy * np.sin(th)[None, :]))
          ).ravel()
    si = tam.CirculantShiftInvertOperator.build(top, float(np.max(se.real))
                                                * 1.0005)
    d, h = tam.partial_schur(si, nev=10, which="LM", tol=1e-8, mindim=15,
                             maxdim=30, method="host")
    assert h.converged
    w, X, res = tam.rayleigh_ritz(top, d.Q)
    assert X.is_complex() and X.shape == (N * N, w.size)
    assert np.max(res) < 1e-6
    assert max(np.abs(se - lam).min() for lam in w) < 1e-6
    assert int(np.sum(np.abs(w.imag) > 1e-7)) >= 4
    lam_back = si.eigenvalues_back(np.asarray(d.eigenvalues))
    assert max(np.abs(se - lam).min() for lam in lam_back) < 1e-4


def _bands(n, seed, complex_=False, weak_diag=True):
    rng = np.random.default_rng(seed)

    def draw(m):
        v = rng.standard_normal(m)
        return v + 1j * rng.standard_normal(m) if complex_ else v

    d = draw(n) * (0.3 if weak_diag else 1.0)  # weak diagonal: row swaps
    return draw(n - 1), d, draw(n - 1)


@pytest.mark.parametrize("n", [1, 2, 3, 1000])
@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_tridiag_lu_solve_matches_jax_and_dense(n, complex_):
    dl, d, du = _bands(n, n + 1, complex_)  # seeds whose draws swap rows
    fac = factor_tridiagonal(dl, d, du)
    if n > 2:
        assert fac.swap.any()  # the pivoting branch runs
    b = _vec(n, np.complex128 if complex_ else np.float64, n + 1)
    x = tridiag_lu_solve(*(torch.from_numpy(a) for a in fac.arrays()),
                         torch.from_numpy(b)).numpy()
    xj = np.asarray(jax_solve(*(jnp.asarray(a) for a in fac.arrays()),
                              jnp.asarray(b)))
    xd = np.linalg.solve(_tridiag_dense(dl, d, du), b)
    scale = np.abs(xd).max()
    assert np.abs(x - xj).max() <= 1e-12 * scale
    assert np.abs(x - xd).max() <= 1e-12 * scale


def test_factor_tridiagonal_is_jax_s():
    from arnoldimethod_tpu.ops.tridiag import factor_tridiagonal as jfactor

    dl, d, du = _bands(50, 4)
    for a, b in zip(factor_tridiagonal(dl, d, du).arrays(),
                    jfactor(dl, d, du).arrays()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(np.linalg.LinAlgError):
        factor_tridiagonal(np.zeros(2), np.zeros(3), np.zeros(2))


@pytest.mark.parametrize("dtype,refine", [(None, None), (np.float32, None),
                                          (np.float32, False)],
                         ids=["f64", "f32_refine", "f32_plain"])
def test_tridiagonal_build_matches_jax(dtype, refine):
    n = 300
    dl, d, du = np.full(n - 1, -1.0), np.full(n, 2.0), np.full(n - 1, -1.001)
    jop = jam.TridiagonalShiftInvertOperator.build(dl, d, du, sigma=0.2,
                                                   dtype=dtype, refine=refine)
    top = tam.TridiagonalShiftInvertOperator.build(dl, d, du, sigma=0.2,
                                                   dtype=dtype, refine=refine)
    assert top.refine == jop.refine
    assert str(top.dtype).split(".")[-1] == str(jop.dtype)
    x = _vec(n, np.dtype(str(jop.dtype)), 9)
    _close(top.matvec(torch.from_numpy(x)).numpy(),
           jop.matvec(jnp.asarray(x)), 1e-12 if dtype is None else 1e-5)
    if dtype is not None:
        A = _tridiag_dense(dl, d, du) - 0.2 * np.eye(n)
        r = np.linalg.norm(A @ top.matvec(torch.from_numpy(x)).numpy()
                           .astype(np.float64) - x)
        assert r < (1e-4 if top.refine else 1e-2)


def test_tridiagonal_from_operator_real_and_complex():
    """A real DiaOperator, and a complex one (the port's
    dia_from_diagonals of complex values) where JAX takes a split-complex
    pair of DIA parts: the same solves."""
    n = 48
    jop = jam.TridiagonalShiftInvertOperator.from_operator(
        jp.tridiagonal(n, -1.0, 2.0, -1.001, fmt="dia"), sigma=0.3)
    top = tam.TridiagonalShiftInvertOperator.from_operator(
        tp.tridiagonal(n, -1.0, 2.0, -1.001), sigma=0.3)
    x = _vec(n, np.float64, 1)
    _close(top.matvec(torch.from_numpy(x)).numpy(),
           jop.matvec(jnp.asarray(x)), 1e-12)

    dl, d, du = _bands(n, 7, complex_=True, weak_diag=False)
    d = d + 3.0
    diags = {-1: np.concatenate([[0.0], dl]), 0: d,
             1: np.concatenate([du, [0.0]])}
    jsplit = jdia_from_diagonals(diags, (n, n))
    assert isinstance(jsplit, SplitComplexOperator)
    sigma = 0.4 + 0.1j
    jsi = jam.TridiagonalShiftInvertOperator.from_operator(jsplit, sigma=sigma)
    tdia = dia_from_diagonals(diags, (n, n))
    assert tdia.dtype == torch.complex128
    tsi = tam.TridiagonalShiftInvertOperator.from_operator(tdia, sigma=sigma)
    assert tsi.dtype == torch.complex128
    b = _vec(n, np.complex128, 2)
    _close(tsi.matvec(torch.from_numpy(b)).numpy(), jsi.matvec(jnp.asarray(b)),
           1e-12)
    np.testing.assert_allclose(
        tsi.matvec(torch.from_numpy(b)).numpy(),
        np.linalg.solve(_tridiag_dense(dl, d, du) - sigma * np.eye(n), b),
        rtol=1e-8, atol=1e-10)
    # complex64 diagonals give complex64 factors, as JAX's float32 words do.
    t64 = dia_from_diagonals(diags, (n, n), dtype=np.complex64)
    assert tam.TridiagonalShiftInvertOperator.from_operator(
        t64, sigma=sigma).dtype == torch.complex64
    with pytest.raises(ValueError, match="tridiagonal"):
        tam.TridiagonalShiftInvertOperator.from_operator(
            tp.laplacian_2d(4, 4))
    with pytest.raises(TypeError):
        tam.TridiagonalShiftInvertOperator.from_operator(tp.laplacian_2d(
            4, 4, fmt="stencil"))


def test_shift_invert_config4_float64_matches_jax():
    """The reference's config 4 (bench/partial_schur.jl:37-52): n = 6000
    tridiagonal (-1, 2, -1.001), sigma = 0, nev=10, :LM, tol=1e-7,
    mindim=11, maxdim=22, in float64 from the same v1: the same matvec
    count and eigenvalues as the JAX package."""
    n = 6000
    dl, d, du = np.full(n - 1, -1.0), np.full(n, 2.0), np.full(n - 1, -1.001)
    v1 = np.random.default_rng(1).standard_normal(n)
    kw = dict(nev=10, which="LM", tol=1e-7, mindim=11, maxdim=22,
              method="host")
    jd, jh = jam.partial_schur(
        jam.TridiagonalShiftInvertOperator.build(dl, d, du, sigma=0.0),
        v1=jnp.asarray(v1), **kw)
    td, th = tam.partial_schur(
        tam.TridiagonalShiftInvertOperator.build(dl, d, du, sigma=0.0),
        v1=v1, **kw)
    assert th.converged and th.nconverged == jh.nconverged == 10
    assert (th.mvproducts, th.restarts) == (jh.mvproducts, jh.restarts)
    # |theta| reaches 7.9e4: the Ritz values agree to 1e-10 relative.
    jw = np.asarray(jd.eigenvalues)
    assert np.abs(td.eigenvalues - jw).max() <= 1e-10 * np.abs(jw).max()
    exact = 2.0 + 2.0 * np.sqrt(1.001) * np.cos(
        np.arange(1, n + 1) * np.pi / (n + 1))
    lams = 1.0 / td.eigenvalues.real
    assert max(np.abs(exact - lam).min() for lam in lams) / 4.003 <= 1e-9


def test_convert_shift_invert_kinds():
    """JAX operators' arrays -> the port's operators -> the same matvecs:
    the dense LU (0-based pivots become 1-based), the tridiagonal factors
    and bands, and the circulant's inverse-symbol words."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((30, 30))
    jd = jam.ShiftInvertDenseOperator.build(jnp.asarray(A), 0.7)
    td = operator_from_arrays(
        "shift_invert_dense", {"lu": np.asarray(jd.lu), "piv": np.asarray(jd.piv)},
        {"sigma": jd.sigma, "shape": jd.shape})
    assert isinstance(td, tam.ShiftInvertDenseOperator)
    assert td.piv.min() >= 1
    x = _vec(30, np.float64, 4)
    _close(td.matvec(torch.from_numpy(x)).numpy(), jd.matvec(jnp.asarray(x)),
           1e-12)

    n = 200
    jt = jam.TridiagonalShiftInvertOperator.build(
        *_bands(n, 5), sigma=0.1, dtype=np.float32)
    names = ("l", "swap", "d0", "du1", "du2")
    arrays = {k: np.asarray(a) for k, a in zip(names, jt.factors)}
    arrays.update({k: np.asarray(a) for k, a in zip(("dl", "d", "du"),
                                                     jt.bands)})
    tt = operator_from_arrays(
        "tridiag_shift_invert", arrays,
        {"sigma": jt.sigma, "shape": jt.shape, "dtype": str(jt.dtype),
         "refine": jt.refine})
    assert isinstance(tt, tam.TridiagonalShiftInvertOperator) and tt.refine
    x = _vec(n, np.float32, 6)
    _close(tt.matvec(torch.from_numpy(x)).numpy(), jt.matvec(jnp.asarray(x)),
           1e-5)

    jop, _ = _periodic(8, np.float32)
    jc = jam.CirculantShiftInvertOperator.build(jop, 1.3)
    tc = operator_from_arrays(
        "circulant_shift_invert",
        {"inv_re": np.asarray(jc.inv_re), "inv_im": np.asarray(jc.inv_im)},
        {"grid": jc.grid, "sigma": jc.sigma, "dtype": str(jc.dtype)})
    assert isinstance(tc, tam.CirculantShiftInvertOperator)
    x = _vec(64, np.float32, 7)
    _close(tc.matvec(torch.from_numpy(x)).numpy(), jc.matvec(jnp.asarray(x)),
           1e-5)
