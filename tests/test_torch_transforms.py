"""The port's Chebyshev filter, interval bootstrap and Rayleigh-Ritz
back-map (arnoldimethod_torch/transforms.py) against the JAX package's, on
the same numpy-seeded inputs, on the CPU.

On the CPU the filter's fused stencil step takes its plain version
(`stencil5_cheb_plain`); the CUDA kernel it launches on a card is compared
with that plain version by chip_smoke.py.  Tolerances:

  * filter matvecs: 8 * degree * eps(dtype) * max|y|.  Both packages take
    the same steps in the same order; XLA and torch round the five-term
    stencil sum and the dense GEMV differently by a few ulps, and each of
    the `degree` steps re-rounds;
  * one Chebyshev step: 8 * eps * (|p| |inv_e| (sum|coeff| + |c|) max|x|
    + |q| max|z|), a few roundings of each term;
  * Rayleigh-Ritz in float64: eigenvalues 1e-12, vectors and residuals
    1e-10 (both packages solve the same small eigenproblem with the same
    host code; only the n-sized sums differ in order);
  * the interval: the random streams differ (jax.random against
    torch.Generator), so the port's interval is held to properties of the
    spectrum and to within a stated distance of JAX's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import arnoldimethod_tpu as jam
import arnoldimethod_torch as tam
from arnoldimethod_tpu import transforms as jtr
from arnoldimethod_tpu.models import problems as jp
from arnoldimethod_tpu.models.operators import (
    DenseOperator as JDense,
    Stencil5Operator as JStencil,
)
from arnoldimethod_torch import transforms as ttr
from arnoldimethod_torch.convert import operator_from_arrays
from arnoldimethod_torch.models import problems as tp
from arnoldimethod_torch.models.operators import (
    DenseOperator,
    FunctionOperator,
    Stencil5Operator,
)
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
GRID = (24, 20)
TDTYPE = {np.float32: torch.float32, np.float64: torch.float64}


def _laplace_exact(nx, nev):
    lam1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    return np.sort(np.add.outer(lam1, lam1).ravel())[:nev]


def _ops(kind, dtype):
    """The same operator in both packages: a Dirichlet or periodic 24 x 20
    Laplacian stencil, or a dense symmetric 480 x 480 matrix."""
    if kind == "dense":
        rng = np.random.default_rng(5)
        A = rng.standard_normal((480, 480)) / 40
        A = ((A + A.T) / 2 + np.diag(np.linspace(0, 4, 480))).astype(dtype)
        return JDense(jnp.asarray(A)), DenseOperator(A)
    return (JStencil(LAPLACE, GRID, dtype=dtype, boundary=kind),
            Stencil5Operator(LAPLACE, GRID, dtype=TDTYPE[dtype],
                             boundary=kind))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["dirichlet", "periodic", "dense"])
@pytest.mark.parametrize("degree", [1, 7, 60])
@pytest.mark.parametrize("scale_point", [None, 0.1], ids=["unscaled", "scaled"])
def test_filter_matvec_matches_jax(scale_point, degree, kind, dtype):
    jop, top = _ops(kind, dtype)
    x = np.random.default_rng(degree).standard_normal(480).astype(dtype)
    want = np.asarray(jam.ChebyshevFilterOperator(
        jop, 1.0, 8.5, degree, scale_point=scale_point).matvec(jnp.asarray(x)))
    fop = tam.ChebyshevFilterOperator(top, 1.0, 8.5, degree,
                                      scale_point=scale_point)
    got = fop.matvec(torch.from_numpy(x))
    assert got.dtype == TDTYPE[dtype] and got.shape == (480,)
    bound = 8 * degree * np.finfo(dtype).eps * np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= bound


def test_filter_step_coefficients_are_the_jax_carry():
    """p = 2 sigma', q = sigma sigma' with sigma carried in float32, as the
    JAX loop carries it; float64 keeps the float64 values."""
    fop = tam.ChebyshevFilterOperator(tp.laplacian_2d(4, 4, fmt="stencil",
                                                      dtype=torch.float32),
                                      0.5, 8.0, 5, scale_point=0.2)
    c, e = 4.25, 3.75
    t0v = (0.2 - c) / e
    sig = np.float32(1.0 / t0v)
    assert fop.first == float(sig)
    for p, q in fop.steps:
        sig_next = np.float32(1.0) / (np.float32(2.0 * t0v) - sig)
        assert (p, q) == (float(np.float32(2) * sig_next),
                          float(sig * sig_next))
        sig = sig_next
    unscaled = tam.ChebyshevFilterOperator(np.eye(3), 0.5, 8.0, 4)
    assert unscaled.first == 1.0 and unscaled.steps == [(2.0, 1.0)] * 3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cheb_step_plain_matches_jax_step(dtype):
    """stencil5_cheb_plain against JAX's step arithmetic
    p * ((A x - c x) * (1/e)) - q * z on the XLA stencil, with and without
    z, and with the output written over z."""
    rng = np.random.default_rng(7)
    x, z = (rng.standard_normal(480).astype(dtype) for _ in range(2))
    a, b = 0.3, 8.2
    c, e = (a + b) / 2, (b - a) / 2
    p, q = float(dtype(-1.93)), float(dtype(0.97))
    jop = JStencil(LAPLACE, GRID, dtype=dtype, use_pallas=False)
    jL = (jop.matvec(jnp.asarray(x)) - c * jnp.asarray(x)) * (1.0 / e)
    want_q = np.asarray(p * jL - q * jnp.asarray(z))
    want_0 = np.asarray(p * jL)
    eps = np.finfo(dtype).eps
    smax = sum(abs(v) for v in LAPLACE) + abs(c)
    bound = 8 * eps * (abs(p) / e * smax * np.abs(x).max()
                       + abs(q) * np.abs(z).max())
    xt, zt = torch.from_numpy(x), torch.from_numpy(z.copy())
    kw = dict(coeffs=LAPLACE, grid=GRID, c=c, inv_e=1.0 / e)
    y0 = stencil.stencil5_cheb_step(xt, None, p=p, q=0.0, **kw)
    yq = stencil.stencil5_cheb_step(xt, zt, p=p, q=q, **kw)
    assert np.abs(y0.numpy() - want_0).max() <= bound
    assert np.abs(yq.numpy() - want_q).max() <= bound
    y_alias = stencil.stencil5_cheb_step(xt, zt, p=p, q=q, out=zt, **kw)
    assert y_alias is zt
    np.testing.assert_array_equal(zt.numpy(), yq.numpy())
    np.testing.assert_array_equal(
        stencil.stencil5_cheb_plain(xt, None, LAPLACE, GRID, c, 1.0 / e, p, 0.0)
        .numpy(), y0.numpy())


def test_cheb_step_rejects_bad_output():
    x = torch.ones(32)
    z = torch.ones(32)
    kw = dict(coeffs=LAPLACE, grid=(4, 8), c=1.0, inv_e=1.0, p=2.0)
    with pytest.raises(ValueError, match="not be x"):
        stencil.stencil5_cheb_step(x, z, q=1.0, out=x, **kw)
    with pytest.raises(ValueError, match="z itself"):
        buf = torch.ones(40)
        stencil.stencil5_cheb_step(x, buf[:32], q=1.0, out=buf[8:], **kw)
    with pytest.raises(ValueError, match="q == 0"):
        stencil.stencil5_cheb_step(x, None, q=1.0, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        stencil.stencil5_cheb_step(torch.ones(64)[::2], None, q=0.0, **kw)
    with pytest.raises(ValueError, match="cpu or cuda"):
        stencil.stencil5_cheb_step(torch.ones(32, device="meta"), None,
                                   q=0.0, **kw)
    # The card-side wrapper checks dtype and sizes before building.
    with pytest.raises(TypeError):
        stencil._Stencil5Kernel().cheb(x.half(), None, LAPLACE, (4, 8), 1.0,
                                       1.0, 2.0, 0.0)
    with pytest.raises(ValueError):
        stencil._Stencil5Kernel().cheb(x, torch.ones(31), LAPLACE, (4, 8),
                                       1.0, 1.0, 2.0, 1.0)


def test_filter_takes_the_fused_step_and_leaves_the_basis_untouched(
        monkeypatch):
    """A real Dirichlet stencil filter goes through stencil5_cheb_step once
    per degree; the caller's vector (a row of a Krylov basis V) is never
    written, and from y_3 on each step writes over y_{k-1}."""
    calls = []
    real = stencil.stencil5_cheb_step

    def spy(x, z, **kw):
        calls.append((x.data_ptr(), None if z is None else z.data_ptr(),
                      None if kw.get("out") is None else kw["out"].data_ptr()))
        return real(x, z, **kw)

    monkeypatch.setattr(stencil, "stencil5_cheb_step", spy)
    op = Stencil5Operator(LAPLACE, GRID, dtype=torch.float64)
    V = torch.from_numpy(np.random.default_rng(3).standard_normal((3, 480)))
    V0 = V.clone()
    fop = tam.ChebyshevFilterOperator(op, 1.0, 8.5, 9, scale_point=0.1)
    y = fop.matvec(V[1])
    assert torch.equal(V, V0)
    assert len(calls) == 9
    row = V[1].data_ptr()
    assert all(out != row for _, _, out in calls)
    assert calls[0][2] is None and calls[1][2] is None  # y_1, y_2 fresh
    assert all(out == z for _, z, out in calls[2:])  # then over y_{k-1}
    np.testing.assert_allclose(
        y.numpy(),
        tam.ChebyshevFilterOperator(
            Stencil5Operator(LAPLACE, GRID, dtype=torch.float64,
                             use_pallas=False),
            1.0, 8.5, 9, scale_point=0.1).matvec(V0[1]).numpy(),
        rtol=0, atol=1e-13)
    # Periodic, use_pallas=False and complex inputs take the generic path.
    calls.clear()
    for inner in (Stencil5Operator(LAPLACE, GRID, boundary="periodic"),
                  Stencil5Operator(LAPLACE, GRID, use_pallas=False)):
        tam.ChebyshevFilterOperator(inner, 1.0, 8.5, 3).matvec(
            torch.ones(480))
    tam.ChebyshevFilterOperator(Stencil5Operator(LAPLACE, GRID), 1.0, 8.5,
                                3).matvec(torch.ones(480, dtype=torch.complex64))
    assert not calls


def test_filter_operator_surface():
    periodic = tp.convection_diffusion_periodic_2d(8, cx=0.15, cy=0.08,
                                                   scale=0.13)
    fop = tam.ChebyshevFilterOperator(periodic, 0.5, 1.5, 4, scale_point=0.01)
    assert fop.op.boundary == "periodic" and fop.op is periodic
    assert (fop.shape, fop.dtype, fop.device) == (
        (64, 64), torch.float32, torch.device("cpu"))
    with pytest.raises(ValueError, match="degree"):
        tam.ChebyshevFilterOperator(periodic, 0.5, 1.5, 0)
    raw = tam.ChebyshevFilterOperator([[2.0, -1.0], [-1.0, 2.0]], 1.0, 4.0, 3)
    assert raw.shape == (2, 2) and raw.matvec(
        torch.ones(2, dtype=torch.float64)).shape == (2,)


def test_power_bound_matches_jax_and_bounds_the_spectrum():
    """Random starts differ between the packages; with a well-separated
    dominant eigenvalue both converge to it within 1e-3 relative."""
    rng = np.random.default_rng(3)
    A = np.diag(np.linspace(0.1, 2.0, 60))
    A[0, 0] = 5.0
    Qm, _ = np.linalg.qr(rng.standard_normal((60, 60)))
    A = Qm @ A @ Qm.T
    b_t = tam.power_bound(A, iters=30)
    b_j = jam.power_bound(jnp.asarray(A), iters=30)
    assert 5.0 * 1.05 * (1 - 1e-3) <= b_t <= 5.0 * 1.05 * (1 + 1e-6)
    assert abs(b_t - b_j) <= 1e-3 * b_j
    assert tam.power_bound(A, iters=0) == 1.05
    # A complex operator: the norm is real.
    C = (rng.standard_normal((40, 40))
         + 1j * rng.standard_normal((40, 40))).astype(np.complex128)
    rho = np.max(np.abs(np.linalg.eigvals(C)))
    b = tam.power_bound(C, iters=30)
    assert isinstance(b, float) and rho * 0.99 <= b < rho * 3.0
    assert abs(b - jam.power_bound(jnp.asarray(C), iters=30)) <= 0.5 * rho


def test_dense_eig_and_hessenberg_host_are_jax_s():
    """The host helpers are the JAX package's code on the same dense layer:
    bitwise equal outputs."""
    rng = np.random.default_rng(11)
    for S in (rng.standard_normal((12, 12)),
              rng.standard_normal((7, 7)) + 1j * rng.standard_normal((7, 7)),
              np.diag(np.arange(1.0, 6.0)), np.zeros((0, 0))):
        for name in ("_dense_eig_host", "_hessenberg_host"):
            if name == "_hessenberg_host" and S.size == 0:
                continue
            got = getattr(ttr, name)(S)
            want = getattr(jtr, name)(S)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        w, V = ttr._dense_eig_host(S)
        if S.size:
            assert np.linalg.norm(S @ V - V * w[None, :]) < 1e-10 * (
                1 + np.abs(w).max())


def _rr_case(kind):
    """(JAX op, port op, Q (n, k) float64): a symmetric 1-D Laplacian (real
    Ritz values), the periodic convection-diffusion circulant on a real
    basis (complex Ritz pairs), and the same circulant on a complex
    basis."""
    rng = np.random.default_rng(2)
    if kind == "symmetric":
        jop, top = jp.laplacian_1d(60), tp.laplacian_1d(60)
        Q, _ = np.linalg.qr(rng.standard_normal((60, 8)))
        return jop, top, Q
    jop = jp.convection_diffusion_periodic_2d(8, cx=0.15, cy=0.08, scale=0.13,
                                              dtype=np.float64)
    top = tp.convection_diffusion_periodic_2d(8, cx=0.15, cy=0.08, scale=0.13,
                                              dtype=torch.float64)
    if kind == "complex_basis":
        M = rng.standard_normal((64, 9)) + 1j * rng.standard_normal((64, 9))
    else:
        # Near an invariant subspace holding complex pairs: the real and
        # imaginary parts of four eigenvectors, slightly perturbed.
        A = np.stack([top.matvec(torch.from_numpy(e)).numpy()
                      for e in np.eye(64)], axis=1)
        lam, W = np.linalg.eig(A)
        pick = np.flatnonzero(lam.imag > 1e-3)[:4]
        M = np.concatenate([W[:, pick].real, W[:, pick].imag,
                            rng.standard_normal((64, 1))], axis=1)
        M = M + 1e-3 * rng.standard_normal(M.shape)
    Q, _ = np.linalg.qr(M)
    return jop, top, Q


def _same_columns(jX, tX, tol):
    """Unit Ritz vectors agree up to a unit-modulus factor per column."""
    phase = np.sum(np.conj(jX) * tX, axis=0) / np.sum(np.abs(jX) ** 2, axis=0)
    assert np.abs(np.abs(phase) - 1).max() <= tol
    assert np.abs(jX * phase - tX).max() <= tol


@pytest.mark.parametrize("kind", ["symmetric", "complex_pairs",
                                  "complex_basis"])
@pytest.mark.parametrize("rows_layout", [False, True], ids=["cols", "rows"])
@pytest.mark.parametrize("vectors,residuals", [(True, True), (True, False),
                                               (False, True), (False, False)],
                         ids=["vec_res", "vec", "res", "values"])
def test_rayleigh_ritz_matches_jax(kind, rows_layout, vectors, residuals):
    jop, top, Q = _rr_case(kind)
    Qj = jnp.asarray(Q.T if rows_layout else Q)
    Qt = torch.from_numpy(np.ascontiguousarray(Q.T) if rows_layout else Q)
    kw = dict(rows_layout=rows_layout, return_vectors=vectors,
              compute_residuals=residuals, chunk=3)
    jw, jX, jres = jam.rayleigh_ritz(jop, Qj, **kw)
    tw, tX, tres = tam.rayleigh_ritz(top, Qt, **kw)
    jw = np.asarray(jw)
    assert tw.dtype == jw.dtype and tw.shape == jw.shape
    assert np.abs(tw - jw).max() <= 1e-12
    if kind == "complex_pairs":
        assert np.iscomplexobj(tw) and np.abs(tw.imag).max() > 1e-3
    if residuals:
        assert np.abs(tres - np.asarray(jres)).max() <= 1e-10
        assert np.all(np.isfinite(tres)) and tres.shape == (tw.size,)
    else:
        assert tres is None
    if vectors:
        assert tX.shape == tuple(np.shape(jX))
        assert tX.is_complex() == (kind != "symmetric")
        jXc = np.asarray(jX)
        tXc = tX.numpy()
        if rows_layout:
            jXc, tXc = jXc.T, tXc.T
        _same_columns(jXc, tXc, 1e-10)
        # The Ritz pairs satisfy the residuals the function reports.
        full = tam.rayleigh_ritz(top, Qt, rows_layout=rows_layout)
        R = np.stack([top.matvec(torch.from_numpy(tXc[:, j].real.copy()))
                      .numpy()
                      + 1j * top.matvec(torch.from_numpy(
                          tXc[:, j].imag.copy())).numpy()
                      for j in range(tXc.shape[1])], axis=1) - tXc * tw[None, :]
        np.testing.assert_allclose(np.linalg.norm(R, axis=0), full[2],
                                   rtol=1e-8, atol=1e-13)
    else:
        assert tX is None


def test_rayleigh_ritz_float32_chunks_and_strided_columns():
    """Columns layout hands the stencil strided rows: each is made
    contiguous (the kernel's wrapper would raise on them)."""
    jop = JStencil(LAPLACE, GRID, dtype=np.float32)
    top = Stencil5Operator(LAPLACE, GRID, dtype=torch.float32)
    Q, _ = np.linalg.qr(np.random.default_rng(4).standard_normal((480, 10)))
    Q = Q.astype(np.float32)
    jw, jX, jres = jam.rayleigh_ritz(jop, jnp.asarray(Q), chunk=4)
    tw, tX, tres = tam.rayleigh_ritz(top, torch.from_numpy(Q), chunk=4)
    assert tX.dtype == torch.float32 and tX.shape == (480, 10)
    assert np.abs(tw - np.asarray(jw)).max() <= 1e-5
    assert np.abs(tres - np.asarray(jres)).max() <= 1e-5
    _same_columns(np.asarray(jX, np.float64), tX.double().numpy(), 1e-4)


def test_estimate_interval_validates_which_before_device_work():
    calls = []

    def mv(x):
        calls.append(1)
        return x

    op = FunctionOperator(mv, 64, torch.float64)
    with pytest.raises(ValueError, match="SR"):
        tam.estimate_interval(op, nev=4, which="lm")
    assert not calls


@pytest.fixture(scope="module")
def laplace32():
    """The 32 x 32 float64 Laplacian stencil in both packages and JAX's
    interval for nev=8 (a small coarse pass and a (20, 40) ramp)."""
    jop = jp.laplacian_2d(32, 32, fmt="stencil")
    top = tp.laplacian_2d(32, 32, fmt="stencil", dtype=torch.float64)
    iv = jam.estimate_interval(jop, nev=8, maxdim=24, refine_degree=(20, 40))
    return jop, top, iv


def test_estimate_interval_sr_properties_and_jax_distance(laplace32):
    jop, top, jiv = laplace32
    exact = _laplace_exact(32, 1024)
    iv = tam.estimate_interval(top, nev=8, maxdim=24, refine_degree=(20, 40))
    assert isinstance(iv, ttr.Interval)
    assert iv.b >= exact[-1]               # a true spectral upper bound
    assert exact[7] < iv.a < iv.b          # the wanted band below a
    assert exact[0] <= iv.lo <= 1.05 * exact[0]  # Ritz values interlace
    # Within a stated distance of JAX's interval (other random draws).
    assert abs(iv.b - jiv.b) <= 0.01 * jiv.b
    assert abs(iv.a - jiv.a) <= 0.1 * jiv.a
    assert abs(iv.lo - jiv.lo) <= 0.01 * jiv.lo
    # Seeded: the same call gives the same interval.
    assert tam.estimate_interval(top, nev=8, maxdim=24,
                                 refine_degree=(20, 40)) == iv


def test_estimate_interval_lm_properties():
    """The mirrored recipe on the symmetric periodic Laplacian (spectrum
    [0, 8 s]): the damped interval covers the bottom, the scale point sits
    at the top edge.  JAX's own test of this path runs degrees 100-300 and
    is slow; here both packages run a (20, 40) ramp on a 16 x 16 grid."""
    s = 0.13
    jop = jp.convection_diffusion_periodic_2d(16, cx=0.0, cy=0.0, scale=s,
                                              dtype=np.float64)
    top = tp.convection_diffusion_periodic_2d(16, cx=0.0, cy=0.0, scale=s,
                                              dtype=torch.float64)
    kw = dict(nev=6, which="LM", refine_degree=(20, 40), maxdim=24)
    iv = tam.estimate_interval(top, **kw)
    jiv = jam.estimate_interval(jop, **kw)
    top_edge = 8 * s
    assert iv.a <= 0.01 and iv.a < iv.b < iv.lo
    assert abs(iv.lo - top_edge) <= 0.01 * top_edge
    assert abs(iv.lo - jiv.lo) <= 0.01 * top_edge
    assert abs(iv.b - jiv.b) <= 0.05 * top_edge


def test_filtered_solve_matches_jax(laplace32):
    """The slice as a whole: JAX's (a, b, lo), the same v1, a degree-20
    scaled filter, partial_schur(nev=8, :LM) and the rows-layout
    rayleigh_ritz back-map.  float64: the same matvec and restart counts,
    eigenvalues within 1e-10 of JAX's and of the analytic spectrum."""
    jop, top, iv = laplace32
    v1 = np.random.default_rng(11).standard_normal(1024)
    kw = dict(nev=8, which="LM", tol=1e-10, method="host")
    jd, jh = jam.partial_schur(
        jam.ChebyshevFilterOperator(jop, iv.a, iv.b, 20, scale_point=iv.lo),
        v1=jnp.asarray(v1), **kw)
    jw, _, jres = jam.rayleigh_ritz(jop, jd.Q_rows, rows_layout=True,
                                    return_vectors=False)
    fop = tam.ChebyshevFilterOperator(top, iv.a, iv.b, 20, scale_point=iv.lo)
    td, th = tam.partial_schur(fop, v1=v1, **kw)
    tw, tX, tres = tam.rayleigh_ritz(top, td.Q_rows, rows_layout=True,
                                     return_vectors=False)
    assert th.converged and th.nconverged == jh.nconverged == 8
    assert (th.mvproducts, th.restarts) == (jh.mvproducts, jh.restarts)
    assert tX is None
    assert np.abs(tw - np.asarray(jw)).max() <= 1e-10
    assert np.abs(tw - _laplace_exact(32, 8)).max() <= 1e-10
    assert tres.max() <= 1e-9 and np.abs(tres - np.asarray(jres)).max() <= 1e-10


def test_convert_chebyshev_kind():
    """A JAX filter's parameters and inner stencil arrays build the port's
    filter, which gives the same matvec."""
    jst = JStencil(LAPLACE, GRID, dtype=np.float64)
    jf = jam.ChebyshevFilterOperator(jst, 0.4, 8.1, 12, scale_point=0.05)
    tf = operator_from_arrays(
        "chebyshev", {"coeffs": np.asarray(jst.coeffs)},
        {"op_kind": "stencil",
         "op_meta": {"grid": jst.grid, "boundary": jst.boundary,
                     "dtype": "float64"},
         "a": jf.a, "b": jf.b, "degree": jf.degree,
         "scale_point": jf.scale_point})
    assert isinstance(tf, tam.ChebyshevFilterOperator)
    x = np.random.default_rng(1).standard_normal(480)
    want = np.asarray(jf.matvec(jnp.asarray(x)))
    got = tf.matvec(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 8 * 12 * np.finfo(float).eps * np.abs(
        want).max()
