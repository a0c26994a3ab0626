"""partial_schur(..., extended=True) in the port against the JAX package,
and the two repairs that came with it (the default device, complex BSR).

Solves from one v1 with float32 words make the same matvec count as JAX's
(its compiled arithmetic differs from the port's only in low words, which
moves no restart decision on these problems).  float64 words run the host
dense layer in double-double; the oracle there is exact rational
arithmetic over (Q + Q_lo, R + R_lo), as in tests/test_dd.py.  The rest are
the port's analogues of tests/test_extended.py.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arnoldimethod_tpu as jam
import arnoldimethod_torch as tam
from arnoldimethod_tpu.models import problems as jp
from arnoldimethod_tpu.models.operators import (
    BsrOperator as JBsr,
    SplitComplexOperator,
)
from arnoldimethod_torch import _device, driver
from arnoldimethod_torch.convert import workspace_from_npz
from arnoldimethod_torch.models import problems as tp
from arnoldimethod_torch.models.operators import (
    BsrOperator,
    DenseOperator,
    DiaOperator,
)
from arnoldimethod_torch.ops import bsr
from arnoldimethod_torch.ops import df_expansion as tde
from arnoldimethod_torch.ops.expansion import LOWSYNC

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


def _lap(n):
    return (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1)
            + np.diag(np.full(n - 1, -1.0), -1))


def _v1(n, seed=11):
    return np.random.default_rng(seed).standard_normal(n)


# -- float32 words against JAX ---------------------------------------------


def test_readme_f32_words_same_count_as_jax():
    """laplacian_1d(100), nev=10, :SR, tol=1e-12: same matvec count as JAX
    from one v1, a Schur residual below 1e-11 in float64 (bench.py's
    limit), Q as the float64 combine of the two words, and one host read
    a restart."""
    kw = dict(nev=10, which="SR", tol=1e-12, extended=True, v1=_v1(100))
    jd, jh = jam.partial_schur(jp.laplacian_1d(100, dtype=np.float32), **kw)
    LOWSYNC.rollbacks = 0
    td, th = tam.partial_schur(tp.laplacian_1d(100, dtype=torch.float32), **kw)
    assert th.converged and jh.converged
    assert th.mvproducts == jh.mvproducts and th.restarts == jh.restarts
    Q = td.Q.numpy()
    assert Q.dtype == np.float64
    assert np.linalg.norm(_lap(100) @ Q - Q @ td.R) < 1e-11
    assert np.linalg.norm(Q.T @ Q - np.eye(10)) < 1e-11
    assert np.abs(np.sort(td.eigenvalues.real)
                  - np.sort(jd.eigenvalues.real)).max() < 1e-13
    # One read a range (H with the breakdown flags), one more a rollback.
    assert th.host_syncs == th.restarts + LOWSYNC.rollbacks


def test_partial_eigen_of_an_extended_result():
    """partial_eigen takes the float64 Q of an extended solve, as the JAX
    package's does: float64 eigenvectors."""
    d, _ = tam.partial_schur(tp.laplacian_1d(64, dtype=torch.float32), nev=4,
                             which="SR", tol=1e-11, extended=True, v1=_v1(64))
    vals, X = tam.partial_eigen(d)
    assert X.dtype == torch.float64
    Xn = X.numpy()
    assert np.linalg.norm(_lap(64) @ Xn - Xn * vals) < 1e-10


# -- float64 words: the double-double host layer ---------------------------


def _frac(hi, lo):
    out = np.empty(hi.shape, dtype=object)
    for idx in np.ndindex(hi.shape):
        out[idx] = Fraction(float(hi[idx])) + Fraction(float(lo[idx]))
    return out


def _exact_residual(d):
    Qf = _frac(d.Q.numpy(), d.Q_lo.numpy())
    Rf = _frac(np.asarray(d.R), np.asarray(d.R_lo))
    AQ = 2 * Qf
    AQ[:-1] -= Qf[1:]
    AQ[1:] -= Qf[:-1]
    resid = float(sum(v * v for v in (AQ - Qf @ Rf).ravel())) ** 0.5
    G = Qf.T @ Qf
    for i in range(G.shape[0]):
        G[i, i] -= 1
    return resid, max(abs(float(v)) for v in G.ravel())


def test_dd_small_config_exact_residual():
    """laplacian_1d(40), float64 words, nev=4, :SR, tol=1e-24: converged,
    exact-rational Schur residual below tol and orthonormality at the
    double-double level."""
    d, h = tam.partial_schur(tp.laplacian_1d(40, dtype=torch.float64), nev=4,
                             which="SR", tol=1e-24, extended=True, v1=_v1(40))
    assert h.converged and h.dense_layer == "numpy"
    resid, orth = _exact_residual(d)
    assert resid < 1e-24 and orth < 1e-28
    assert isinstance(d.Q_lo, torch.Tensor) and d.Q_lo.shape == d.Q.shape
    assert d.R_lo.shape == d.R.shape


# -- the analogues of tests/test_extended.py -------------------------------


def test_warm_start_keeps_the_low_word():
    n = 80
    op = tp.laplacian_1d(n, dtype=torch.float32)
    ws = tam.ArnoldiWorkspace(n, 20, dtype=torch.float32)
    d1, h1 = tam.partial_schur(op, nev=4, which="SR", tol=1e-11,
                               extended=True, workspace=ws, v1=_v1(n))
    assert h1.converged and ws.Vlo is not None
    d2, h2 = tam.partial_schur(op, nev=8, which="SR", tol=1e-11,
                               extended=True, workspace=ws,
                               start_from=h1.nconverged)
    assert h2.converged
    Q = d2.Q.numpy()
    assert np.linalg.norm(_lap(n) @ Q - Q @ d2.R) < 1e-9
    assert np.linalg.norm(Q.T @ Q - np.eye(Q.shape[1])) < 1e-9
    # A plain solve on the same workspace invalidates the low word.
    tam.partial_schur(op, nev=4, which="SR", tol=1e-6, workspace=ws,
                      start_from=0, initialize=True)
    assert ws.Vlo is None


def test_fallback_without_matvec_df():
    """An operator without matvec_df takes two plain matvecs: the solve
    runs, floored at the single-word matvec's accuracy."""
    A = _lap(48).astype(np.float32)
    op = DenseOperator(A)
    assert not hasattr(op, "matvec_df")
    d, h = tam.partial_schur(op, nev=4, which="SR", tol=1e-6, extended=True,
                             v1=_v1(48))
    assert h.converged
    Q = d.Q.numpy()
    assert np.linalg.norm(A.astype(np.float64) @ Q - Q @ d.R) < 1e-5


def test_extended_rejects_complex_device_and_lowsync():
    op = tp.laplacian_1d(32, dtype=torch.complex128)
    with pytest.raises(ValueError, match="real dtypes"):
        tam.partial_schur(op, nev=2, extended=True)
    op2 = tp.laplacian_1d(32, dtype=torch.float32)
    with pytest.raises(ValueError, match="method='device'"):
        tam.partial_schur(op2, nev=2, extended=True, method="device")
    with pytest.raises(ValueError, match="lowsync"):
        tam.partial_schur(op2, nev=2, extended=True, lowsync=True)


def test_exact_breakdown_reinit():
    """v1 an eigenvector of a diagonal matrix: the double-word DGKS sees the
    exact zero residual as breakdown (df_norm(0) is 0, not NaN) and
    reinitializes."""
    n = 32
    diag = np.linspace(1.0, 4.0, n).astype(np.float32)
    op = DiaOperator(diag[None, :], (0,), (n, n))
    e1 = np.zeros(n, np.float32)
    e1[0] = 1.0
    LOWSYNC.rollbacks = 0
    d, h = tam.partial_schur(op, nev=2, which="LM", v1=e1, tol=1e-10,
                             extended=True)
    assert h.converged and h.nconverged >= 2
    assert LOWSYNC.rollbacks >= 1  # the first step, found after its range
    assert np.allclose(np.sort(d.eigenvalues.real)[-2:], np.sort(diag)[-2:],
                       atol=1e-9)


def test_low_words_save_and_load_between_packages(tmp_path):
    """A double-double checkpoint written by the JAX package (Vlo, Hlo)
    loads in the port with both words, resumes there at double-double
    accuracy, and the port's checkpoint loads back in JAX.  The JAX
    workspace holds the state of a double-double solve (made by the port,
    which is cheaper here than a compiled JAX solve)."""
    n = 40
    op = tp.laplacian_1d(n, dtype=torch.float64)
    src = tam.ArnoldiWorkspace(n, 16, dtype=torch.float64)
    tam.partial_schur(op, workspace=src, nev=2, which="SR", tol=1e-20,
                      mindim=8, maxdim=16, extended=True, v1=_v1(n))
    jws = jam.ArnoldiWorkspace(n, 16, dtype=np.float64, V=src.V.numpy(),
                               H=src.H)
    jws.Vlo, jws.Hlo = jnp.asarray(src.Vlo.numpy()), src.Hlo.copy()
    path = tmp_path / "jax.npz"
    jws.save(path)
    ws = workspace_from_npz(path)
    np.testing.assert_array_equal(ws.Vlo.numpy(), np.asarray(jws.Vlo))
    np.testing.assert_array_equal(ws.Hlo, jws.Hlo)
    d, h = tam.partial_schur(op, workspace=ws, nev=4, which="SR", tol=1e-20,
                             mindim=8, maxdim=16, extended=True, start_from=2)
    assert h.converged and ws.Hlo is not None
    assert _exact_residual(d)[0] < 1e-19
    back = tmp_path / "port.npz"
    ws.save(back)
    jback = jam.ArnoldiWorkspace.load(back)
    np.testing.assert_array_equal(np.asarray(jback.Vlo), ws.Vlo.numpy())
    np.testing.assert_array_equal(jback.Hlo, ws.Hlo)
    np.testing.assert_array_equal(np.asarray(jback.V), ws.V.numpy())


# -- the two repairs -------------------------------------------------------


def test_device_helper_resolves_none_to_the_card_without_allocating(monkeypatch):
    monkeypatch.setattr(_device, "DEFAULT", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _device.resolve(None) == torch.device("cuda")
    assert not torch.cuda.is_initialized()
    assert _device.resolve("cpu") == torch.device("cpu")
    assert _device.resolve(None, like=torch.zeros(1)) == torch.device("cpu")
    assert _device.resolve(None, like=np.zeros(1)) == torch.device("cuda")


def test_default_device_without_a_card_names_the_cpu(monkeypatch):
    monkeypatch.setattr(_device, "DEFAULT", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tp.laplacian_1d(10)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tam.partial_schur(_lap(10), nev=2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tam.ArnoldiWorkspace(10, 4)
    # Asked for, or given a tensor, the CPU is fine.
    assert tp.laplacian_1d(10, device="cpu").device.type == "cpu"
    assert DenseOperator(torch.eye(3)).device.type == "cpu"
    assert tam.ArnoldiWorkspace(3, 2, V=torch.zeros(3, 3)).device.type == "cpu"


def _complex_blocks(rng, nbr=6, KB=3, B=8):
    cols = np.stack([np.sort(rng.choice(nbr, KB, replace=False)) for _ in range(nbr)])
    re = rng.standard_normal((nbr, KB, B, B))
    im = rng.standard_normal((nbr, KB, B, B))
    return cols.astype(np.int32), re, im


@pytest.mark.parametrize("with_imaginary", [True, False])
def test_complex_bsr_runs_the_real_matvec_on_two_words(monkeypatch, with_imaginary):
    """A complex BsrOperator equals JAX's SplitComplexOperator over two real
    BsrOperators (matvec_sc), within test_torch_bsr.py's float64 tolerance;
    the real matvec runs on (re, xr), (re, xi), then (im, xi), (im, xr),
    and the last two are skipped when the imaginary blocks are zero."""
    rng = np.random.default_rng(9)
    cols, re, im = _complex_blocks(rng)
    if not with_imaginary:
        im[:] = 0
    n = 6 * 8
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    jop = SplitComplexOperator(
        JBsr(cols, re, (n, n), use_pallas=False),
        JBsr(cols, im, (n, n), use_pallas=False) if with_imaginary else None)
    yr, yi = jop.matvec_sc(jnp.asarray(x.real), jnp.asarray(x.imag))
    calls = []
    real = bsr.bsr_matvec

    def spy(cols_, dataT, v, logical_blocks=None):
        calls.append((dataT.data_ptr(), v.data_ptr()))
        return real(cols_, dataT, v, logical_blocks)

    monkeypatch.setattr(bsr, "bsr_matvec", spy)
    top = BsrOperator(cols, re + 1j * im, (n, n))
    y = top.matvec(torch.from_numpy(x))
    assert y.dtype == torch.complex128
    assert np.abs(y.numpy() - (np.asarray(yr) + 1j * np.asarray(yi))).max() <= 1e-10
    w_re, w_im = top.words
    assert (w_im is None) == (not with_imaginary)
    assert [d for d, _ in calls] == ([w_re.data_ptr()] * 2 + [w_im.data_ptr()] * 2
                                     if with_imaginary else [w_re.data_ptr()] * 2)
    # use_pallas=False keeps the plain complex version.
    calls.clear()
    y_plain = BsrOperator(cols, re + 1j * im, (n, n), use_pallas=False).matvec(
        torch.from_numpy(x))
    assert not calls
    assert np.abs(y_plain.numpy() - y.numpy()).max() <= 1e-10


def _stepwise_range(op, Vh, Vl, Hh, Hl, j0, j1, generator):
    """df_expand_range's interface over the host-decided stepwise range."""
    reads = tde.df_expand_range_stepwise(op, Vh, Vl, Hh, Hl, j0, j1,
                                         generator)
    return (Hh.numpy().copy(), Hl.numpy().copy()), reads


@pytest.mark.parametrize("case", ["config3_16", "dd_lap40"])
def test_solve_is_the_stepwise_solve(monkeypatch, case):
    """A whole extended solve, the range with one read a restart against
    the same solve with the host-decided stepwise range swapped in: the
    same counts and the same bits of Q, R and the eigenvalues.  Config 3's
    operator at 16 x 16 (float32 words, 11 restarts) split in one low word
    of H while the CPU's plain df_sqrt was not correctly rounded; float64
    words run the double-double host layer."""
    if case == "config3_16":
        op = tp.convection_diffusion_2d(16, peclet=68.0, dtype=torch.float32,
                                        fmt="stencil")
        kw = dict(nev=10, which="LM", tol=1e-6, mindim=30, maxdim=60,
                  restarts=1000,
                  v1=np.random.default_rng(3).standard_normal(256))
    else:
        op = tp.laplacian_1d(40, dtype=torch.float64)
        kw = dict(nev=4, which="SR", tol=1e-24, v1=_v1(40))
    out = []
    for stepwise in (False, True):
        if stepwise:
            monkeypatch.setattr(driver, "df_expand_range", _stepwise_range)
            monkeypatch.setattr(tde, "df_expand_range", _stepwise_range)
        d, h = tam.partial_schur(op, extended=True, **kw)
        out.append((d, h))
    (d1, h1), (d2, h2) = out
    assert h1.converged and (h1.mvproducts, h1.restarts) == (
        h2.mvproducts, h2.restarts)
    assert h1.host_syncs == h1.restarts < h2.host_syncs
    for a, b in ((d1.Q.numpy(), d2.Q.numpy()), (d1.R, d2.R),
                 (d1.eigenvalues, d2.eigenvalues)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
