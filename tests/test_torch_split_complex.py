"""The port's split-complex API (partial_schur(..., split_complex=True),
SplitComplexOperator, SplitComplexDenseOperator, `Vim` checkpoints)
against the JAX package's split-complex path, in float64 from the same
start vector.

The port runs split_complex=True on the native complex host path (the
card has complex arithmetic), where JAX carries the basis as real (re, im)
words; both run the same DGKS decisions, so the matvec counts are equal,
eigenvalues agree to 1e-10 and Q spans the same subspace to 1e-8 (as in
tests/test_torch_partial_schur.py).  Operator products agree to 1e-13
relative (the same real products, summed in different orders)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import arnoldimethod_tpu as jam
import arnoldimethod_torch as tam
from arnoldimethod_tpu.models import operators as jops
from arnoldimethod_torch import _device
from arnoldimethod_torch.convert import operator_from_arrays, workspace_from_npz
from arnoldimethod_torch.models import operators as tops
from arnoldimethod_torch.models.operators import (
    DiaOperator,
    SplitComplexDenseOperator,
    SplitComplexOperator,
    Stencil5Operator,
    TridiagonalShiftInvertOperator,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


def _rand_complex(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))


def _cv1(n, seed=21):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def _same_subspace(jQ, tQ, tol=1e-8):
    jQ, tQ = np.asarray(jQ), np.asarray(tQ)
    U = jQ.conj().T @ tQ
    assert np.abs(jQ @ U - tQ).max() <= tol


def _same_eigenvalues(a, b, tol=1e-10):
    assert np.abs(np.sort_complex(a) - np.sort_complex(b)).max() <= tol


def _close(a, b, tol=1e-13):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(a).max())


def _parity(jA, tA, **kw):
    dj, hj = jam.partial_schur(jA, split_complex=True, **kw)
    dt, ht = tam.partial_schur(tA, split_complex=True, **kw)
    assert hj.converged and ht.converged
    assert ht.mvproducts == hj.mvproducts
    _same_eigenvalues(dj.eigenvalues, dt.eigenvalues)
    _same_subspace(dj.Q, dt.Q)
    return dt, ht


@pytest.mark.parametrize("which", ["LM", "LI", "SR"])
def test_dense_matches_jax_split_complex(which):
    """JAX's tests/test_split_complex.py cases, against JAX's own
    split-complex solve from the same v1."""
    A = _rand_complex(48, 3)
    d, _ = _parity(A, A, nev=6, which=which, tol=1e-9, v1=_cv1(48))
    Q = d.Q.numpy()
    assert np.linalg.norm(A @ Q - Q @ d.R) < 1e-8 * np.linalg.norm(A)
    assert np.linalg.norm(Q.conj().T @ Q - np.eye(Q.shape[1])) < 1e-10


def test_split_complex_equals_native_complex():
    """split_complex=True runs the native complex path: the same count as
    split_complex=False from the same v1 (JAX's
    test_sc_identical_counts_same_seed)."""
    A = _rand_complex(40, 5)
    kw = dict(nev=5, which="LM", tol=1e-8, v1=_cv1(40))
    d0, h0 = tam.partial_schur(A, split_complex=False, **kw)
    d1, h1 = tam.partial_schur(A, split_complex=True, **kw)
    assert h1.mvproducts == h0.mvproducts and h1.restarts == h0.restarts
    _same_eigenvalues(d0.eigenvalues, d1.eigenvalues)


def test_dense_input_is_wrapped(monkeypatch):
    """A complex DenseOperator runs through SplitComplexDenseOperator, as
    the JAX package wraps it."""
    calls = []
    real = SplitComplexDenseOperator.matvec_sc

    def counted(self, xr, xi):
        calls.append(1)
        return real(self, xr, xi)

    monkeypatch.setattr(SplitComplexDenseOperator, "matvec_sc", counted)
    A = _rand_complex(30, 2)
    d, h = tam.partial_schur(A, nev=3, which="LM", tol=1e-8, v1=_cv1(30),
                             split_complex=True)
    assert h.converged and len(calls) == h.mvproducts
    calls.clear()
    tam.partial_schur(A, nev=3, which="LM", tol=1e-8, v1=_cv1(30))
    assert not calls


def test_real_dtype_ignores_the_flag():
    A = np.random.default_rng(4).standard_normal((30, 30))
    v1 = np.random.default_rng(5).standard_normal(30)
    d0, h0 = tam.partial_schur(A, nev=4, tol=1e-9, v1=v1)
    d1, h1 = tam.partial_schur(A, nev=4, tol=1e-9, v1=v1, split_complex=True)
    assert h1.mvproducts == h0.mvproducts
    assert d1.Q.dtype == torch.float64
    np.testing.assert_array_equal(d0.eigenvalues, d1.eigenvalues)


def _split_tridiagonal(n, seed=42):
    """A complex tridiagonal in the JAX package's split DIA form (what its
    dia_from_diagonals returns) and its dense matrix."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(-1.0, 1.0, n) + 1j * rng.uniform(0.0, 1.0, n)
    diagonals = {0: z, 1: 0.1, -1: 0.1j}
    jop = jops.dia_from_diagonals(diagonals, (n, n))
    A = np.diag(z) + np.diag(np.full(n - 1, 0.1), 1) \
        + np.diag(np.full(n - 1, 0.1j), -1)
    return jop, A


def _port_dia(jdia):
    return DiaOperator(np.asarray(jdia.diags), jdia.offsets, jdia.shape)


def _port_split(jop):
    return SplitComplexOperator(
        None if jop.re is None else _port_dia(jop.re),
        None if jop.im is None else _port_dia(jop.im),
    )


def test_split_dia_solve_matches_jax():
    jop, A = _split_tridiagonal(200)
    d, _ = _parity(jop, _port_split(jop), nev=4, which="LI", tol=1e-9,
                   v1=_cv1(200))
    Q = d.Q.numpy()
    assert np.linalg.norm(A @ Q - Q @ d.R) < 1e-8


def _xs(n, seed=9):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n)


def _check_matvec_sc(jop, top, A):
    xr, xi = _xs(A.shape[0])
    jyr, jyi = jop.matvec_sc(jnp.asarray(xr), jnp.asarray(xi))
    tyr, tyi = top.matvec_sc(torch.from_numpy(xr), torch.from_numpy(xi))
    _close(jyr, tyr)
    _close(jyi, tyi)
    y = A @ (xr + 1j * xi)
    _close(y.real, tyr, 1e-12)
    _close(y.imag, tyi, 1e-12)
    # The complex matvec is built on matvec_sc.
    t = top.matvec(torch.from_numpy(xr + 1j * xi))
    assert t.dtype == torch.complex128
    assert torch.equal(t, torch.complex(tyr, tyi))


def test_matvec_sc_split_dia():
    jop, A = _split_tridiagonal(64)
    top = _port_split(jop)
    assert top.dtype == torch.complex128 and top.word_dtype == torch.float64
    assert top.nnz == jop.nnz
    _check_matvec_sc(jop, top, A)


@pytest.mark.parametrize("parts", ["both", "re", "im"])
def test_matvec_sc_split_stencil(parts):
    grid = (6, 7)
    cre = (4.0, -1.0, -1.2, -0.9, -1.0)
    cim = (0.5, 0.1, -0.2, 0.3, 0.0)
    jre = jops.Stencil5Operator(cre, grid, dtype=jnp.float64, use_pallas=False)
    jim = jops.Stencil5Operator(cim, grid, dtype=jnp.float64, use_pallas=False)
    tre = Stencil5Operator(cre, grid, dtype=torch.float64)
    tim = Stencil5Operator(cim, grid, dtype=torch.float64)
    keep_re, keep_im = parts in ("both", "re"), parts in ("both", "im")
    jop = jops.SplitComplexOperator(jre if keep_re else None,
                                    jim if keep_im else None)
    top = SplitComplexOperator(tre if keep_re else None,
                               tim if keep_im else None)
    n = grid[0] * grid[1]
    eye = np.eye(n)
    dense = np.stack([tre.matvec(torch.from_numpy(eye[:, k])).numpy()
                      for k in range(n)], axis=1) if keep_re else 0
    dense_im = np.stack([tim.matvec(torch.from_numpy(eye[:, k])).numpy()
                         for k in range(n)], axis=1) if keep_im else 0
    _check_matvec_sc(jop, top, dense + 1j * dense_im)


def test_matvec_sc_split_dense():
    A = _rand_complex(20, 6)
    jop = jops.SplitComplexDenseOperator(A, word_dtype=jnp.float64)
    top = SplitComplexDenseOperator(A, word_dtype=torch.float64)
    assert top.dtype == torch.complex128 and top.shape == (20, 20)
    _check_matvec_sc(jop, top, A)
    f32 = SplitComplexDenseOperator(A)
    assert f32.word_dtype == torch.float32 and f32.dtype == torch.complex64


def test_from_operator_split_dia():
    """TridiagonalShiftInvertOperator.from_operator takes a split DIA pair,
    as the JAX package does: the same solves."""
    jop, A = _split_tridiagonal(50, seed=3)
    sigma = 0.2 + 0.5j
    jsi = jops.TridiagonalShiftInvertOperator.from_operator(jop, sigma=sigma)
    tsi = TridiagonalShiftInvertOperator.from_operator(_port_split(jop),
                                                       sigma=sigma)
    assert tsi.dtype == torch.complex128
    b = _cv1(50, 4)
    x = tsi.matvec(torch.from_numpy(b)).numpy()
    _close(np.asarray(jsi.matvec(jnp.asarray(b))), x, 1e-12)
    _close(b, (A - sigma * np.eye(50)) @ x, 1e-12)


def test_from_operator_split_needs_dia_parts():
    dense = tops.DenseOperator(np.eye(4))
    with pytest.raises(TypeError, match="DiaOperator"):
        TridiagonalShiftInvertOperator.from_operator(
            SplitComplexOperator(dense, None))
    wide = DiaOperator(np.ones((1, 4)), (2,), (4, 4))
    with pytest.raises(ValueError, match="tridiagonal"):
        TridiagonalShiftInvertOperator.from_operator(
            SplitComplexOperator(None, wide))


def test_split_operator_errors():
    """JAX's checks: at least one part; parts that agree in shape and in
    word dtype; real parts only."""
    a = DiaOperator(np.ones((1, 4)), (0,), (4, 4))
    with pytest.raises(ValueError, match="at least one"):
        SplitComplexOperator()
    with pytest.raises(ValueError, match="shape"):
        SplitComplexOperator(a, DiaOperator(np.ones((1, 5)), (0,), (5, 5)))
    with pytest.raises(ValueError, match="word dtype"):
        SplitComplexOperator(a, DiaOperator(np.ones((1, 4), np.float32),
                                            (0,), (4, 4)))
    with pytest.raises(ValueError, match="REAL"):
        SplitComplexOperator(DiaOperator(np.ones((1, 4), complex), (0,),
                                         (4, 4)))


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(extended=True), "extended"),
        (dict(method="device"), "host method"),
    ],
    ids=["extended", "device"],
)
def test_split_complex_rejects_incompatible_modes(kw, match):
    with pytest.raises(ValueError, match=match):
        tam.partial_schur(_rand_complex(8), nev=2, split_complex=True, **kw)


def test_jax_checkpoint_with_vim_warm_starts(tmp_path):
    """A JAX split-complex solve's checkpoint (real words V and Vim)
    loads as the complex basis V + i Vim; both packages resume from it
    and take the same count."""
    A = _rand_complex(40, 7)
    jws = jam.ArnoldiWorkspace(40, 16, dtype=jnp.float64)
    kw = dict(which="LM", tol=1e-9, maxdim=16, mindim=8, split_complex=True)
    _, h0 = jam.partial_schur(A, nev=4, workspace=jws, v1=_cv1(40), **kw)
    assert h0.converged and jws.Vim is not None
    path = tmp_path / "sc.npz"
    jws.save(path)

    tws = workspace_from_npz(path)
    assert tws.dtype == torch.complex128
    np.testing.assert_array_equal(
        tws.V.numpy(), np.asarray(jws.V) + 1j * np.asarray(jws.Vim))
    np.testing.assert_array_equal(tws.H, jws.H)

    # The JAX package's own load of this file casts H to its real word
    # dtype and drops H's imaginary part (ROADMAP.md queue 3, seen while
    # porting), so JAX resumes from the workspace in memory.
    assert not np.iscomplexobj(jam.ArnoldiWorkspace.load(path).H)
    dj, hj = jam.partial_schur(A, nev=6, workspace=jws,
                               start_from=h0.nconverged, **kw)
    dt, ht = tam.partial_schur(A, nev=6, workspace=tws,
                               start_from=h0.nconverged, **kw)
    assert hj.converged and ht.converged and ht.mvproducts == hj.mvproducts
    _same_eigenvalues(dj.eigenvalues, dt.eigenvalues)
    _same_subspace(dj.Q, dt.Q)


def test_real_workspace_is_promoted():
    """JAX's split-complex solves take a real workspace; the port makes it
    complex and resumes from it (JAX's test_sc_warm_start)."""
    A = _rand_complex(40, 7)
    kw = dict(which="LM", tol=1e-9, maxdim=16, mindim=8, split_complex=True)
    jws = jam.ArnoldiWorkspace(40, 16, dtype=jnp.float64)
    tws = tam.ArnoldiWorkspace(40, 16, dtype=torch.float64)
    _, hj0 = jam.partial_schur(A, nev=4, workspace=jws, v1=_cv1(40), **kw)
    _, ht0 = tam.partial_schur(A, nev=4, workspace=tws, v1=_cv1(40), **kw)
    assert tws.dtype == torch.complex128 and ht0.mvproducts == hj0.mvproducts
    dj, hj = jam.partial_schur(A, nev=6, workspace=jws,
                               start_from=hj0.nconverged, **kw)
    dt, ht = tam.partial_schur(A, nev=6, workspace=tws,
                               start_from=ht0.nconverged, **kw)
    assert ht.converged and ht.mvproducts == hj.mvproducts
    _same_eigenvalues(dj.eigenvalues, dt.eigenvalues)


def test_operator_from_arrays_split_complex():
    jop, A = _split_tridiagonal(64, seed=8)
    parts = {p: getattr(jop, p) for p in ("re", "im")}
    op = operator_from_arrays(
        "split_complex",
        {p: {"diags": np.asarray(o.diags), "offsets": np.asarray(o.offsets)}
         for p, o in parts.items()},
        {**{p + "_kind": "dia" for p in parts},
         **{p + "_meta": {"shape": o.shape} for p, o in parts.items()}},
    )
    assert isinstance(op, SplitComplexOperator)
    assert isinstance(op.re, DiaOperator) and isinstance(op.im, DiaOperator)
    _check_matvec_sc(jop, op, A)
    only_re = operator_from_arrays(
        "split_complex",
        {"re": {"diags": np.asarray(jop.re.diags),
                "offsets": np.asarray(jop.re.offsets)}, "im": None},
        {"re_kind": "dia", "re_meta": {"shape": jop.shape}},
    )
    assert only_re.im is None and only_re.dtype == torch.complex128


def test_operator_from_arrays_split_complex_dense():
    A = _rand_complex(20, 10)
    jop = jops.SplitComplexDenseOperator(A, word_dtype=jnp.float64)
    op = operator_from_arrays("split_complex_dense",
                              {"Ar": np.asarray(jop.Ar),
                               "Ai": np.asarray(jop.Ai)}, {})
    assert isinstance(op, SplitComplexDenseOperator)
    assert op.word_dtype == torch.float64
    _check_matvec_sc(jop, op, A)
