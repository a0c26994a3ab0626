"""The port's general-sparse operators (CSR, ELL, SELL, DIA from CSR), the
format rule and the scipy.sparse entry point against the JAX package's, on
the same seeded scipy matrices.

Matvecs are sums of a few products taken in possibly different orders:
agreement to 1e-13 relative in float64 (1e-5 in float32).  Solves from the
same `v1` in float64 take the same matvec count, with eigenvalues within
1e-10, as in tests/test_torch_partial_schur.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import arnoldimethod_tpu as jam
import arnoldimethod_tpu.models.operators as jo
import arnoldimethod_tpu.models.problems as jp
import arnoldimethod_torch as tam
import arnoldimethod_torch.models.operators as to
import arnoldimethod_torch.models.problems as tp
from arnoldimethod_torch.convert import operator_from_arrays
from arnoldimethod_torch import _device

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


DTYPES = [np.float32, np.float64, np.complex128]
DTYPE_IDS = ["f32", "f64", "c128"]


def _tol(dtype):
    return 1e-5 if np.dtype(dtype) == np.float32 else 1e-13


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


def _random_csr(n, density, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    S = sp.random(n, n, density=density, random_state=rng, format="csr")
    if np.issubdtype(dtype, np.complexfloating):
        S = S + 1j * sp.random(n, n, density=density, random_state=rng,
                               format="csr")
    return (S + sp.eye(n)).tocsr().astype(dtype)


def _power_law_csr(n=200, seed=4, dtype=np.float64):
    """Row lengths 1 .. 64 from a Zipf-like law, with empty rows too: the
    pattern SELL is made for."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum(rng.zipf(1.6, n), 64) * (rng.random(n) > 0.05)
    rows = np.repeat(np.arange(n), lengths)
    cols = rng.integers(0, n, rows.size)
    vals = rng.standard_normal(rows.size)
    if np.issubdtype(dtype, np.complexfloating):
        vals = vals + 1j * rng.standard_normal(rows.size)
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr().astype(dtype)


def _x(n, dtype, seed=0, k=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if k is None else (n, k)
    x = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _both(jop, top, x):
    return (np.asarray(jop.matvec(jnp.asarray(x))),
            top.matvec(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_csr_matches_jax(dtype):
    S = _power_law_csr(dtype=dtype)
    n = S.shape[0]
    jop = jo.CsrOperator(S.indptr, S.indices, S.data, S.shape)
    top = to.CsrOperator(S.indptr, S.indices, S.data, S.shape)
    assert top.nnz == jop.nnz and top.dtype == torch.from_numpy(S.data).dtype
    jy, ty = _both(jop, top, _x(n, dtype))
    _close(ty, jy, _tol(dtype))
    X = _x(n, dtype, k=5)
    _close(top.matmat(torch.from_numpy(X)).numpy(),
           np.asarray(jop.matmat(jnp.asarray(X))), _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_ell_matches_jax(dtype):
    S = _random_csr(120, 0.05, 1, dtype)
    jop = jo.csr_to_ell(S.indptr, S.indices, S.data, S.shape)
    top = to.csr_to_ell(S.indptr, S.indices, S.data, S.shape)
    np.testing.assert_array_equal(top.data.numpy(), np.asarray(jop.data))
    np.testing.assert_array_equal(top.cols.numpy(), np.asarray(jop.cols))
    assert top.nnz == jop.nnz
    jy, ty = _both(jop, top, _x(120, dtype))
    _close(ty, jy, _tol(dtype))
    X = _x(120, dtype, k=3)
    _close(top.matmat(torch.from_numpy(X)).numpy(),
           np.asarray(jop.matmat(jnp.asarray(X))), _tol(dtype))
    via_csr = to.CsrOperator(S.indptr, S.indices, S.data, S.shape).to_ell()
    np.testing.assert_array_equal(via_csr.data.numpy(), np.asarray(jop.data))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_sell_matches_jax(dtype):
    S = _power_law_csr(dtype=dtype)
    n = S.shape[0]
    jop = jo.sell_from_csr(S.indptr, S.indices, S.data, S.shape)
    top = to.CsrOperator(S.indptr, S.indices, S.data, S.shape).to_sell()
    assert len(top.buckets) == len(jop.buckets) > 3
    for (td, tc), (jd, jc) in zip(top.buckets, jop.buckets):
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(top.inv_perm.numpy(), np.asarray(jop.inv_perm))
    assert (top.nnz, top.nnz_stored) == (jop.nnz, jop.nnz_stored)
    jy, ty = _both(jop, top, _x(n, dtype))
    _close(ty, jy, _tol(dtype))
    X = _x(n, dtype, k=4)
    _close(top.matmat(torch.from_numpy(X)).numpy(),
           np.asarray(jop.matmat(jnp.asarray(X))), _tol(dtype))


def test_sell_and_csr_of_an_empty_matrix():
    S = sp.csr_matrix((16, 16))
    jop = jo.sell_from_csr(S.indptr, S.indices, S.data, S.shape)
    top = to.sell_from_csr(S.indptr, S.indices, S.data, S.shape)
    jy, ty = _both(jop, top, np.ones(16))
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(ty, np.zeros(16))
    csr = to.CsrOperator(S.indptr, S.indices, S.data, S.shape)
    np.testing.assert_array_equal(csr.matvec(torch.ones(16, dtype=torch.float64)).numpy(),
                                  np.zeros(16))
    assert csr.matmat(torch.ones(16, 3, dtype=torch.float64)).shape == (16, 3)


def test_csr_to_dia_matches_jax():
    n = 40
    T = sp.diags(
        [np.arange(1.0, n - 1), 2 * np.ones(n), np.full(n - 3, -0.5)],
        [-2, 0, 3],
    ).tocsr()
    jop = jo.csr_to_dia(T.indptr, T.indices, T.data, T.shape)
    top = to.csr_to_dia(T.indptr, T.indices, T.data, T.shape)
    assert top.offsets == jop.offsets
    np.testing.assert_array_equal(top.diags.numpy(), np.asarray(jop.diags))
    x = _x(n, np.float64)
    jy, ty = _both(jop, top, x)
    _close(ty, jy, 1e-13)
    _close(ty, T @ x, 1e-13)


@pytest.mark.parametrize(
    "diagonals,dtype,torch_dtype",
    [
        ({-1: -1.0, 0: np.linspace(1, 2, 12), 2: 0.5}, None, torch.float64),
        ({0: np.arange(12) * (1 + 2j), 1: -1.0 + 0.5j}, None, torch.complex128),
        ({0: np.arange(12) * (1 + 2j), -3: 2.0}, np.float32, torch.complex64),
    ],
    ids=["real", "complex", "complex_f32_words"],
)
def test_dia_from_diagonals_matches_jax(diagonals, dtype, torch_dtype):
    """Complex values give a native complex DiaOperator; the JAX package
    gives a split-complex one with the same parts."""
    jop = jo.dia_from_diagonals(diagonals, (12, 12), dtype=dtype)
    top = to.dia_from_diagonals(diagonals, (12, 12), dtype=dtype)
    assert isinstance(top, to.DiaOperator) and top.dtype == torch_dtype
    if torch_dtype.is_complex:
        np.testing.assert_array_equal(top.diags.real.numpy(), np.asarray(jop.re.diags))
        x = _x(12, np.complex128).astype(torch.empty(0, dtype=torch_dtype).numpy().dtype)
        tol = 1e-5 if torch_dtype == torch.complex64 else 1e-13
    else:
        np.testing.assert_array_equal(top.diags.numpy(), np.asarray(jop.diags))
        x, tol = _x(12, np.float64), 1e-13
    jy, ty = _both(jop, top, x)
    _close(ty, jy, tol)


def _clustered(n=512, B=128, seed=0):
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for i in range(0, n, B):
        A[i:i + B, i:i + B] = rng.standard_normal((B, B))
    return sp.csr_matrix(A)


PATTERNS = {
    "banded": lambda: sp.diags([np.ones(511), 2 * np.ones(512), np.ones(511)],
                               [-1, 0, 1]).tocsr(),
    "clustered": _clustered,
    "scattered": lambda: sp.random(2048, 2048, density=0.002, random_state=1,
                                   format="csr"),
}


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_pick_sparse_format_matches_jax(pattern):
    """The TPU rule, unchanged: banded -> dia, clustered -> bsr,
    scattered -> sell (tests/test_operators.py::
    test_pick_sparse_format_hierarchy)."""
    S = PATTERNS[pattern]()
    picked = to.pick_sparse_format(S.indptr, S.indices, S.shape)
    assert picked == jo.pick_sparse_format(S.indptr, S.indices, S.shape)
    assert picked[0] == {"banded": "dia", "clustered": "bsr",
                         "scattered": "sell"}[pattern]


@pytest.mark.parametrize("fmt", list(to.SPARSE_FORMATS))
def test_as_operator_formats_match_jax(fmt):
    S = _random_csr(64, 0.08, 2)
    jop = jo.as_operator(S, sparse_format=fmt)
    top = to.as_operator(S, sparse_format=fmt)
    assert type(top).__name__ == type(jop).__name__
    x = _x(64, np.float64)
    jy, ty = _both(jop, top, x)
    _close(ty, jy, 1e-13)
    _close(ty, S @ x, 1e-13)


@pytest.mark.parametrize("fmt", ["auto", "csr", "sell"])
def test_as_operator_sums_duplicate_entries(fmt):
    """Duplicate (row, col) entries add in every layout (the auto layout
    of this band is DIA, whose scatter would keep one of them)."""
    n = 32
    rows = np.r_[np.arange(n), np.arange(n), np.arange(1, n)]
    cols = np.r_[np.arange(n), np.arange(n), np.arange(n - 1)]
    vals = np.r_[np.full(n, 1.5), np.full(n, 0.5), np.full(n - 1, -1.0)]
    indptr = np.r_[0, np.cumsum(np.bincount(rows, minlength=n))]
    order = np.argsort(rows, kind="stable")
    A = sp.csr_matrix((vals[order], cols[order], indptr), shape=(n, n))
    assert not A.has_canonical_format
    top = to.as_operator(A, sparse_format=fmt)
    x = np.arange(1.0, n + 1.0)
    y = top.matvec(torch.from_numpy(x)).numpy()
    _close(y, np.asarray(jo.as_operator(A, sparse_format=fmt).matvec(jnp.asarray(x))), 1e-13)
    _close(y, A.toarray() @ x, 1e-13)
    assert not A.has_canonical_format  # the caller's matrix is untouched


def test_as_operator_empty_matrix():
    op = to.as_operator(sp.csr_matrix((16, 16)))
    assert isinstance(op, to.SellOperator) and op.nnz == 0
    np.testing.assert_array_equal(
        op.matvec(torch.ones(16, dtype=torch.float64)).numpy(), np.zeros(16))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.bool_])
def test_as_operator_promotes_integer_sparse_data(dtype):
    S = sp.csr_matrix(np.eye(6, dtype=dtype) + np.eye(6, k=2, dtype=dtype))
    op = to.as_operator(S, sparse_format="csr")
    assert op.dtype == torch.float64
    assert jo.as_operator(S, sparse_format="csr").dtype == np.float64


def test_as_operator_rejects_bad_sparse_input():
    with pytest.raises(ValueError, match="not square"):
        to.as_operator(sp.csr_matrix((3, 4)))
    with pytest.raises(ValueError, match="sparse_format"):
        to.as_operator(sp.eye(4, format="csr"), sparse_format="coo")
    with pytest.raises(ValueError, match="sparse_format"):
        tam.partial_schur(sp.eye(4, format="csr"), sparse_format="bsr2")


@pytest.mark.parametrize("fmt", ["auto", "csr", "bsr", "sell"])
def test_complex_scipy_input_is_a_native_complex_operator(fmt):
    S = _random_csr(48, 0.1, 3, np.complex128)
    op = to.as_operator(S, sparse_format=fmt, device="cpu")
    assert op.dtype == torch.complex128 and op.device == torch.device("cpu")
    x = _x(48, np.complex128)
    _close(op.matvec(torch.from_numpy(x)).numpy(), S @ x, 1e-13)


def _solve_patterns():
    n = 120
    rng = np.random.default_rng(5)
    return {
        "banded": sp.diags(
            [np.full(n - 1, -1.0), np.arange(1.0, n + 1), np.full(n - 1, -1.0)],
            [-1, 0, 1]).tocsr(),
        "clustered": sp.csr_matrix(
            np.diag(np.linspace(1.0, 3.0, 128))
            + 0.1 * _clustered(128, 32, seed=6).toarray()),
        "scattered": sp.diags(np.arange(1, n + 1.0)).tocsr() + 0.1 * sp.random(
            n, n, density=0.05, random_state=rng, format="csr"),
    }


@pytest.mark.parametrize("pattern", ["banded", "clustered", "scattered"])
def test_partial_schur_scipy_input_matches_jax(pattern):
    """partial_schur(scipy matrix) takes the format JAX takes and makes the
    same restart decisions from the same v1 (float64)."""
    S = _solve_patterns()[pattern]
    n = S.shape[0]
    v1 = np.random.default_rng(13).standard_normal(n)
    kw = dict(nev=4, which="LM", tol=1e-9)
    assert type(to.as_operator(S)).__name__ == type(jo.as_operator(S)).__name__
    jd, jh = jam.partial_schur(S, v1=v1, method="host", **kw)
    td, th = tam.partial_schur(S, v1=v1, **kw)
    assert th.converged and jh.converged
    assert th.mvproducts == jh.mvproducts and th.nconverged == jh.nconverged
    assert np.abs(td.eigenvalues - jd.eigenvalues).max() <= 1e-10
    # The CSR layout of the same matrix gives the same spectrum.
    cd, ch = tam.partial_schur(S, v1=v1, sparse_format="csr", **kw)
    assert ch.converged
    assert np.abs(np.sort_complex(cd.eigenvalues)
                  - np.sort_complex(td.eigenvalues)).max() <= 1e-8


@pytest.mark.parametrize(
    "build",
    [
        lambda m: m.laplacian_1d(50, fmt="ell"),
        lambda m: m.laplacian_2d(8, 6, fmt="ell"),
        lambda m: m.convection_diffusion_2d(8, 6, peclet=20.0, fmt="ell"),
    ],
    ids=["laplacian_1d", "laplacian_2d", "convdiff_2d"],
)
def test_ell_problems_match_jax(build):
    jop, top = build(jp), build(tp)
    assert isinstance(top, to.EllOperator) and top.dtype == torch.float64
    np.testing.assert_array_equal(top.data.numpy(), np.asarray(jop.data))
    np.testing.assert_array_equal(top.cols.numpy(), np.asarray(jop.cols))
    jy, ty = _both(jop, top, _x(top.shape[0], np.float64))
    _close(ty, jy, 1e-13)


def _jax_arrays(kind):
    """(JAX operator, kind, arrays, meta) for operator_from_arrays."""
    if kind == "bsr":
        A, B = _clustered(96, 16, seed=8), 16
        jop = jo.CsrOperator(A.indptr, A.indices, A.data, A.shape).to_bsr(B)
        return jop, {"block_cols": np.asarray(jop.block_cols),
                     "block_dataT": np.asarray(jop.block_dataT)}, {
            "logical_blocks": jop.logical_blocks, "shape": jop.shape}
    S = _power_law_csr(120, seed=9)
    if kind == "csr":
        jop = jo.CsrOperator(S.indptr, S.indices, S.data, S.shape)
        return jop, {"indptr": np.asarray(jop.indptr),
                     "indices": np.asarray(jop.indices),
                     "data": np.asarray(jop.data)}, {"shape": jop.shape}
    if kind == "ell":
        jop = jo.csr_to_ell(S.indptr, S.indices, S.data, S.shape)
        return jop, {"data": np.asarray(jop.data),
                     "cols": np.asarray(jop.cols)}, {"shape": jop.shape}
    jop = jo.sell_from_csr(S.indptr, S.indices, S.data, S.shape)
    return jop, {"buckets": [(np.asarray(d), np.asarray(c)) for d, c in jop.buckets],
                 "inv_perm": np.asarray(jop.inv_perm)}, {
        "shape": jop.shape, "nnz": jop.nnz}


@pytest.mark.parametrize("kind", ["csr", "ell", "sell", "bsr"])
def test_operator_from_arrays_new_kinds(kind):
    jop, arrays, meta = _jax_arrays(kind)
    top = operator_from_arrays(kind, arrays, meta)
    assert top.shape == tuple(jop.shape) and top.nnz == jop.nnz
    jy, ty = _both(jop, top, _x(top.shape[0], np.float64))
    _close(ty, jy, 1e-13)
