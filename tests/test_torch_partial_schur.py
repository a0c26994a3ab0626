"""The port's main path, partial_schur with the host dense restart, against
the JAX package's on the same operators and the same start vector, in
float64.

Both packages make the same restart decisions from the same numbers, so
the matvec counts are identical; eigenvalues agree to 1e-10 and the Schur
factor R to 1e-8 (float64; the Gram-Schmidt sums are taken in different
orders, and a restart amplifies such differences mildly).  A Schur basis
is unique only up to the sign of each column (and a rotation inside each
2x2 block), and rounding-level differences in a deflated subdiagonal pick
either sign, in either package or dense layer; so Q is compared as a
subspace and R after the alignment U = Q_jax^T Q_port.  The exact matvec
counts of the reference's small cases hold on the port alone."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import arnoldimethod_tpu as jam
import arnoldimethod_torch as tam
from arnoldimethod_tpu.models import problems as jp
from arnoldimethod_torch.convert import workspace_from_npz
from arnoldimethod_torch.dense import native as tnative
from arnoldimethod_torch.models import problems as tp
from arnoldimethod_torch import _device

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


EPS = np.finfo(np.float64).eps


def _v1(n, seed=11):
    return np.random.default_rng(seed).standard_normal(n)


def _schur_residual(op, d):
    Q = d.Q
    R = torch.as_tensor(d.R, dtype=Q.dtype)
    return torch.linalg.norm(op.matmat(Q) - Q @ R).item()


def _same_schur(jQ, jR, tQ, tR, tol=1e-8):
    """Q spans the same subspace and R agrees after aligning the bases."""
    jQ, tQ = np.asarray(jQ), np.asarray(tQ)
    U = jQ.conj().T @ tQ
    assert np.abs(jQ @ U - tQ).max() <= tol
    assert np.abs(U.conj().T @ np.asarray(jR) @ U - tR).max() <= tol


def _compare(jd, jh, td, th):
    assert th.mvproducts == jh.mvproducts
    assert th.nconverged == jh.nconverged
    assert th.restarts == jh.restarts
    assert np.abs(td.eigenvalues - jd.eigenvalues).max() <= 1e-10
    _same_schur(jd.Q, jd.R, td.Q.numpy(), td.R)


def _same_eigenvectors(jX, tX, tol=1e-8):
    """Unit eigenvectors agree up to a unit-modulus factor per column."""
    jX, tX = np.asarray(jX), np.asarray(tX)
    phase = np.sum(jX.conj() * tX, axis=0)
    assert np.abs(np.abs(phase) - 1).max() <= tol
    assert np.abs(jX * phase - tX).max() <= tol


README = dict(nev=10, which="SR", tol=1e-6)


def test_readme_config_matches_jax():
    """laplacian_1d(100), nev=10, :SR, tol=1e-6 (readme.md:30-34)."""
    v1 = _v1(100)
    jd, jh = jam.partial_schur(jp.laplacian_1d(100), v1=v1, method="host",
                               **README)
    op = tp.laplacian_1d(100)
    td, th = tam.partial_schur(op, v1=v1, **README)
    assert th.converged
    _compare(jd, jh, td, th)
    assert _schur_residual(op, td) < 1e-6
    assert th.dense_layer in ("native", "numpy")
    assert th.mvproducts - 1 <= th.host_syncs <= 2 * th.mvproducts


def test_stencil_laplacian_2d_matches_jax():
    v1 = _v1(256, seed=12)
    kw = dict(nev=4, which="SR", tol=1e-8)
    jd, jh = jam.partial_schur(
        jp.laplacian_2d(16, 16, fmt="stencil", dtype=jnp.float64), v1=v1,
        method="host", **kw)
    op = tp.laplacian_2d(16, 16, fmt="stencil", dtype=torch.float64)
    td, th = tam.partial_schur(op, v1=v1, **kw)
    assert th.converged
    _compare(jd, jh, td, th)
    assert _schur_residual(op, td) < 1e-8  # tol * |lam| per column


def test_nonsymmetric_and_partial_eigen_match_jax():
    """A nonsymmetric dense matrix with conjugate pairs: same solve, and
    partial_eigen gives the same eigenpairs (complex vectors)."""
    rng = np.random.default_rng(13)
    A = rng.standard_normal((40, 40))
    v1 = _v1(40, seed=14)
    kw = dict(nev=6, which="LM", tol=1e-10)
    jd, jh = jam.partial_schur(A, v1=v1, method="host", **kw)
    td, th = tam.partial_schur(A, v1=v1, **kw)
    _compare(jd, jh, td, th)
    jvals, jX = jam.partial_eigen(jd)
    tvals, tX = tam.partial_eigen(td)
    assert np.iscomplexobj(tvals) and tX.is_complex()
    assert np.abs(tvals - jvals).max() <= 1e-10
    _same_eigenvectors(jX, tX.numpy())
    Xn = tX.numpy()
    assert np.linalg.norm(A @ Xn - Xn * tvals) < 1e-8


def test_partial_eigen_real_spectrum_matches_jax():
    v1 = _v1(100)
    jd, _ = jam.partial_schur(jp.laplacian_1d(100), v1=v1, method="host",
                              **README)
    td, _ = tam.partial_schur(tp.laplacian_1d(100), v1=v1, **README)
    jvals, jX = jam.partial_eigen(jd)
    tvals, tX = tam.partial_eigen(td)
    assert not np.iscomplexobj(tvals) and tX.dtype == torch.float64
    assert np.abs(tvals - jvals).max() <= 1e-10
    _same_eigenvectors(jX, tX.numpy())


def test_resume_from_a_jax_checkpoint(tmp_path):
    """A workspace saved by the JAX package resumes in the port (and in
    JAX): both lock more eigenvalues along the same path."""
    v1 = _v1(100)
    ws = jam.ArnoldiWorkspace(100, 20, dtype=jnp.float64)
    jd, jh = jam.partial_schur(jp.laplacian_1d(100), v1=v1, workspace=ws,
                               nev=3, which="SR", tol=1e-8, method="host")
    path = tmp_path / "ckpt.npz"
    ws.save(path)

    resume = dict(nev=6, which="SR", tol=1e-8, start_from=jh.nconverged,
                  initialize=False)
    jd2, jh2 = jam.partial_schur(jp.laplacian_1d(100),
                                 workspace=jam.ArnoldiWorkspace.load(path),
                                 method="host", **resume)
    tws = workspace_from_npz(path)
    assert tws.dtype == torch.float64 and tws.device.type == "cpu"
    op = tp.laplacian_1d(100)
    td2, th2 = tam.partial_schur(op, workspace=tws, **resume)
    assert th2.converged and th2.nconverged >= 6
    _compare(jd2, jh2, td2, th2)
    assert _schur_residual(op, td2) < 1e-8


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_rank_3_matrix_breakdown(dtype):
    """Rank-3 10x10: exactly 7 matvecs via the breakdown/reinitialization
    path (ref: test/partial_schur.jl:6-27)."""
    rng = np.random.default_rng(1)
    W = rng.standard_normal((10, 3)).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        W = W + 1j * rng.standard_normal((10, 3))
    B = W @ W.conj().T
    d, h = tam.partial_schur(B, nev=5, mindim=5, maxdim=7, tol=EPS)
    assert h.converged
    assert h.mvproducts == 7
    Q = d.Q.numpy()
    assert np.linalg.norm(Q.conj().T @ Q - np.eye(5)) < 1000 * EPS
    assert np.linalg.norm(B @ Q - Q @ d.R) < 1000 * EPS * np.linalg.norm(B)
    assert np.linalg.norm(np.diag(d.R)[3:]) < 1000 * EPS * np.linalg.norm(B)


def test_full_spectrum_small_matrix():
    """3x3: full spectrum in exactly 3 matvecs (ref: :47-52)."""
    A = np.random.default_rng(2).standard_normal((3, 3))
    d, h = tam.partial_schur(A)
    assert h.converged
    assert h.mvproducts == 3
    Q = d.Q.numpy()
    assert np.linalg.norm(A @ Q - Q @ d.R) < 1e-12


def test_native_and_numpy_dense_layers_agree(monkeypatch):
    import arnoldimethod_torch.driver as drv

    if not tnative.available():
        pytest.skip(f"native core not built: {tnative.build_error}")
    op = tp.laplacian_1d(80)
    v1 = _v1(80)
    d_nat, h_nat = drv.partial_schur(op, v1=v1, nev=4, which="SR", tol=1e-8)
    monkeypatch.setattr(drv._native, "available", lambda: False)
    d_np, h_np = drv.partial_schur(op, v1=v1, nev=4, which="SR", tol=1e-8)
    assert (h_nat.dense_layer, h_np.dense_layer) == ("native", "numpy")
    assert h_nat.mvproducts == h_np.mvproducts
    assert np.allclose(d_nat.eigenvalues, d_np.eigenvalues, atol=1e-12)
    _same_schur(d_nat.Q.numpy(), d_nat.R, d_np.Q.numpy(), d_np.R, 1e-10)


def test_random_start_is_seeded_and_float32_converges():
    op = tp.laplacian_1d(100, dtype=torch.float32)
    d1, h1 = tam.partial_schur(op, seed=3, **README)
    d2, h2 = tam.partial_schur(op, seed=3, **README)
    assert h1.converged and h1.mvproducts == h2.mvproducts
    assert np.array_equal(d1.eigenvalues, d2.eigenvalues)
    assert d1.Q.dtype == torch.float32
    assert _schur_residual(op, d1) < 5e-6


def test_callable_operator():
    A = np.diag(np.arange(1.0, 31.0))
    At = torch.from_numpy(A)
    d, h = tam.partial_schur(lambda x: At @ x, n=30, dtype=np.float64,
                             nev=3, which="LR", tol=1e-10, v1=_v1(30))
    assert h.converged
    assert np.allclose(np.sort(d.eigenvalues.real), [28.0, 29.0, 30.0])


def test_q_rows_is_not_the_workspace():
    ws = tam.ArnoldiWorkspace(50, 10, dtype=torch.float64)
    d, h = tam.partial_schur(tp.laplacian_1d(50), workspace=ws, nev=3,
                             which="SR", tol=1e-8, v1=_v1(50))
    assert d.Q_rows.data_ptr() != ws.V.data_ptr()
    assert tuple(d.Q.shape) == (50, h.nconverged)
    assert "PartialSchur" in repr(d) and "matrix-vector" in repr(h)


@pytest.mark.parametrize(
    "kw,err,match",
    [
        # sharding= is ported for the host and device methods
        # (tests/test_torch_parallel.py): it takes
        # parallel.basis_sharding(mesh) and refuses anything else.
        (dict(method="device", sharding=object()), TypeError,
         "basis_sharding"),
        # extended=True takes it too (tests/test_torch_parallel_extended.py)
        # and refuses the same.
        (dict(extended=True, sharding=object()), TypeError,
         "basis_sharding"),
        (dict(sharding=object()), TypeError, "basis_sharding"),
    ],
    ids=["device", "extended", "sharding"],
)
def test_options_not_ported_raise(kw, err, match):
    with pytest.raises(err, match=match):
        tam.partial_schur(np.eye(6), **kw)


def test_incorrect_input():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((6, 6))
    with pytest.raises(ValueError):
        tam.partial_schur(rng.standard_normal((4, 3)))
    with pytest.raises(ValueError):
        tam.partial_schur(A, mindim=5, maxdim=3)
    with pytest.raises(ValueError):
        tam.partial_schur(A, nev=5, mindim=3)
    with pytest.raises(ValueError):
        tam.partial_schur(A, nev=0)
    with pytest.raises(ValueError):
        tam.partial_schur(A, method="gpu")
    with pytest.raises(ValueError):
        tam.partial_schur(A, v1=np.ones(5))
    with pytest.raises(ValueError):
        tam.partial_schur(A, start_from=2)
    ws = tam.ArnoldiWorkspace(6, 4, dtype=torch.float64)
    with pytest.raises(ValueError):
        tam.partial_schur(A, workspace=ws, nev=2, start_from=5)
    with pytest.raises(ValueError):
        tam.partial_schur(A, workspace=ws, nev=2, start_from=1, v1=np.ones(6))
