"""The port's Arnoldi expansion (arnoldimethod_torch/ops/expansion.py)
against the JAX package's, in float64 from the same start vector.

Tolerances: H to 1e-12 * ||H|| and V to 1e-10 (float64; the two packages
sum the Gram-Schmidt products in different orders, and the differences
grow mildly with the step count).  The breakdown path draws random vectors
whose streams differ between jax.random and torch.Generator, so it is held
to its invariants instead: the Arnoldi relation, orthonormality and the
zero subdiagonal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import arnoldimethod_tpu.ops.expansion as jexp
from arnoldimethod_tpu.models.operators import DenseOperator as JDense
from arnoldimethod_torch.models.operators import DenseOperator
from arnoldimethod_torch.ops import expansion as texp
from arnoldimethod_torch import _device

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


N, M = 60, 12


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N))
    v1 = rng.standard_normal(N)
    return A, v1


def _jax_run(A, v1, Qbig=None, k=None):
    op = JDense(jnp.asarray(A))
    V = jnp.zeros((M + 1, N))
    H = jnp.zeros((M + 1, M))
    V = jexp.set_initial_vector(V, jnp.asarray(v1))
    key = jax.random.PRNGKey(0)
    V, H = jexp.expand_range(op, V, H, 0, M, key)
    if Qbig is not None:
        V, H = jexp.truncate_and_expand(op, V, H, jnp.asarray(Qbig), k, M, key)
    return np.asarray(V), np.asarray(H)


def _torch_run(A, v1, Qbig=None, k=None):
    op = DenseOperator(A)
    V = torch.zeros((M + 1, N), dtype=torch.float64)
    H = torch.zeros((M + 1, M), dtype=torch.float64)
    texp.set_initial_vector(V, torch.from_numpy(v1))
    gen = torch.Generator().manual_seed(0)
    syncs = texp.expand_range(op, V, H, 0, M, gen)
    assert M <= syncs <= 2 * M
    if Qbig is not None:
        syncs = texp.truncate_and_expand(op, V, H, torch.from_numpy(Qbig), k,
                                         M, gen)
        assert M - k <= syncs <= 2 * (M - k)
    return V.numpy(), H.numpy()


def _qbig(k, seed=1):
    """A Krylov-Schur truncation matrix: an orthogonal mix of the first M
    rows into the first k, and the residual row M moved to row k."""
    Z, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((M, M)))
    Qbig = np.eye(M + 1)
    Qbig[:, :k] = 0
    Qbig[:M, :k] = Z[:, :k]
    Qbig[:, k] = 0
    Qbig[M, k] = 1
    return Qbig


def _agree(jv, jh, tv, th):
    assert np.abs(th - jh).max() <= 1e-12 * np.linalg.norm(jh)
    assert np.abs(tv - jv).max() <= 1e-10


@pytest.mark.parametrize("seed", [0, 1])
def test_expand_range_matches_jax(seed):
    A, v1 = _problem(seed)
    _agree(*_jax_run(A, v1), *_torch_run(A, v1))


@pytest.mark.parametrize("k", [4, 7])
def test_truncate_and_expand_matches_jax(k):
    A, v1 = _problem(2)
    Qbig = _qbig(k)
    jv, jh = _jax_run(A, v1, Qbig, k)
    tv, th = _torch_run(A, v1, Qbig, k)
    _agree(jv, jh[:, k:], tv, th[:, k:])


def test_apply_basis_change_matches_jax_and_keeps_storage():
    rng = np.random.default_rng(3)
    V0 = rng.standard_normal((M + 1, N))
    Qbig = _qbig(5)
    jv = np.asarray(jexp.apply_basis_change(jnp.asarray(V0), jnp.asarray(Qbig)))
    V = torch.from_numpy(V0.copy())
    ptr = V.data_ptr()
    texp.apply_basis_change(V, torch.from_numpy(Qbig))
    assert V.data_ptr() == ptr
    assert np.abs(V.numpy() - jv).max() <= 1e-13


def test_orthonormalize_rows_matches_jax():
    X0 = np.random.default_rng(4).standard_normal((6, N))
    jx = np.asarray(jexp.orthonormalize_rows(jnp.asarray(X0),
                                             jax.random.PRNGKey(0)))
    X = torch.from_numpy(X0.copy())
    texp.orthonormalize_rows(X, torch.Generator().manual_seed(0))
    assert np.abs(X.numpy() - jx).max() <= 1e-12


def test_breakdown_reinitializes_orthonormally():
    """Block-diagonal A with an e1 start: the Krylov space closes after 4
    steps, so H[4, 3] is exactly zero, the columns before the breakdown
    match JAX, and the random row keeps the basis orthonormal
    (ref: test/expansion.jl:34-55)."""
    rng = np.random.default_rng(4)
    n, m = 8, 6
    A = np.zeros((n, n))
    A[:4, :4] = rng.standard_normal((4, 4))
    A[4:, 4:] = rng.standard_normal((4, 4))
    e1 = np.eye(n)[0]
    jV = jexp.set_initial_vector(jnp.zeros((m + 1, n)), jnp.asarray(e1))
    _, jH = jexp.expand_range(JDense(jnp.asarray(A)), jV, jnp.zeros((m + 1, m)),
                              0, m, jax.random.PRNGKey(5))
    V = torch.zeros((m + 1, n), dtype=torch.float64)
    H = torch.zeros((m + 1, m), dtype=torch.float64)
    texp.set_initial_vector(V, torch.from_numpy(e1))
    texp.expand_range(DenseOperator(A), V, H, 0, m,
                      torch.Generator().manual_seed(5))
    Vn, Hn = V.numpy(), H.numpy()
    assert Hn[4, 3] == 0.0
    assert np.abs(Hn[:, :4] - np.asarray(jH)[:, :4]).max() <= 1e-13
    assert np.linalg.norm(Vn @ Vn.T - np.eye(m + 1)) < 1e-13
    assert np.linalg.norm(A @ Vn[:m].T - Vn.T @ Hn) < 1e-12


def test_full_space_breakdown_keeps_the_residual():
    """When the basis spans the whole space (j + 1 == n) there is no new
    direction: the last row takes the (zero) residual, as in JAX."""
    n = 4
    A = np.random.default_rng(6).standard_normal((n, n))
    V = torch.zeros((n + 1, n), dtype=torch.float64)
    H = torch.zeros((n + 1, n), dtype=torch.float64)
    texp.set_initial_vector(V, torch.ones(n, dtype=torch.float64))
    texp.expand_range(DenseOperator(A), V, H, 0, n, torch.Generator())
    assert H[n, n - 1].item() == 0.0
    assert torch.linalg.vector_norm(V[n]).item() < 1e-12


def test_set_random_vector_is_orthonormal_and_seeded():
    V = torch.zeros((5, N), dtype=torch.float64)
    texp.set_initial_vector(V, torch.ones(N, dtype=torch.float64))
    texp.set_random_vector(V, 1, torch.Generator().manual_seed(7))
    texp.set_random_vector(V, 2, torch.Generator().manual_seed(7))
    G = V[:3] @ V[:3].T
    assert torch.allclose(G, torch.eye(3, dtype=torch.float64), atol=1e-13)
    W = V.clone()
    texp.set_random_vector(W, 1, torch.Generator().manual_seed(7))
    assert torch.equal(W[1], V[1])


def test_fp32_matmul_restores_settings():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with texp.fp32_matmul():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
