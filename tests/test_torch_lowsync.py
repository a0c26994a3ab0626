"""The port's low-sync expansion (partial_schur(..., lowsync=True),
arnoldimethod_torch/ops/expansion.py::expand_range_lowsync) against the
JAX package's, in float64 from the same start vector.

Tolerances: solves take JAX's exact matvec counts, eigenvalues agree to
1e-10 and Q spans the same subspace to 1e-8 (as in
tests/test_torch_partial_schur.py); one expansion agrees with JAX's to
1e-12 relative (the contractions sum in different orders).  The port
defers each step's breakdown decision to one read a range and rolls back
a step that broke down, so it is held bit for bit to
`expand_range_lowsync_stepwise`, which reads every flag as it is made.
The breakdown path draws random rows whose streams differ between
jax.random and torch.Generator, so cases that break down mid-range are
held to that plain version and to their invariants, not to JAX."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import arnoldimethod_tpu as jam
import arnoldimethod_tpu.ops.expansion as jexp
import arnoldimethod_torch as tam
from arnoldimethod_tpu.models import problems as jp
from arnoldimethod_tpu.models.operators import DenseOperator as JDense
from arnoldimethod_torch import _device
from arnoldimethod_torch.models import problems as tp
from arnoldimethod_torch.models.operators import DenseOperator, FunctionOperator
from arnoldimethod_torch.ops import expansion as texp

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


README = dict(nev=10, which="SR", tol=1e-8)


def _v1(n, seed=11, complex_=False):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    return v + 1j * rng.standard_normal(n) if complex_ else v


def _same_subspace(jQ, tQ, tol=1e-8):
    jQ, tQ = np.asarray(jQ), np.asarray(tQ)
    U = jQ.conj().T @ tQ
    assert np.abs(jQ @ U - tQ).max() <= tol


def _same_eigenvalues(a, b, tol=1e-10):
    assert np.abs(np.sort_complex(a) - np.sort_complex(b)).max() <= tol


def _readme_solves(**kw):
    v1 = _v1(100)
    dj, hj = jam.partial_schur(jp.laplacian_1d(100), v1=v1, lowsync=True,
                               **README)
    op = tp.laplacian_1d(100, dtype=torch.float64)
    dt, ht = tam.partial_schur(op, v1=v1, lowsync=True, **README, **kw)
    dd, hd = tam.partial_schur(op, v1=v1, **README, **kw)
    return (dj, hj), (dt, ht), (dd, hd)


@pytest.fixture(scope="module")
def readme():
    texp.LOWSYNC.rollbacks = texp.LOWSYNC.discarded_matvecs = 0
    out = _readme_solves()
    return out, texp.LOWSYNC.rollbacks


def test_readme_config_matches_jax(readme):
    ((dj, hj), (dt, ht), _), _ = readme
    assert hj.converged and ht.converged
    assert ht.mvproducts == hj.mvproducts
    _same_eigenvalues(dj.eigenvalues, dt.eigenvalues)
    _same_subspace(dj.Q, dt.Q)


def test_readme_lowsync_count_equals_dgks(readme):
    """JAX's test_lowsync_matches_dgks, in the port: the two
    orthogonalizations agree to rounding, so the counts are equal."""
    ((_, _), (dt, ht), (dd, hd)), _ = readme
    assert hd.converged and ht.mvproducts == hd.mvproducts
    _same_eigenvalues(dt.eigenvalues, dd.eigenvalues, tol=1e-9)
    A = np.diag(np.full(100, 2.0)) + np.diag(np.full(99, -1.0), 1) \
        + np.diag(np.full(99, -1.0), -1)
    Q = dt.Q.numpy()
    assert np.linalg.norm(A @ Q - Q @ dt.R) < 1e-7
    assert np.linalg.norm(Q.T @ Q - np.eye(10)) < 1e-9


def test_readme_host_syncs(readme):
    """One read a range, and one a rollback: no read inside a Krylov step.
    The DGKS path reads about two a step on the same config."""
    ((_, _), (_, ht), (_, hd)), rollbacks = readme
    assert rollbacks == 0
    assert ht.host_syncs <= ht.restarts + 2 + rollbacks
    assert ht.host_syncs == ht.restarts
    assert hd.host_syncs >= 1.8 * hd.mvproducts


def test_readme_numpy_dense_layer_matches(readme, monkeypatch):
    """The numpy dense layer makes the same decisions from the low-sync
    H (the C++ core runs in the other tests where it builds)."""
    from arnoldimethod_torch.dense import native

    ((_, hj), _, _), _ = readme
    monkeypatch.setattr(native, "available", lambda: False)
    _, (dt, ht), _ = _readme_solves()
    assert ht.dense_layer == "numpy" and ht.mvproducts == hj.mvproducts


N, M = 60, 12


def _dense_problem(seed=0, complex_=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N))
    if complex_:
        A = A + 1j * rng.standard_normal((N, N))
    return A, _v1(N, seed + 1, complex_)


def _jax_expand(A, v1, Qbig=None, k=None):
    op = JDense(jnp.asarray(A))
    dt = jnp.complex128 if np.iscomplexobj(A) else jnp.float64
    V = jexp.set_initial_vector(jnp.zeros((M + 1, N), dt), jnp.asarray(v1))
    H = jnp.zeros((M + 1, M), dt)
    key = jax.random.PRNGKey(0)
    V, H = jexp.expand_range_lowsync(op, V, H, 0, M, key)
    if Qbig is not None:
        V, H = jexp.truncate_and_expand_lowsync(op, V, H, jnp.asarray(Qbig),
                                                k, M, key)
    return np.asarray(V), np.asarray(H)


def _torch_expand(A, v1, Qbig=None, k=None):
    op = DenseOperator(A)
    V = torch.zeros((M + 1, N), dtype=op.dtype)
    H = torch.zeros((M + 1, M), dtype=op.dtype)
    texp.set_initial_vector(V, torch.from_numpy(v1))
    gen = torch.Generator().manual_seed(0)
    Hh, flags, reads = texp.expand_range_lowsync(op, V, H, 0, M, gen)
    assert reads == 1 and not any(flags)
    np.testing.assert_array_equal(Hh, H.numpy())
    if Qbig is not None:
        Hh, flags, reads = texp.truncate_and_expand_lowsync(
            op, V, H, torch.from_numpy(Qbig).to(op.dtype), k, M, gen)
        assert reads == 1 and len(flags) == M - k
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


def _close(a, b, tol=1e-12):
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(a).max())


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_one_expansion_matches_jax(complex_):
    A, v1 = _dense_problem(complex_=complex_)
    jV, jH = _jax_expand(A, v1)
    tV, tH = _torch_expand(A, v1)
    _close(jH, tH)
    _close(jV, tV)


def test_truncate_and_expand_matches_jax():
    A, v1 = _dense_problem(seed=4)
    Qbig = _qbig(5)
    jV, jH = _jax_expand(A, v1, Qbig, 5)
    tV, tH = _torch_expand(A, v1, Qbig, 5)
    _close(jH, tH)
    _close(jV, tV)


def _both_ways(A, v1, m, j1=None):
    """The deferred expansion and the step-by-step one from the same V0 and
    generator seed; returns both (V, H, result)."""
    n = A.shape[0]
    out = []
    for expand in (texp.expand_range_lowsync_stepwise,
                   texp.expand_range_lowsync):
        op = DenseOperator(A)
        V = torch.zeros((m + 1, n), dtype=op.dtype)
        H = torch.zeros((m + 1, m), dtype=op.dtype)
        texp.set_initial_vector(V, torch.from_numpy(v1))
        out.append((V, H, expand(op, V, H, 0, j1 or m,
                                 torch.Generator().manual_seed(3))))
    return out


def _rank3():
    rng = np.random.default_rng(0)
    U = np.linalg.qr(rng.standard_normal((10, 3)))[0]
    return U @ np.diag([5.0, 3.0, 1.5]) @ U.T, rng.standard_normal(10)


def _two_cycles(n=10):
    """A permutation with a 3-cycle and a 7-cycle: from e_0 the Krylov
    space closes exactly at step 2, and the whole space at step n-1."""
    P = np.zeros((n, n))
    for cycle in (range(3), range(3, n)):
        c = list(cycle)
        for a, b in zip(c, c[1:] + c[:1]):
            P[b, a] = 1.0
    e0 = np.zeros(n)
    e0[0] = 1.0
    return P, e0


def _two_blocks():
    """Block-diagonal 3 + 7 with v1 in the first block: the Krylov space
    closes at step 2 (the second block's entries stay exactly zero)."""
    rng = np.random.default_rng(5)
    A = np.zeros((10, 10))
    A[:3, :3] = rng.standard_normal((3, 3))
    A[3:, 3:] = rng.standard_normal((7, 7))
    v1 = np.zeros(10)
    v1[:3] = rng.standard_normal(3)
    return A, v1


def _full_spectrum():
    rng = np.random.default_rng(3)
    return rng.standard_normal((8, 8)), rng.standard_normal(8)


@pytest.mark.parametrize(
    "case,m,want",
    [
        (_rank3, 7, []),
        (_two_cycles, 10, [2, 9]),
        (_two_blocks, 10, [2, 9]),
        (lambda: (np.zeros((10, 10)), np.full(10, 0.5)), 10, list(range(10))),
        (_full_spectrum, 8, [7]),
        (lambda: (_full_spectrum()[0] + 1j * _two_cycles(8)[0],
                  _full_spectrum()[1] + 0j), 8, [7]),
    ],
    ids=["rank3", "two_cycles", "two_blocks", "zero", "full_spectrum",
         "complex_full"],
)
def test_deferred_flags_are_the_stepwise_ones(case, m, want):
    """Bit for bit: V, H, the flags and the host H, across every
    rollback; the reads are one a range and one a rollback (none for a
    breakdown at the range's last step)."""
    A, v1 = case()
    texp.LOWSYNC.rollbacks = texp.LOWSYNC.discarded_matvecs = 0
    (V1, H1, (flags1, _)), (V2, H2, (Hh, flags2, reads)) = _both_ways(A, v1, m)
    assert torch.equal(V1, V2) and torch.equal(H1, H2)
    np.testing.assert_array_equal(Hh, H2.numpy())
    assert flags1 == flags2
    assert [j for j, f in enumerate(flags2) if f] == want
    assert texp.LOWSYNC.rollbacks == len(want)
    assert texp.LOWSYNC.discarded_matvecs == sum(m - 1 - j for j in want)
    assert reads == 1 + len(want) - (m - 1 in want)
    assert bool(torch.isfinite(V2).all())


def test_deferred_expansion_resumes_mid_basis():
    """A range that starts past row 0 (a restart's expansion) defers its
    flags the same way."""
    P, e0 = _two_cycles()
    out = []
    for expand in (texp.expand_range_lowsync_stepwise,
                   texp.expand_range_lowsync):
        op = DenseOperator(P)
        V = torch.zeros((11, 10), dtype=torch.float64)
        H = torch.zeros((11, 10), dtype=torch.float64)
        texp.set_initial_vector(V, torch.from_numpy(e0))
        gen = torch.Generator().manual_seed(5)
        texp.expand_range_lowsync_stepwise(op, V, H, 0, 2, gen)
        out.append((V, H, expand(op, V, H, 2, 10, gen)))
    (V1, H1, (f1, _)), (V2, H2, (_, f2, _)) = out
    assert torch.equal(V1, V2) and torch.equal(H1, H2) and f1 == f2
    assert f2[0] and f2[-1]


def test_rank3_breakdown_case():
    """JAX's rank-3 case (tests/test_lowsync.py): converged, the exact
    eigenvalues; JAX from the same v1 takes the same count."""
    A, v1 = _rank3()
    kw = dict(nev=3, which="LM", tol=1e-9, mindim=3, maxdim=7, v1=v1,
              lowsync=True)
    dj, hj = jam.partial_schur(A, **kw)
    dt, ht = tam.partial_schur(A, **kw)
    assert ht.converged and hj.converged and ht.mvproducts == hj.mvproducts
    assert np.allclose(np.sort(dt.eigenvalues.real), [1.5, 3.0, 5.0],
                       atol=1e-8)


@pytest.mark.parametrize("case", [_rank3, _two_blocks],
                         ids=["rank3", "two_blocks"])
def test_callable_sees_only_finite_rows(case):
    """Every row a user's callable is given is finite, the speculative
    rows after a breakdown included."""
    A, v1 = case()
    At = torch.from_numpy(A)
    seen = []

    def f(x):
        assert bool(torch.isfinite(x).all())
        seen.append(1)
        return At @ x

    texp.LOWSYNC.rollbacks = 0
    op = FunctionOperator(f, A.shape[0], torch.float64)
    d, h = tam.partial_schur(op, nev=3, which="LM", tol=1e-9, mindim=3,
                             maxdim=7, v1=v1, lowsync=True)
    assert h.converged
    assert len(seen) >= h.mvproducts
    assert h.host_syncs <= h.restarts + 2 + texp.LOWSYNC.rollbacks
    Q = d.Q.numpy()
    assert np.linalg.norm(A @ Q - Q @ d.R) < 1e-8


def test_full_spectrum_matches_jax():
    """maxdim == n: the last step of every range has j+1 == n, where the
    breakdown path keeps w itself (expansion.jl:127)."""
    A, v1 = _full_spectrum()
    kw = dict(nev=3, which="LM", tol=1e-10, mindim=4, maxdim=8, v1=v1,
              lowsync=True)
    dj, hj = jam.partial_schur(A, **kw)
    dt, ht = tam.partial_schur(A, **kw)
    assert ht.converged and ht.mvproducts == hj.mvproducts
    _same_eigenvalues(dj.eigenvalues, dt.eigenvalues)
    _same_subspace(dj.Q, dt.Q)


def test_complex_matrix_matches_jax():
    """JAX's complex lowsync case (tests/test_lowsync.py): the contractions
    must conjugate V, or c1[j+1] is not ||w||^2."""
    rng = np.random.default_rng(7)
    A = rng.standard_normal((40, 40)) + 1j * rng.standard_normal((40, 40))
    kw = dict(nev=6, which="LM", tol=1e-9, v1=_v1(40, 8, complex_=True))
    dj, hj = jam.partial_schur(A, lowsync=True, **kw)
    dt, ht = tam.partial_schur(A, lowsync=True, **kw)
    dd, hd = tam.partial_schur(A, **kw)
    assert ht.converged and ht.mvproducts == hj.mvproducts
    _same_eigenvalues(dj.eigenvalues, dt.eigenvalues)
    _same_subspace(dj.Q, dt.Q)
    Q = dt.Q.numpy()
    assert np.linalg.norm(Q.conj().T @ Q - np.eye(Q.shape[1])) < 1e-8
    assert np.linalg.norm(A @ Q - Q @ dt.R) < 1e-7 * np.linalg.norm(A)
    _same_eigenvalues(dd.eigenvalues, dt.eigenvalues, tol=1e-7)


def test_float32_lowsync_converges():
    """Working precision float32 (the card's config-2 dtype), on the CPU."""
    op = tp.laplacian_1d(100, dtype=torch.float32)
    d, h = tam.partial_schur(op, v1=_v1(100), nev=10, which="SR", tol=1e-6,
                             lowsync=True)
    assert h.converged and d.Q.dtype == torch.float32
    assert h.host_syncs <= h.restarts + 2 + texp.LOWSYNC.rollbacks


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(extended=True), "extended"),
        (dict(method="device"), "host-method"),
        (dict(split_complex=True), "split-complex"),
    ],
    ids=["extended", "device", "split_complex"],
)
def test_lowsync_rejects_incompatible_modes(kw, match):
    A = np.eye(6) + 1j * np.diag(np.arange(5.0), 1)
    if "split_complex" not in kw:
        A = tp.laplacian_1d(32, dtype=torch.float64)
    with pytest.raises(ValueError, match=match):
        tam.partial_schur(A, nev=2, lowsync=True, **kw)


def test_lowsync_with_sharding_is_not_ported():
    """lowsync=True with sharding= is ported (tests/test_torch_parallel.py);
    a sharding that is not parallel.basis_sharding(mesh) is refused."""
    with pytest.raises(TypeError, match="basis_sharding"):
        tam.partial_schur(np.eye(6), nev=2, lowsync=True, sharding=object())
