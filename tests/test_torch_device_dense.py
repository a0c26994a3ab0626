"""The port's dense restart of `method="device"`, plain version
(arnoldimethod_torch/dense/device.py), against the JAX package's
`arnoldimethod_tpu/dense/device.py` on the same numpy-seeded inputs, in
float64 and float32.

Tolerances: in float64 the two agree to 1e-12 (1e-11 after a Francis
sweep or a sequence of swaps), in float32 to 1e-4 absolute on O(1)
entries; the port sums in `tree_sum`'s fixed order and XLA in its own,
and compiled XLA:CPU may contract products into FMAs, so the last bits
differ.  Francis QR iterates are chaotic in roundoff (a 1-ulp difference
can flip a deflation order), so `local_schur` is held to its invariants
(similarity, orthonormality, quasi-triangular form, the spectrum), as the
JAX package's own tests hold `local_schur_jax`.  JAX marks its `_jax`
swap/partition/sort tests slow, so those are held to the JAX package's
host twins (`dense.swaps`, `driver._partition_three_way`,
`driver._sort_schur`), with one case of each also against the `_jax`
function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arnoldimethod_torch import _device
from arnoldimethod_torch.dense import device as dd
from arnoldimethod_tpu.dense import device as jd
from arnoldimethod_tpu.dense.swaps import (
    is_start_of_11_block,
    rotate_right as np_rotate_right,
    swap as np_swap,
)
from arnoldimethod_tpu.driver import _partition_three_way, _sort_schur
from arnoldimethod_tpu.targets import as_target, get_order

torch.set_num_threads(2)

DTYPES = [(torch.float64, np.float64, 1e-12), (torch.float32, np.float32, 1e-4)]


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


def _hessenberg(m, seed, rows=None):
    rng = np.random.default_rng(seed)
    H = np.zeros((rows or m, m))
    H[:m, :m] = np.triu(rng.standard_normal((m, m)), -1)
    return H


def _quasi_schur(m, seed, pairs=()):
    """Quasi-upper-triangular R with 2x2 conjugate blocks at `pairs`,
    padded to (m+1, m)."""
    rng = np.random.default_rng(seed)
    R = np.triu(rng.standard_normal((m, m)))
    for p in pairs:
        a, b = 0.5 * rng.standard_normal(), 1.0 + rng.random()
        R[p, p] = R[p + 1, p + 1] = a
        R[p, p + 1] = b
        R[p + 1, p] = -b
    out = np.zeros((m + 1, m))
    out[:m] = R
    return out


def _t(a, tdt):
    return torch.tensor(np.asarray(a), dtype=tdt)


def _j(a, ndt):
    return jnp.asarray(np.asarray(a, dtype=ndt))


def _close(got, want, tol):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("tdt,ndt,tol", DTYPES)
def test_givens_matches_jax(tdt, ndt, tol):
    rng = np.random.default_rng(0)
    cases = [(rng.standard_normal(), rng.standard_normal()), (0.0, -2.5),
             (1.5, 0.0), (0.0, 0.0), (-3.0, 4.0), (1e-30, 1e30),
             (-0.7, -1e-3)]
    for f, g in cases:
        got = dd.givens(ndt(f), ndt(g))
        want = jax.jit(jd.givens_jax)(ndt(f), ndt(g))
        assert all(type(v) is ndt for v in got)
        _close([float(v) for v in got], [float(v) for v in want], tol)
        c, s, r = (float(v) for v in got)
        assert abs(c * c + s * s - 1) <= 10 * np.finfo(ndt).eps
        assert abs(-s * f + c * g) <= 10 * np.finfo(ndt).eps * max(abs(f), abs(g), 1e-300) + 1e-300


def _quasi_triangular(R, m, tol):
    for i in range(m - 2):
        assert abs(R[i + 1, i]) <= tol or abs(R[i + 2, i + 1]) <= tol
    assert np.abs(np.tril(R[:m, :m], -2)).max() <= tol


@pytest.mark.parametrize("tdt,ndt,tol", DTYPES)
@pytest.mark.parametrize("seed", range(3))
def test_local_schur_invariants(tdt, ndt, tol, seed):
    m = 12
    H0 = _hessenberg(m, seed, rows=m + 1).astype(ndt)
    H0[m, m - 1] = 0.3
    H, Q = _t(H0, tdt), torch.eye(m, dtype=tdt)
    _, _, ok = dd.local_schur(H, Q, 0, m)
    assert ok
    Hn, Qn = H.double().numpy(), Q.double().numpy()
    A = H0[:m].astype(np.float64)
    eps = 10 * np.finfo(ndt).eps * m
    assert np.linalg.norm(A @ Qn - Qn @ Hn[:m]) <= eps * np.linalg.norm(A)
    assert np.linalg.norm(Qn.T @ Qn - np.eye(m)) <= eps
    _quasi_triangular(Hn, m, 0.0)
    assert Hn[m, m - 1] == H0[m, m - 1]
    lre, lim, _ = dd.eigenvalues(H)
    got = np.sort_complex(lre.double().numpy() + 1j * lim.double().numpy())
    want = np.sort_complex(np.linalg.eigvals(A))
    assert np.abs(got - want).max() <= 1e3 * eps
    # JAX's twin on the same input finds the same spectrum.
    Hj, Qj, okj = jax.jit(jd.local_schur_jax)(_j(H0, ndt), jnp.eye(m, dtype=ndt),
                                              0, m)
    assert bool(okj)
    lj, ij, _ = jax.jit(jd.eigenvalues_jax)(Hj)
    wantj = np.sort_complex(np.asarray(lj, np.float64) + 1j * np.asarray(ij, np.float64))
    assert np.abs(got - wantj).max() <= 1e3 * eps


@pytest.mark.parametrize("tdt,ndt,tol", DTYPES)
def test_local_schur_window_offset(tdt, ndt, tol):
    """QR on the window [lo, hi) keeps the similarity of the whole matrix
    and leaves the leading block and Q outside the window alone."""
    m, lo, hi = 14, 3, 11
    H0 = _hessenberg(m, 5).astype(ndt)
    H0[lo, lo - 1] = 0
    H0[hi, hi - 1] = 0
    H, Q = _t(H0, tdt), torch.eye(m, dtype=tdt)
    _, _, ok = dd.local_schur(H, Q, lo, hi)
    assert ok
    Hn, Qn = H.double().numpy(), Q.double().numpy()
    A = H0.astype(np.float64)
    eps = 10 * np.finfo(ndt).eps * m
    assert np.linalg.norm(A @ Qn - Qn @ Hn) <= eps * np.linalg.norm(A)
    assert np.array_equal(Hn[:lo, :lo], A[:lo, :lo])
    assert np.array_equal(Qn[:lo, :lo], np.eye(lo))
    assert np.array_equal(Qn[hi:, hi:], np.eye(m - hi))
    want = np.sort_complex(np.linalg.eigvals(A[lo:hi, lo:hi]))
    got = np.sort_complex(np.linalg.eigvals(Hn[lo:hi, lo:hi]))
    assert np.abs(got - want).max() <= 1e3 * eps


def test_local_schur_maxiter_flag():
    m = 10
    H0 = _hessenberg(m, 2, rows=m + 1)
    H = _t(H0, torch.float64)
    _, _, ok = dd.local_schur(H, torch.eye(m, dtype=torch.float64), 0, m,
                              maxiter=2)
    assert not ok


def _schur_input(m, seed, ndt):
    """A quasi-triangular (m+1, m) H and its Q from JAX's own QR, with a
    nonzero h_last, as the restart sees them."""
    H0 = _hessenberg(m, seed, rows=m + 1)
    H0[m, m - 1] = 0.37
    Hj, Qj, ok = jax.jit(jd.local_schur_jax)(_j(H0, ndt), jnp.eye(m, dtype=ndt),
                                             0, m)
    assert bool(ok)
    return np.asarray(Hj), np.asarray(Qj)


@pytest.mark.parametrize("tdt,ndt,tol", DTYPES)
@pytest.mark.parametrize("seed", range(3))
def test_eigenvalues_match_jax(tdt, ndt, tol, seed):
    m = 12
    H0, _ = _schur_input(m, seed, ndt)
    lre, lim, starts = dd.eigenvalues(_t(H0, tdt))
    jre, jim, jst = jax.jit(jd.eigenvalues_jax)(_j(H0, ndt))
    _close(lre, jre, tol)
    _close(lim, jim, tol)
    assert starts.tolist() == np.asarray(jst).tolist()
    # Conjugate pairs come from one computation: (re, +im), (re, -im).
    im = lim.numpy()
    for i in np.flatnonzero(im > 0):
        assert lre[i] == lre[i + 1] and im[i + 1] == -im[i]
    assert dd.block_starts(_t(H0, tdt)).tolist() == np.asarray(jst).tolist()


@pytest.mark.parametrize("tdt,ndt,tol", DTYPES)
@pytest.mark.parametrize("lo", [0, 4])
def test_residuals_match_jax(tdt, ndt, tol, lo):
    m = 12
    H0, Q0 = _schur_input(m, 7 + lo, ndt)
    rs = dd.residuals(_t(H0, tdt), _t(Q0, tdt), H0[m, m - 1], lo, m)
    want = jax.jit(jd.residuals_jax, static_argnums=(3, 4))(
        _j(H0, ndt), _j(Q0, ndt), _j(H0[m, m - 1], ndt), lo, m)
    _close(rs, want, tol)
    assert (rs[:lo] == 0).all()


@pytest.mark.parametrize("tdt,ndt,tol", DTYPES)
@pytest.mark.parametrize("which", ["LM", "LR", "SR", "LI", "SI"])
def test_order_key_matches_jax(tdt, ndt, tol, which):
    rng = np.random.default_rng(4)
    re = rng.standard_normal(9).astype(ndt)
    im = np.where(rng.random(9) < 0.5, 0, rng.standard_normal(9)).astype(ndt)
    got = dd.order_key(which, _t(re, tdt), _t(im, tdt))
    want = jd.order_key_jax(which, _j(re, ndt), _j(im, ndt))
    _close(got, want, tol)
    scal = [dd.order_key(which, ndt(a), ndt(b)) for a, b in zip(re, im)]
    assert np.array_equal(np.asarray(scal, dtype=ndt), got.numpy())
    with pytest.raises(ValueError):
        dd.order_key("XX", re, im)


@pytest.mark.parametrize("tdt,ndt,tol", DTYPES)
@pytest.mark.parametrize("lo,hi", [(0, 12), (3, 9), (5, 6)])
def test_restore_arnoldi_matches_jax(tdt, ndt, tol, lo, hi):
    m = 12
    rng = np.random.default_rng(lo * 13 + hi)
    H0 = _quasi_schur(m, 40 + lo, (4,))
    H0[m, m - 1] = 0.25
    Q0 = np.linalg.qr(rng.standard_normal((m, m)))[0]
    H, Q = _t(H0, tdt), _t(Q0, tdt)
    dd.restore_arnoldi(H, Q, lo, hi)
    Hj, Qj = jax.jit(jd.restore_arnoldi_jax, static_argnums=(2, 3))(
        _j(H0, ndt), _j(Q0, ndt), lo, hi)
    _close(H, Hj, 10 * tol)
    _close(Q, Qj, 10 * tol)
    if hi - lo > 1:
        # Q's last row is zero over [lo, hi-1) and the window is
        # Hessenberg again.
        eps = 100 * np.finfo(ndt).eps
        assert np.abs(Q.numpy()[m - 1, lo:hi - 1]).max() <= eps
        assert np.abs(np.tril(H.numpy()[lo:hi, lo:hi], -2)).max() <= eps


def test_tree_sum_order():
    x = torch.tensor([1e8, 1.0, -1e8, 1.0, 3.0], dtype=torch.float32)
    # ((1e8 + 3) + -1e8) + ((1 + 0) + (1 + 0)), in float32.
    want = np.float32(np.float32(np.float32(1e8) + np.float32(3)) - np.float32(1e8)) + np.float32(2)
    assert dd.tree_sum(x).item() == want
    M = torch.arange(12.0).reshape(3, 4)
    assert dd.tree_sum(M).tolist() == [6.0, 22.0, 38.0]
    assert dd.tree_sum(M, 0).tolist() == [12.0, 15.0, 18.0, 21.0]


# --- swaps, partition and sort against the JAX package's host twins ----------


def _np_and_torch(H0, m, tdt):
    return H0.copy(), np.eye(m), _t(H0, tdt), torch.eye(m, dtype=tdt)


@pytest.mark.parametrize("tdt,ndt,tol", DTYPES)
@pytest.mark.parametrize("pairs,i,c11,n11", [((), 3, True, True),
                                             ((4,), 3, True, False),
                                             ((3,), 3, False, True),
                                             ((3, 5), 3, False, False)])
def test_swap_matches_host_twin(tdt, ndt, tol, pairs, i, c11, n11):
    m = 8
    H0 = _quasi_schur(m, 11, pairs).astype(ndt).astype(np.float64)
    Hn, Qn, H, Q = _np_and_torch(H0, m, tdt)
    np_swap(Hn[:m, :], i, c11, n11, Qn)
    dd.swap(H, Q, i, c11, n11)
    _close(H[:m], Hn[:m], tol)
    _close(Q, Qn, tol)


@pytest.mark.parametrize("tdt,ndt,tol", DTYPES)
def test_swap22_matches_jax(tdt, ndt, tol):
    m = 8
    H0 = _quasi_schur(m, 11, (3, 5))
    H, Q = _t(H0, tdt), torch.eye(m, dtype=tdt)
    dd.swap(H, Q, 3, False, False)
    Hj, Qj = jax.jit(jd.swap_jax, static_argnums=(3, 4))(
        _j(H0, ndt), jnp.eye(m, dtype=ndt), 3, False, False)
    _close(H, Hj, tol)
    _close(Q, Qj, tol)


@pytest.mark.parametrize("tdt,ndt,tol", DTYPES)
def test_rotate_right_matches_host_twin(tdt, ndt, tol):
    m = 10
    H0 = _quasi_schur(m, 12, (2, 6)).astype(ndt).astype(np.float64)
    Hn, Qn, H, Q = _np_and_torch(H0, m, tdt)
    np_rotate_right(Hn[:m, :], 0, 8, Qn)
    dd.rotate_right(H, Q, 0, 8)
    _close(H[:m], Hn[:m], 10 * tol)
    _close(Q, Qn, 10 * tol)


def _groups(H0, m, seed):
    rng = np.random.default_rng(seed)
    groups = np.zeros(m, dtype=int)
    i = 0
    while i < m:
        g = int(rng.integers(1, 4))
        if is_start_of_11_block(H0[:m, :], i):
            groups[i] = g
            i += 1
        else:
            groups[i] = groups[i + 1] = g
            i += 2
    return groups


@pytest.mark.parametrize("tdt,ndt,tol", DTYPES)
@pytest.mark.parametrize("seed", range(3))
def test_partition_matches_host_twin(tdt, ndt, tol, seed):
    m = 10
    H0 = _quasi_schur(m, seed + 20, (2, 7)).astype(ndt).astype(np.float64)
    groups = _groups(H0, m, seed)
    Hn, Qn, H, Q = _np_and_torch(H0, m, tdt)
    _partition_three_way(Hn[:m, :], Qn, groups)
    dd.partition_three_way(H, Q, groups)
    _close(H[:m], Hn[:m], 10 * tol)
    _close(Q, Qn, 10 * tol)


def test_partition_matches_jax():
    m = 10
    H0 = _quasi_schur(m, 20, (2, 7))
    groups = _groups(H0, m, 0)
    H, Q = _t(H0, torch.float64), torch.eye(m, dtype=torch.float64)
    dd.partition_three_way(H, Q, groups)
    Hj, Qj = jax.jit(jd.partition_three_way_jax)(
        jnp.asarray(H0), jnp.eye(m), jnp.asarray(groups, dtype=jnp.int32))
    _close(H, Hj, 1e-11)
    _close(Q, Qj, 1e-11)


@pytest.mark.parametrize("tdt,ndt,tol", DTYPES)
@pytest.mark.parametrize("which", ["LM", "SR", "LR"])
def test_sort_schur_matches_host_twin(tdt, ndt, tol, which):
    m = 9
    H0 = _quasi_schur(m, 33, (1, 5)).astype(ndt).astype(np.float64)
    Hn, Qn, H, Q = _np_and_torch(H0, m, tdt)
    _sort_schur(Hn[:m, :], Qn, m, get_order(as_target(which)))
    dd.sort_schur(H, Q, m, which)
    _close(H[:m], Hn[:m], 10 * tol)
    _close(Q, Qn, 10 * tol)


def test_sort_schur_matches_jax():
    m = 9
    H0 = _quasi_schur(m, 33, (1, 5))
    H, Q = _t(H0, torch.float64), torch.eye(m, dtype=torch.float64)
    dd.sort_schur(H, Q, m, "LM")
    Hj, Qj = jax.jit(jd.sort_schur_jax, static_argnums=(3,))(
        jnp.asarray(H0), jnp.eye(m), m, "LM")
    _close(H, Hj, 1e-11)
    _close(Q, Qj, 1e-11)


def test_rotate_right_matches_jax():
    m = 10
    H0 = _quasi_schur(m, 12, (2, 6))
    H, Q = _t(H0, torch.float64), torch.eye(m, dtype=torch.float64)
    dd.rotate_right(H, Q, 0, 8)
    Hj, Qj = jax.jit(jd.rotate_right_jax)(jnp.asarray(H0), jnp.eye(m), 0, 8)
    _close(H, Hj, 1e-11)
    _close(Q, Qj, 1e-11)
