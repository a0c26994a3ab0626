"""The port's `partial_schur(..., method="device")` (arnoldimethod_torch/
fused.py, the plain dense restart on the CPU) against the JAX package's
`method="device"` from the same start vector.

Tolerances: counted cases take JAX's exact matvec and restart counts and
nconverged; eigenvalues agree to 1e-5 in float32 (the dense work runs in
float32 in both, summed in different orders) and to 1e-9 in float64.
JAX's device solves compile for 11-13 s each on the CPU, so three
signatures run here (README config in float32 and float64, the 80 x 80 LM
case); the other counted cases are held to JAX's host method in float64,
whose counts the JAX package's own tests hold equal to its device counts
(tests/test_fused.py).  Breakdowns reinitialize from random rows, whose
streams differ between jax.random and torch.Generator, so those cases are
held to convergence and the Schur relation, and the device expansion is
held bit for bit to the port's host `expand_range`.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arnoldimethod_tpu as jam
import arnoldimethod_torch as tam
from arnoldimethod_tpu.models import problems as jp
from arnoldimethod_torch import _device, fused
from arnoldimethod_torch.models import problems as tp
from arnoldimethod_torch.models.operators import DenseOperator
from arnoldimethod_torch.ops import expansion as texp

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
EPS = np.finfo(np.float64).eps


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


README = dict(nev=10, which="SR", tol=1e-6)


def _v1(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def _close_eigs(a, b, tol):
    assert np.abs(np.sort_complex(np.asarray(a)) - np.sort_complex(np.asarray(b))).max() <= tol


def _schur(A, decomp, tol):
    Q = decomp.Q.double().numpy()
    R = np.asarray(decomp.R, dtype=np.float64)
    assert np.linalg.norm(A @ Q - Q @ R) <= tol * max(1.0, np.linalg.norm(A))
    assert np.linalg.norm(Q.T @ Q - np.eye(Q.shape[1])) <= max(tol, 1e-10)


def _same_counts(h, hj):
    assert (h.mvproducts, h.restarts, h.nconverged) == (
        hj.mvproducts, hj.restarts, hj.nconverged)


@pytest.mark.parametrize("ndt,tol", [(np.float32, 1e-5), (np.float64, 1e-9)])
def test_readme_config_matches_jax_device(ndt, tol):
    v1 = _v1(100)
    dj, hj = jam.partial_schur(jp.laplacian_1d(100, dtype=ndt), v1=v1,
                               method="device", **README)
    d, h = tam.partial_schur(tp.laplacian_1d(100, dtype=ndt), v1=v1,
                             method="device", **README)
    _same_counts(h, hj)
    assert h.converged and h.purges == hj.purges
    if ndt == np.float32:
        assert (h.mvproducts, h.restarts) == (167, 19)
    _close_eigs(d.eigenvalues, dj.eigenvalues, tol)
    assert d.Q.dtype == torch.from_numpy(np.zeros(1, ndt)).dtype
    assert h.timings["dense"] == 0.0 and h.timings["device"] > 0
    # One state read a restart (no rollback here) and the final readback.
    assert h.host_syncs == h.restarts + 1
    exact = np.sort(2 - 2 * np.cos(np.pi * np.arange(1, 101) / 101))[:10]
    assert np.abs(np.sort(d.eigenvalues.real) - exact).max() <= 10 * tol + 1e-5


def test_lm_conjugate_pairs_match_jax_device():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((80, 80))
    v1 = _v1(80, 5)
    dj, hj = jam.partial_schur(A, v1=v1, nev=6, which="LM", tol=1e-9,
                               method="device")
    d, h = tam.partial_schur(A, v1=v1, nev=6, which="LM", tol=1e-9,
                             method="device")
    _same_counts(h, hj)
    assert (h.mvproducts, h.restarts) == (166, 19)
    assert len(d.eigenvalues) == len(dj.eigenvalues)
    assert np.any(d.eigenvalues.imag != 0)
    _close_eigs(d.eigenvalues, dj.eigenvalues, 1e-8)
    _schur(A, d, 1e-8)


def _purge_case():
    n = 100
    dvals = np.concatenate([[11.0, 10.999, 10.0, 9.5, 9.0],
                            np.linspace(1.0, 8.0, n - 5)])
    v1 = np.ones(n)
    v1[0] = v1[1] = 1e-12
    return np.diag(dvals), v1


def test_purge_path_matches_jax():
    A, v1 = _purge_case()
    kw = dict(v1=v1, nev=3, which="LM", tol=1e-8)
    dj, hj = jam.partial_schur(A, method="host", **kw)
    d, h = tam.partial_schur(A, method="device", **kw)
    _same_counts(h, hj)
    assert h.purges == hj.purges > 0
    got = np.sort(d.eigenvalues.real)[::-1][:3]
    assert np.abs(got - [11.0, 10.999, 10.0]).max() <= 1e-6


def test_restart_limit_matches_jax():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((300, 300))
    kw = dict(v1=_v1(300, 4), nev=8, tol=1e-14, restarts=1)
    dj, hj = jam.partial_schur(A, method="host", **kw)
    d, h = tam.partial_schur(A, method="device", **kw)
    assert not h.converged
    _same_counts(h, hj)
    assert h.restarts == 1


def test_zero_restarts_runs_no_dense_phase():
    d, h = tam.partial_schur(_purge_case()[0], v1=_v1(100), nev=3,
                             restarts=0, method="device")
    assert (h.mvproducts, h.restarts, h.nconverged) == (20, 0, 0)


def test_warm_start():
    """nev=3, then on to nev=5 from the locked decomposition
    (tests/test_fused.py's warm start)."""
    rng = np.random.default_rng(7)
    A = rng.standard_normal((100, 100))
    ws = tam.ArnoldiWorkspace(100, 20, dtype=torch.float64, device="cpu")
    F, h1 = tam.partial_schur(A, workspace=ws, v1=_v1(100, 8), nev=3,
                              tol=1e-12, method="device")
    assert h1.converged
    _schur(A, F, 1e-9)
    F2, h2 = tam.partial_schur(A, workspace=ws, nev=5,
                               start_from=h1.nconverged, tol=1e-8,
                               method="device")
    assert h2.converged and h2.nconverged >= 5
    _schur(A, F2, 1e-6)
    assert h2.mvproducts < h1.mvproducts + 100


@pytest.mark.parametrize("first,second", [("host", "device"),
                                          ("device", "host")])
def test_warm_start_crosses_methods(first, second):
    rng = np.random.default_rng(9)
    A = rng.standard_normal((100, 100))
    ws = tam.ArnoldiWorkspace(100, 20, dtype=torch.float64, device="cpu")
    F, h1 = tam.partial_schur(A, workspace=ws, v1=_v1(100, 1), nev=3,
                              tol=1e-10, method=first)
    assert h1.converged
    F2, h2 = tam.partial_schur(A, workspace=ws, nev=5,
                               start_from=h1.nconverged, tol=1e-8,
                               method=second)
    assert h2.converged and h2.nconverged >= 5
    _schur(A, F2, 1e-6)
    assert ws.Vlo is None and ws.Hlo is None


def test_rank3_breakdown():
    """A rank-3 matrix breaks down inside the loop: converged in exactly
    7 matvecs (ref: test/partial_schur.jl:19-22)."""
    rng = np.random.default_rng(1)
    W = rng.standard_normal((10, 3))
    B = W @ W.T
    texp.LOWSYNC.rollbacks = 0
    d, h = tam.partial_schur(B, v1=_v1(10), nev=5, mindim=5, maxdim=7,
                             tol=EPS, method="device")
    assert h.converged and h.mvproducts == 7
    _schur(B, d, 1e-10)
    assert np.linalg.norm(np.sort(d.eigenvalues.real)[:2]) <= 1e-8 * np.linalg.norm(B)
    assert h.host_syncs <= h.restarts + texp.LOWSYNC.rollbacks + 1


def test_zero_matrix():
    texp.LOWSYNC.rollbacks = 0
    d, h = tam.partial_schur(np.zeros((5, 5)), v1=np.ones(5), method="device")
    assert h.converged and h.nconverged == 5 and h.mvproducts == 5
    Q = d.Q.numpy()
    assert np.linalg.norm(Q.T @ Q - np.eye(5)) <= 100 * EPS
    assert texp.LOWSYNC.rollbacks >= 4
    assert h.host_syncs == h.restarts + texp.LOWSYNC.rollbacks + 1


def test_bsr_operator():
    """A small block-sparse operator through method="device" takes the
    host method's float64 counts and spectrum."""
    sp = pytest.importorskip("scipy.sparse")
    rng = np.random.default_rng(6)
    dense = np.kron(np.eye(24), rng.standard_normal((4, 4)))
    dense += np.diag(rng.standard_normal(95), 1)
    S = sp.csr_matrix(dense)
    kw = dict(v1=_v1(96, 2), nev=4, which="LM", tol=1e-10,
              sparse_format="bsr")
    d0, h0 = tam.partial_schur(S, method="host", **kw)
    d, h = tam.partial_schur(S, method="device", **kw)
    assert h.converged
    assert (h.mvproducts, h.restarts) == (h0.mvproducts, h0.restarts)
    _close_eigs(d.eigenvalues, d0.eigenvalues, 1e-9)
    _schur(dense, d, 1e-9)


@pytest.mark.parametrize("kw,err,match", [
    (dict(lowsync=True), ValueError, "host-method"),
    (dict(extended=True), ValueError, "not compatible"),
    # sharding= is ported; it takes parallel.basis_sharding(mesh) only.
    (dict(sharding=object()), TypeError, "basis_sharding"),
])
def test_rejections(kw, err, match):
    with pytest.raises(err, match=match):
        tam.partial_schur(np.eye(20), nev=2, method="device", **kw)


def test_rejects_complex():
    A = np.diag(np.arange(1, 21).astype(np.complex128))
    with pytest.raises(ValueError, match="real dtypes"):
        jam.partial_schur(A, nev=2, method="device")
    with pytest.raises(ValueError, match="real dtypes"):
        tam.partial_schur(A, nev=2, method="device")
    with pytest.raises(ValueError, match="split-complex"):
        tam.partial_schur(A, nev=2, method="device", split_complex=True)


def _two_cycles(n=10):
    P = np.zeros((n, n))
    for cycle in (range(3), range(3, n)):
        c = list(cycle)
        for a, b in zip(c, c[1:] + c[:1]):
            P[b, a] = 1.0
    e0 = np.zeros(n)
    e0[0] = 1.0
    return P, e0


def _two_blocks():
    rng = np.random.default_rng(5)
    A = np.zeros((10, 10))
    A[:3, :3] = rng.standard_normal((3, 3))
    A[3:, 3:] = rng.standard_normal((7, 7))
    v1 = np.zeros(10)
    v1[:3] = rng.standard_normal(3)
    return A, v1


@pytest.mark.parametrize("case,want", [
    (_two_cycles, [2, 9]),
    (_two_blocks, [2, 9]),
    (lambda: (np.zeros((10, 10)), np.full(10, 0.5)), list(range(10))),
], ids=["two_cycles", "two_blocks", "zero"])
def test_device_expansion_is_the_host_one(case, want):
    """Bit for bit: the device expansion, its flags settled as the fused
    loop settles them, against the host DGKS `expand_range` (exact
    closures, so steps break down mid-range)."""
    A, v1 = case()
    m, n = 10, 10
    out = []
    for device in (False, True):
        op = DenseOperator(A)
        V = torch.zeros((m + 1, n), dtype=torch.float64)
        H = torch.zeros((m + 1, m), dtype=torch.float64)
        texp.set_initial_vector(V, torch.from_numpy(v1))
        gen = torch.Generator().manual_seed(3)
        broke = []
        if device:
            flags = torch.zeros(m, dtype=H.dtype)
            texp.expand_range_device(op, V, H, 0, m, flags)
            while (j := torch.nonzero(flags).flatten().tolist()):
                broke.append(j[0])
                fused._roll_back(op, V, H, flags, j[0], m, gen)
        else:
            texp.expand_range(op, V, H, 0, m, gen)
        out.append((V, H, broke))
    (V1, H1, _), (V2, H2, broke) = out
    assert torch.equal(V1, V2) and torch.equal(H1, H2)
    assert broke == want
    assert bool(torch.isfinite(V2).all())


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|arnoldimethod_tpu)\b", re.M)
    files = sorted((REPO / "arnoldimethod_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert bad == []
