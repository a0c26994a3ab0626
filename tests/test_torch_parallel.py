"""The row-sharded solver (`arnoldimethod_torch.parallel`, `sharding=`)
against the JAX package's single-device solves, on gloo process groups of
CPU processes.

Each world size (1, 2 and 4 ranks) is one job: tests/torch_parallel_worker.py
runs on every rank (spawned processes, a file:// rendezvous under the
test's temporary directory, so parallel test workers never race for a
port), runs every case once and pickles its results; the tests below read
them.  The worker imports only the port; the JAX side runs here.

Tolerances: in float64 from a shared v1, a sharded solve takes the exact
matvec count of the port's unsharded solve and of JAX's single-device
solve, and its eigenvalues agree with both to 1e-10 relative to
max(1, max |lambda|) (the sums over n are
taken in other groupings on P ranks, so the bits differ at rounding level,
as between the two packages).  At one rank the sum over ranks is the local
value and the arithmetic is the unsharded one: Q and R are bitwise equal.
ShardedCsrOperator's rows agree with JAX's to 1e-13 relative; its mode,
footprint and stored count exactly.  The collective budgets are JAX's HLO
tests' (tests/test_hlo_collectives.py, tests/test_lowsync.py), read from
the comm layer's counters.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arnoldimethod_tpu as jam
import arnoldimethod_torch as tam
import torch_parallel_worker as W
from arnoldimethod_tpu.models import problems as jp
from arnoldimethod_tpu.models.operators import CsrOperator as JCsr
from arnoldimethod_tpu.models.operators import DiaOperator as JDia
from arnoldimethod_tpu.models.operators import ShardedCsrOperator as JSharded
from arnoldimethod_tpu.parallel import make_mesh as jax_mesh
from arnoldimethod_tpu.parallel import shard_operator as jax_shard
from arnoldimethod_torch import _device
from arnoldimethod_torch.models import problems as tp
from arnoldimethod_torch.models.operators import DiaOperator

torch.set_num_threads(2)

N = 256


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


def _dense_pattern():
    """JAX's uniform random 64-a-row pattern (auto must pick "all")."""
    rng = np.random.default_rng(0)
    idx = np.stack([rng.permutation(N) for _ in range(N)])[:, :64]
    return np.arange(N + 1) * 64, np.sort(idx, axis=1).ravel()


def _inputs(world):
    rng = np.random.default_rng(11)
    inp = dict(
        v1_256=rng.standard_normal(N),
        v1_1024=rng.standard_normal(1024),
        v1_48=rng.standard_normal(48) + 1j * rng.standard_normal(48),
        A48=rng.standard_normal((48, 48)) + 1j * rng.standard_normal((48, 48)),
        x_256=np.linspace(-1, 1, N),
    )
    inp["dense_indptr"], inp["dense_indices"] = _dense_pattern()
    rng16 = np.random.default_rng(16)
    inp["dia16"], inp["x_16"] = (rng16.standard_normal((3, 16)),
                                 rng16.standard_normal(16))
    _, indptr, indices, data = W.banded_csr(N)
    for mode in ("all", "footprint") if world > 1 else ("all",):
        sop = JSharded.build(indptr, indices, data, (N, N), jax_mesh(world),
                             gather=mode)
        for i, a in enumerate(sop.arrs):
            inp[f"jax_{mode}_{i}"] = np.asarray(a)
    return inp


def _run_job(world, tmp):
    np.savez(tmp / "inputs.npz", **_inputs(world))
    return W.spawn(world, tmp)


class Job:
    def __init__(self, world, ranks):
        self.world, self.ranks = world, ranks

    def case(self, name):
        """The case's result on every rank; fails with a rank's traceback."""
        got = [r[name] for r in self.ranks]
        for rank, res in enumerate(got):
            if isinstance(res, dict) and "error" in res:
                pytest.fail(f"rank {rank} of {self.world}:\n{res['error']}")
        return got


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def job(request, tmp_path_factory):
    world = request.param
    return Job(world, _run_job(world, tmp_path_factory.mktemp(f"p{world}")))


@pytest.fixture(scope="module")
def job1(tmp_path_factory):
    return Job(1, _run_job(1, tmp_path_factory.mktemp("p1")))


# -- the solves --------------------------------------------------------------

_CACHE = {}


def _reference(name):
    """(port unsharded, JAX single-device) results of a solve case, once."""
    if name not in _CACHE:
        inp = _inputs(1)
        build, kw = W.SOLVES[name]
        kw = dict(kw, v1=inp[kw["v1"]])
        d0, h0 = tam.partial_schur(build(inp), **kw)
        jkw = dict(kw)
        jkw.setdefault("method", "host")
        if name == "shift_invert":
            jop = jam.TridiagonalShiftInvertOperator.build(
                np.full(1023, -1.0), np.full(1024, 2.0), np.full(1023, -1.001),
                sigma=0.0, dtype=np.float64)
        elif name in ("split_complex", "lowsync_complex"):
            jop = inp["A48"]
        elif name == "ell":
            jop = jp.laplacian_1d(N, fmt="ell")
        elif name == "powerlaw":
            jop = JCsr(*W.powerlaw_csr(N, seed=2)[1:], (N, N))
        elif name == "lap2d":
            jop = jp.laplacian_2d(16, 16)
        elif name == "wide_dia":
            jop = JDia(*W.wide_band(N, 100), (N, N))
        else:
            jop = jp.laplacian_1d(N)
        dj, hj = jam.partial_schur(jop, **jkw)
        _CACHE[name] = (W._summary(d0, h0), dict(
            mvproducts=hj.mvproducts, converged=hj.converged,
            eigenvalues=np.asarray(dj.eigenvalues)))
    return _CACHE[name]


def _close(a, b, tol=1e-10):
    """Equal up to tol relative to max(1, max |b|) (the shift-invert
    spectrum reaches 1.7e4), as tests/test_torch_shift_invert.py does."""
    a, b = np.sort_complex(np.asarray(a)), np.sort_complex(np.asarray(b))
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


def _check_solve(job, name):
    got = job.case(name)
    port, jax_ = _reference(name)
    assert jax_["converged"] and port["converged"]
    for res in got:  # every rank: the same counts
        assert res["converged"]
        assert res["mvproducts"] == port["mvproducts"] == jax_["mvproducts"]
        assert res["restarts"] == got[0]["restarts"]
        _close(res["eigenvalues"], port["eigenvalues"])
        _close(res["eigenvalues"], jax_["eigenvalues"])
    return got


def _dense(op, n):
    return np.stack([op.matvec(torch.eye(n, dtype=op.dtype)[:, i]).numpy()
                     for i in range(n)], axis=1)


def test_sharded_dgks_matches_single_device(job):
    got = _check_solve(job, "dgks")
    exact = np.sort(2 - 2 * np.cos(np.pi * np.arange(1, N + 1) / (N + 1)))[:4]
    _close(got[0]["eigenvalues"].real, exact, 1e-8)


def test_sharded_lowsync_exact_spectrum(job):
    got = _check_solve(job, "lowsync")
    exact = np.sort(2 - 2 * np.cos(np.pi * np.arange(1, N + 1) / (N + 1)))[:4]
    _close(got[0]["eigenvalues"].real, exact, 1e-8)


def test_sharded_device_method(job):
    _check_solve(job, "device")


def test_sharded_split_complex(job):
    _check_solve(job, "split_complex")


def test_sharded_lowsync_complex(job):
    _check_solve(job, "lowsync_complex")


def test_sharded_shift_invert_solve(job):
    _check_solve(job, "shift_invert")


def test_sharded_ell(job):
    _check_solve(job, "ell")


def test_sharded_powerlaw_csr_residual(job):
    got = _check_solve(job, "powerlaw")
    A = W.powerlaw_csr(N, seed=2)[0]
    Q, R = got[0]["Q"], got[0]["R"]
    assert np.linalg.norm(A @ Q - Q @ R) < 1e-6 * np.linalg.norm(A)


def test_sharded_laplacian_2d_residual(job):
    got = _check_solve(job, "lap2d")
    A = _dense(tp.laplacian_2d(16, 16), N)
    Q, R = got[0]["Q"], got[0]["R"]
    assert np.linalg.norm(A @ Q - Q @ R) < 1e-6


def test_sharded_wide_band_dia_solve(job):
    """A DIA band of +-100 at N = 256, wider than a rank's 64 rows at 4
    ranks (the halo reaches ranks +-2): JAX's single-device count, the
    port's unsharded count, the eigenvalues to 1e-10 and the Schur
    residual."""
    got = _check_solve(job, "wide_dia")
    A = _dense(DiaOperator(*W.wide_band(N, 100), (N, N)), N)
    Q, R = got[0]["Q"], got[0]["R"]
    assert np.linalg.norm(A @ Q - Q @ R) < 1e-8


def test_q_is_a_dtensor_sharded_over_the_mesh(job):
    for res in job.case("dgks"):
        assert res["q_type"] == "DTensor"
        assert res["q_placements"] == [("Shard", 0)]
        assert res["q_mesh_size"] == job.world
        assert res["q_local_rows"] == N // job.world
        Q = res["Q"]
        assert np.abs(Q.T @ Q - np.eye(Q.shape[1])).max() < 1e-12


def test_partial_eigen_keeps_the_sharding(job):
    res = job.case("dgks")[0]
    assert res["eigen_type"] == "DTensor"
    A = _dense(tp.laplacian_1d(N), N)
    X, vals = res["eigen_vectors"], res["eigen_values"]
    assert np.linalg.norm(A @ X - X * vals, axis=0).max() < 1e-7


# -- ShardedCsrOperator --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_csr(mat, world, mode):
    """JAX's ShardedCsrOperator of a test matrix on a `world`-device mesh
    and its matvec of linspace(-1, 1, N)."""
    if mat == "banded":
        indptr, indices, data = W.banded_csr(N)[1:]
    elif mat == "powerlaw":
        indptr, indices, data = W.powerlaw_csr(N, 1)[1:]
    else:
        (indptr, indices), data = _dense_pattern(), np.ones(N * 64)
    sop = JSharded.build(indptr, indices, data, (N, N), jax_mesh(world),
                         gather=mode)
    y = np.asarray(sop.matvec(jnp.asarray(np.linspace(-1, 1, N))))
    return sop, y


@pytest.mark.parametrize("mat", ["banded", "powerlaw", "dense"])
def test_sharded_csr_matvec_matches_jax(job, mat):
    got = job.case("csr")
    for mode in ("auto", "all", "footprint"):
        sop, y = _jax_csr(mat, job.world, mode)
        rows = np.concatenate([r[mat, mode]["y"] for r in got])
        assert np.abs(rows - y).max() <= 1e-13 * np.abs(y).max()
        for r in got:
            assert r[mat, mode]["mode"] == sop.mode
            assert r[mat, mode]["footprint_elems"] == sop.footprint_elems
            assert r[mat, mode]["nnz"] == sop.nnz
        if sop.mode == "footprint":
            send = np.asarray(sop.send_idx)
            for d, r in enumerate(got):
                assert np.array_equal(r[mat, mode]["send_idx"], send[d])


def test_sharded_csr_auto_rule(job):
    got = job.case("csr")[0]
    assert got["banded", "auto"]["mode"] == "footprint"
    assert got["banded", "auto"]["footprint_elems"] <= 3
    assert got["dense", "auto"]["mode"] == "all"


def test_sharded_csr_footprint_moves_the_footprint(job):
    """One footprint matvec: a single all_to_all of (P - 1) F elements a
    rank, no all-gather; the all-gather mode moves n - n/P."""
    for r in job.case("csr"):
        fp = r["banded", "footprint"]
        F = fp["footprint_elems"]
        assert fp["collectives"]["all_gather"]["calls"] == 0
        assert fp["collectives"]["all_to_all"] == {
            "calls": 1, "bytes": (job.world - 1) * F * 8}
        assert (job.world - 1) * F * 8 < (N - N // job.world) * 8 / 2
        al = r["banded", "all"]["collectives"]
        assert al["all_gather"] == {"calls": 1,
                                    "bytes": (N - N // job.world) * 8}


def test_convert_sharded_csr_matches_jax_shard(job):
    """operator_from_arrays("sharded_csr") from JAX's arrays: rank d's
    matvec rows equal JAX's shard d."""
    got = job.case("convert")
    for mode in ("all", "footprint"):
        sop, y = _jax_csr("banded", job.world, mode)
        shards = y.reshape(job.world, -1)
        for d, r in enumerate(got):
            assert r[mode]["mode"] == mode
            assert r[mode]["footprint_elems"] == sop.footprint_elems
            assert np.abs(r[mode]["y"] - shards[d]).max() <= (
                1e-13 * np.abs(y).max())


# -- collective budgets (JAX's HLO tests) -----------------------------------


def test_dgks_step_collective_budget(job):
    """Each DGKS step on the sharded DIA operator at n = 1024, m = 20: at
    most 8 all-reduces of at most 6 (m + 1) 8 bytes, a halo of at most 64
    elements, no all-gather and no all-to-all."""
    for r in job.case("budget"):
        m = r["m"]
        for step in r["steps"]:
            assert 1 <= step["all_reduce"]["calls"] <= 8
            assert step["all_reduce"]["bytes"] <= 6 * (m + 1) * 8
            assert step["halo"]["calls"] >= 1
            assert step["halo"]["bytes"] <= 64 * 8
            assert step["all_gather"]["calls"] == 0
            assert step["all_to_all"]["calls"] == 0


def test_basis_change_is_communication_free(job):
    for r in job.case("budget"):
        assert all(v["calls"] == 0 for v in r["basis"].values())


def test_lowsync_fewer_all_reduces(job):
    for r in job.case("budget"):
        dgks = sum(s["all_reduce"]["calls"] for s in r["steps"])
        assert r["lowsync"]["all_reduce"]["calls"] == 2 * len(r["steps"])
        assert r["lowsync"]["all_reduce"]["calls"] < dgks


# -- the halo: any band (F8) --------------------------------------------------


def _check_halo(job):
    """Every rank's RowComm.halo of x = 1..16 equals the slice of the
    zero-padded global x; one all_to_all_single when P > 1 and the halo is
    not empty, receiving the halo's entries that lie in [0, n)."""
    n, P = 16, job.world
    nl = n // P
    x = np.arange(1.0, n + 1.0)
    got = job.case("halo")
    for r, res in enumerate(got):
        keys = [k for k in res if isinstance(k, tuple)]
        assert {min(nl, n - 1), n - 1} <= {lo for lo, _ in keys}
        for lo, hi in keys:
            want = np.pad(x, (lo, hi))[r * nl:r * nl + nl + lo + hi]
            assert np.array_equal(res[lo, hi]["y"], want), (r, lo, hi)
            inside = (min(lo, r * nl) + min(hi, n - (r + 1) * nl)
                      if P > 1 and lo + hi > 0 else 0)
            halo = res[lo, hi]["collectives"]["halo"]
            assert halo == {"calls": int(P > 1 and lo + hi > 0),
                            "bytes": 8 * inside}, (r, lo, hi)
        pairs = np.pad(x, (5, n - 1))[r * nl:r * nl + nl + 5 + n - 1]
        assert np.array_equal(res["pairs"], np.stack((pairs, -pairs), axis=1))
        assert res["refused"][0] == "ValueError"


def test_halo_is_the_padded_slice(job):
    _check_halo(job)


def test_one_rank_halo_is_the_padded_slice(job1):
    _check_halo(job1)


def test_wide_band_dia_matvec_matches_jax(job):
    """F8 at its size: offsets (-5, 0, 5) at n = 16 (a rank's 4 rows at 4
    ranks): the sharded matvec and matvec_df are the unsharded ones bit
    for bit (the same shifted products in the same order), and the matvec
    equals JAX's on a mesh of as many CPU devices; one halo a matvec."""
    inp = _inputs(1)
    op = DiaOperator(inp["dia16"], (-5, 0, 5), (16, 16))
    x = torch.from_numpy(inp["x_16"])
    got = job.case("wide_matvec")
    assert all(r["operator"] == "_ShardedDia" for r in got)
    assert all(r["collectives"]["halo"]["calls"] == 1 for r in got)
    y = np.concatenate([r["y"] for r in got])
    assert np.array_equal(y, op.matvec(x).numpy())
    yh, yl = op.matvec_df(x, x * 2.0 ** -60)
    assert np.array_equal(np.concatenate([r["yh"] for r in got]), yh.numpy())
    assert np.array_equal(np.concatenate([r["yl"] for r in got]), yl.numpy())
    jop = jax_shard(JDia(inp["dia16"], (-5, 0, 5), (16, 16)), jax_mesh(job.world))
    yj = np.asarray(jop.matvec(jnp.asarray(inp["x_16"])))
    assert np.abs(y - yj).max() <= 1e-14 * np.abs(yj).max()


# -- checkpoints, refusals ----------------------------------------------------


def test_sharded_checkpoint_loads_in_jax(job):
    """Rank 0 writes the global checkpoint; JAX's loader reads it and its
    warm start takes the count of the port's sharded warm start, as does
    the port's unsharded one."""
    got = job.case("checkpoint")
    path = got[0]["path"]
    assert all(r["local_cols"] == (21, N // job.world) for r in got)
    start = got[0]["first"]["nconverged"]
    jws = jam.ArnoldiWorkspace.load(path)
    assert np.asarray(jws.V).shape == (21, N)
    dj, hj = jam.partial_schur(jp.laplacian_1d(N), workspace=jws,
                               start_from=start, nev=6, which="SR", tol=1e-8,
                               method="host")
    ws = tam.ArnoldiWorkspace.load(path)
    d0, h0 = tam.partial_schur(tp.laplacian_1d(N), workspace=ws,
                               start_from=start, nev=6, which="SR", tol=1e-8)
    for r in got:
        assert r["warm"]["converged"]
        assert r["warm"]["mvproducts"] == hj.mvproducts == h0.mvproducts
        _close(r["warm"]["eigenvalues"], dj.eigenvalues)


def test_sharded_refusals(job):
    for r in job.case("errors"):
        # extended=True with sharding= runs since the double-word sum over
        # the ranks (tests/test_torch_parallel_extended.py holds it).
        assert r["extended"]["converged"] and r["extended"]["nconverged"] >= 2
        assert r["not_a_descriptor"][0] == "TypeError"
        assert "basis_sharding" in r["not_a_descriptor"][1]
        assert r["vector_descriptor"][0] == "ValueError"
        assert "basis_sharding" in r["vector_descriptor"][1]
        assert r["mesh_size"][0] == "ValueError"
        assert r["pod_mesh"] == (("rows",), job.world)
        for key in ("uneven", "uneven_csr"):
            assert r[key][0] == "ValueError" and "divisible" in r[key][1]


# -- one rank: the unsharded arithmetic, bit for bit --------------------------


@pytest.mark.parametrize("name", list(W.SOLVES))
def test_one_rank_is_bitwise_unsharded(job1, name):
    res = job1.case(name)[0]
    base = res["unsharded"]
    assert res["mvproducts"] == base["mvproducts"]
    assert res["restarts"] == base["restarts"]
    for a, b in ((res["Q_local"], base["Q"]), (res["R"], base["R"]),
                 (res["eigenvalues"], base["eigenvalues"])):
        assert a.shape == b.shape and np.array_equal(a, b)
        assert np.array_equal(np.signbit(np.real(a)), np.signbit(np.real(b)))


def test_one_rank_refusals(job1):
    r = job1.case("errors")[0]
    assert r["footprint_one_rank"][0] == "ValueError"
    assert "2 devices" in r["footprint_one_rank"][1]
    assert r["extended"]["converged"] and r["extended"]["nconverged"] >= 2
    assert r["pod_mesh"] == (("rows",), 1)
