"""extended=True with sharding= (the double-word sums over the ranks:
`parallel.comm.RowComm.gather_partials`, folded by `ops.df.df_axpy_gathered`
and df_normalize's step form inside a Krylov step, by `RowComm.df_sum` and
`ops.df.df_rank_sum` elsewhere) on gloo process groups of 1, 2 and 4 CPU
processes, against the unsharded port and the JAX package's single-device
solves.

Each world size is one job of tests/torch_parallel_worker.py's "extended"
cases (the jobs of tests/test_torch_parallel.py run the others).  What the
tests hold:

  - one rank: the sums over the ranks are the partials themselves, so
    each solve is the unsharded one bit for bit (Q, Q_lo, R, R_lo, counts
    and host reads);
  - 2 and 4 ranks: a sum over n is a local tree and then a tree over the
    ranks, which differs from one tree over the global index in low
    words, so the bits differ from the unsharded solve's; every rank
    gets the same sums, so the ranks agree bit for bit (counts and R),
    and the solves take JAX's single-device counts (float32 words) or the
    port's unsharded count (float64 words: the port's Dekker split is not
    JAX's, ROADMAP.md §3), with residuals below 1e-11 in float64 (float32
    words) and an exact-rational residual below the tolerance (float64
    words);
  - the sharded range is bitwise the sharded stepwise range (its plain
    reference), rollbacks included;
  - a Krylov step makes three double-word sums and the operator's
    exchange, no all-reduce; the basis change makes no collective;
  - a sharded extended checkpoint holds the global low word (F7).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import arnoldimethod_tpu as jam
import arnoldimethod_torch as tam
import torch_parallel_worker as W
from arnoldimethod_tpu.models import problems as jp
from arnoldimethod_tpu.models.operators import DiaOperator as JDia
from arnoldimethod_torch import _device
from arnoldimethod_torch.models import problems as tp

torch.set_num_threads(2)

N = 256


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port's entry points default to the card; these tests ask for
    the CPU (module scope: module fixtures build operators too)."""
    saved, _device.DEFAULT = _device.DEFAULT, "cpu"
    yield
    _device.DEFAULT = saved


def _inputs():
    return dict(v1_256=np.random.default_rng(11).standard_normal(N),
                # Config 3's 16^2 count is JAX's from numpy seed 0 (357,
                # tests/test_torch_conv_parity.py).
                v1_conv=np.random.default_rng(0).standard_normal(N),
                v1_40=np.random.default_rng(12).standard_normal(40))


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


def _jax_counts(inp):
    """JAX's single-device (mvproducts, restarts) of the float32-word
    cases from the same v1."""
    ops = {"ext_lap256": jp.laplacian_1d(N, dtype=np.float32),
           "ext_conv16": jp.convection_diffusion_2d(
               16, peclet=68.0, dtype=np.float32, fmt="stencil"),
           "ext_wide": JDia(*W.wide_band(N, 100, np.float32), (N, N))}
    out = {}
    for name, jop in ops.items():
        kw = W.EXT_SOLVES[name][1]
        _, hj = jam.partial_schur(jop, method="host", extended=True,
                                  **dict(kw, v1=inp[kw["v1"]]))
        assert hj.converged
        out[name] = (hj.mvproducts, hj.restarts)
    return out


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The jobs of 1, 2 and 4 ranks, started together; JAX's counts are
    taken while they run.  (jobs by world, JAX's counts by case.)"""
    inp = _inputs()
    started = {}
    for world in (1, 2, 4):
        tmp = tmp_path_factory.mktemp(f"ext{world}")
        np.savez(tmp / "inputs.npz", **inp)
        started[world] = (tmp, W.start(world, tmp, "extended"))
    try:
        counts = _jax_counts(inp)
    finally:
        done = {world: Job(world, W.finish(procs, tmp))
                for world, (tmp, procs) in started.items()}
    return done, counts


@pytest.fixture(params=[2, 4], ids=["P2", "P4"])
def job(request, jobs):
    return jobs[0][request.param]


@pytest.fixture
def job1(jobs):
    return jobs[0][1]


@pytest.fixture
def job2(jobs):
    return jobs[0][2]


@pytest.fixture
def jax_counts(jobs):
    return jobs[1]


def _unsharded(job1, name):
    """The port's unsharded solve of a case (job1 runs it beside the
    one-rank solve)."""
    return job1.case(name)[0]["unsharded"]


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and np.array_equal(a, b)
            and np.array_equal(np.signbit(np.real(a)), np.signbit(np.real(b))))


def _dense(op, n):
    return np.stack([op.matvec(torch.eye(n, dtype=torch.float64)[:, i]).numpy()
                     for i in range(n)], axis=1)


def _frac(hi, lo):
    out = np.empty(hi.shape, dtype=object)
    for idx in np.ndindex(hi.shape):
        out[idx] = Fraction(float(hi[idx])) + Fraction(float(lo[idx]))
    return out


def _exact_lap_residual(Q, Q_lo, R, R_lo):
    """||A Q - Q R|| of the 1-D Laplacian in exact rationals over the two
    words of Q and R."""
    Qf, Rf = _frac(Q, Q_lo), _frac(R, R_lo)
    AQ = 2 * Qf
    AQ[:-1] -= Qf[1:]
    AQ[1:] -= Qf[:-1]
    return float(sum(v * v for v in (AQ - Qf @ Rf).ravel())) ** 0.5


# -- one rank: the unsharded solve, bit for bit --------------------------------


@pytest.mark.parametrize("name", list(W.EXT_SOLVES))
def test_one_rank_extended_is_bitwise_unsharded(job1, jax_counts, name):
    res = job1.case(name)[0]
    base = res["unsharded"]
    for key in ("mvproducts", "restarts", "nconverged", "host_syncs"):
        assert res[key] == base[key], key
    pairs = [(res["Q_local"], base["Q"]), (res["R"], base["R"]),
             (res["eigenvalues"], base["eigenvalues"])]
    if "Q_lo" in base:
        pairs += [(res["Q_lo_local"], base["Q_lo"]), (res["R_lo"], base["R_lo"])]
    for a, b in pairs:
        assert _bitwise(a, b)
    if name in jax_counts:
        assert (res["mvproducts"], res["restarts"]) == jax_counts[name]


def test_one_rank_sums_gather_and_launch(job1):
    """At one rank the sums still go through the gather and the rank sum:
    three a Krylov step, no bytes received, no all-reduce in a step."""
    res = job1.case("ext_budget")[0]
    for step in res["steps"]:
        assert step["df_sum"] == {"calls": 3, "bytes": 0}
        assert all(step[k]["calls"] == 0 for k in (
            "all_reduce", "all_gather", "all_to_all", "halo"))


# -- 2 and 4 ranks -------------------------------------------------------------


@pytest.mark.parametrize("name", ["ext_lap256", "ext_conv16", "ext_wide"])
def test_sharded_f32_words_take_jax_counts(job, job1, jax_counts, name):
    """Every rank: JAX's single-device count from the same v1, the same R
    bit for bit, Q placed Shard(0) over the mesh, and the Schur residual
    below 1e-11 in float64.  ext_wide's band of +-100 is wider than a
    rank's 64 rows at 4 ranks (F8)."""
    got = job.case(name)
    port = _unsharded(job1, name)
    op = W.EXT_SOLVES[name][0](None)
    A = _dense(op, N)
    want = "GatheredOperator" if name == "ext_conv16" else "_ShardedDia"
    for res in got:
        assert res["converged"] and res["operator"] == want
        assert (res["mvproducts"], res["restarts"]) == jax_counts[name]
        assert res["mvproducts"] == port["mvproducts"]
        assert res["host_syncs"] == got[0]["host_syncs"]
        assert _bitwise(res["R"], got[0]["R"])
        assert _bitwise(res["Q"], got[0]["Q"])
        assert res["q_placements"] == [("Shard", 0)]
        assert res["Q_local"].shape == (N // job.world, res["nconverged"])
    Q, R = got[0]["Q"], got[0]["R"]
    assert Q.dtype == np.float64
    assert np.linalg.norm(A @ Q - Q @ R) < 1e-11 * max(1.0, np.abs(R).max())
    lam = np.sort_complex(got[0]["eigenvalues"])
    ref = np.sort_complex(port["eigenvalues"])
    assert np.abs(lam - ref).max() <= 1e-9 * np.abs(ref).max()


def test_partial_eigen_keeps_the_sharding_of_an_extended_result(job):
    """partial_eigen of a sharded extended result: a DTensor of
    eigenvectors on the mesh, each pair's residual at the float64 level
    of the combined words."""
    A = _dense(W.EXT_SOLVES["ext_lap256"][0](None), N)
    for res in job.case("ext_lap256"):
        assert res["eigen_type"] == "DTensor"
        X, vals = res["eigen_vectors"], res["eigen_values"]
        assert np.linalg.norm(A @ X - X * vals, axis=0).max() < 1e-11


def test_sharded_f64_words_take_the_unsharded_count(job, job1):
    """laplacian_1d(40) in float64 words at tol=1e-24 (the double-double
    host layer): the port's unsharded count, the same R and R_lo on every
    rank, and the exact-rational residual of (Q + Q_lo, R + R_lo) below
    the tolerance."""
    got = job.case("ext_dd40")
    port = _unsharded(job1, "ext_dd40")
    for res in got:
        assert res["converged"] and res["operator"] == "_ShardedDia"
        assert (res["mvproducts"], res["restarts"]) == (port["mvproducts"],
                                                         port["restarts"])
        assert _bitwise(res["R"], got[0]["R"])
        assert _bitwise(res["R_lo"], got[0]["R_lo"])
        assert res["Q_lo"].shape == res["Q"].shape == (40, res["nconverged"])
    r = got[0]
    assert _exact_lap_residual(r["Q"], r["Q_lo"], r["R"], r["R_lo"]) < 1e-24


@pytest.mark.parametrize("name", ["lap256", "wide", "conv16", "breakdown"])
def test_sharded_range_is_bitwise_stepwise(job, name):
    """The sharded df_expand_range against df_expand_range_stepwise from one
    start and one generator seed: V, its low word and both Hessenberg
    words bit for bit; the range reads once (twice with the breakdown's
    rollback), the stepwise range once or twice a step."""
    for r in job.case("ext_stepwise"):
        rng_, step = r[name]["range"], r[name]["stepwise"]
        for key in ("V", "Vl", "Hh", "Hl"):
            assert _bitwise(rng_[key], step[key]), key
        assert rng_["reads"] == (2 if name == "breakdown" else 1)
        assert step["reads"] >= 8
    if name == "breakdown":
        # The broken-down step: H[2, 1] is zero and the random row a unit
        # vector orthogonal to the first two (sums over every rank's rows).
        Hh = job.case("ext_stepwise")[0][name]["range"]["Hh"]
        assert Hh[2, 1] == 0 and Hh[1, 0] != 0
        V = np.concatenate([r[name]["range"]["V"] for r in
                            job.case("ext_stepwise")], axis=1).astype(float)
        G = V[:3] @ V[:3].T
        assert np.abs(G - np.eye(3)).max() < 1e-6


def _check_step_forms(job):
    """Each step of the range, from one state: the gathered step (each sum
    folded by the kernel that consumes it) bitwise the step that sums with
    df_rank_sum first, on every rank."""
    for r in job.case("ext_step_forms"):
        assert len(r["gathered"]) == len(r["rank_sum"]) == 20
        for a, b in zip(r["gathered"], r["rank_sum"]):
            assert all(_bitwise(x, y) for x, y in zip(a, b))


def test_gathered_step_is_bitwise_the_rank_sum_step(job):
    _check_step_forms(job)


def test_one_rank_gathered_step_is_bitwise_the_rank_sum_step(job1):
    _check_step_forms(job1)


def test_extended_step_collective_budget(job):
    """Each Krylov step on the sharded DIA operator at n = 256, m = 20:
    three double-word sums, {r2, h1} and {s1, c} of m + 2 pairs and {s2}
    of one, receiving (P - 1) (2 (m + 2) + 1) pairs of 4-byte words; one
    halo exchange carrying both words (one entry from each neighbour); no
    all-reduce, all-gather or all-to-all."""
    for rank, r in enumerate(job.case("ext_budget")):
        m = r["m"]
        neighbours = (rank > 0) + (rank + 1 < job.world)
        for step in r["steps"]:
            assert step["df_sum"] == {
                "calls": 3, "bytes": (job.world - 1) * (2 * (m + 2) + 1) * 8}
            assert step["halo"] == {"calls": 1, "bytes": neighbours * 8}
            assert all(step[k]["calls"] == 0 for k in (
                "all_reduce", "all_gather", "all_to_all"))


def test_extended_basis_change_is_communication_free(job):
    for r in job.case("ext_budget"):
        assert all(v["calls"] == 0 for v in r["basis"].values())


def test_extended_solve_sums_with_df_sum_only(job):
    """A whole sharded extended solve: its sums over n go through df_sum
    (three a Krylov step, and the start's: the solve has no breakdown);
    one all-reduce, the single-word start's norm."""
    for r in job.case("ext_lap256"):
        c = r["collectives"]
        assert c["df_sum"]["calls"] == 3 * r["mvproducts"] + 1
        assert c["all_reduce"]["calls"] == 1
        assert c["all_gather"]["calls"] == c["all_to_all"]["calls"] == 0


def test_sharded_extended_checkpoint_holds_the_global_low_word(job2):
    """F7, at two ranks: rank 0 writes a (maxdim + 1, n) Vlo, the gathered
    rows; JAX's loader reads the file; every rank's loaded Vlo is its
    columns; the sharded extended warm start takes the count of the port's
    unsharded warm start from the same file."""
    job = job2
    got = job.case("ext_checkpoint")
    path = got[0]["path"]
    with np.load(path) as f:
        vlo = f["Vlo"]
    assert vlo.shape == (21, N) and np.abs(vlo).max() > 0
    for r in got:
        assert _bitwise(r["vlo"], vlo)
        assert r["local_vlo"] == (21, N // job.world)
    jws = jam.ArnoldiWorkspace.load(path)
    assert np.asarray(jws.Vlo).shape == (21, N)
    assert np.array_equal(np.asarray(jws.Vlo), vlo)
    start = got[0]["first"]["nconverged"]
    ws = tam.ArnoldiWorkspace.load(path)
    _, h0 = tam.partial_schur(tp.laplacian_1d(N, dtype=torch.float32),
                              workspace=ws, start_from=start, nev=6,
                              which="SR", tol=1e-10, extended=True)
    for r in got:
        assert r["warm"]["converged"]
        assert (r["warm"]["mvproducts"], r["warm"]["restarts"]) == (
            h0.mvproducts, h0.restarts)
