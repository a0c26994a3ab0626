"""One rank of a sharded test job of tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py RANK WORLD INIT_METHOD WORKDIR

Every rank of a job runs this script: it joins a gloo process group on the
CPU (`init_method`, a file:// URL under WORKDIR), reads the job's inputs
from WORKDIR/inputs.npz, runs every case of CASES on the `rows` mesh and
pickles its results to WORKDIR/rank<RANK>.pkl.  A case that raises leaves
its traceback under "error".  Only the port is imported (no JAX): the test
holds these results to the JAX package's.
"""

from __future__ import annotations

import os
import pickle
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import arnoldimethod_torch as tam  # noqa: E402
from arnoldimethod_torch import _device  # noqa: E402
from arnoldimethod_torch.convert import operator_from_arrays  # noqa: E402
from arnoldimethod_torch.models import problems as tp  # noqa: E402
from arnoldimethod_torch.models.operators import (  # noqa: E402
    CsrOperator,
    ShardedCsrOperator,
)
from arnoldimethod_torch.ops import expansion as texp  # noqa: E402
from arnoldimethod_torch.parallel import (  # noqa: E402
    COLLECTIVES,
    basis_sharding,
    make_mesh,
    make_pod_mesh,
    row_comm,
    shard_operator,
    vector_sharding,
)


def powerlaw_csr(n, seed=0):
    """(A, indptr, indices, data): an sprand-like matrix with power-law row
    lengths (a few rows carry hundreds of nonzeros, most a handful), the
    diagonal shifted by 3; this package's copy of the JAX tests'
    `_powerlaw_csr` (tests/test_parallel.py), the same matrix from a seed."""
    rng = np.random.default_rng(seed)
    row_nnz = np.minimum(rng.zipf(1.6, size=n), n // 2)
    A = np.zeros((n, n))
    for i in range(n):
        cols = np.sort(rng.choice(n, size=row_nnz[i], replace=False))
        A[i, cols] = rng.standard_normal(row_nnz[i])
    A[np.arange(n), np.arange(n)] += 3.0
    return (A, *dense_to_csr(A))


def banded_csr(n, bw=3):
    """(A, indptr, indices, data): the JAX tests' `_banded_csr` band of
    half-width bw, diagonal shifted by 4 (seed 5)."""
    rng = np.random.default_rng(5)
    A = np.zeros((n, n))
    for i in range(n):
        cols = np.arange(max(0, i - bw), min(n, i + bw + 1))
        v = rng.standard_normal(len(cols))
        v[cols == i] += 4.0
        A[i, cols] = v
    return (A, *dense_to_csr(A))


def dense_to_csr(A):
    nz = A != 0
    indptr = np.concatenate(([0], np.cumsum(nz.sum(axis=1))))
    return indptr, np.nonzero(nz)[1].astype(np.int32), A[nz]


def tridiag_shift_invert(n=1024):
    """The JAX test's n = 1024 nonsymmetric tridiagonal at sigma = 0."""
    return tam.TridiagonalShiftInvertOperator.build(
        np.full(n - 1, -1.0), np.full(n, 2.0), np.full(n - 1, -1.001),
        sigma=0.0, dtype=np.float64)


# The solves every job runs: name -> (operator builder, keywords).  The
# builder takes the job's inputs; a LinearOperator goes through
# shard_operator, anything else is given to partial_schur as it is (the
# driver wraps it, as JAX's tests give theirs unsharded).
SOLVES = {
    "dgks": (lambda inp: tp.laplacian_1d(256),
             dict(v1="v1_256", nev=4, which="SR", tol=1e-8)),
    "lowsync": (lambda inp: tp.laplacian_1d(256),
                dict(v1="v1_256", nev=4, which="SR", tol=1e-8, lowsync=True)),
    "device": (lambda inp: tp.laplacian_1d(256),
               dict(v1="v1_256", nev=4, which="SR", tol=1e-8,
                    method="device")),
    "split_complex": (lambda inp: inp["A48"],
                      dict(v1="v1_48", nev=5, which="LM", tol=1e-9,
                           split_complex=True)),
    "lowsync_complex": (lambda inp: inp["A48"],
                        dict(v1="v1_48", nev=5, which="LM", tol=1e-9,
                             lowsync=True)),
    "shift_invert": (lambda inp: tridiag_shift_invert(),
                     dict(v1="v1_1024", nev=6, which="LM", tol=1e-9,
                          mindim=8, maxdim=16, method="host")),
    "ell": (lambda inp: tp.laplacian_1d(256, fmt="ell"),
            dict(v1="v1_256", nev=3, which="SR", tol=1e-8)),
    "powerlaw": (lambda inp: CsrOperator(*powerlaw_csr(256, seed=2)[1:],
                                         (256, 256)),
                 dict(v1="v1_256", nev=4, which="LM", tol=1e-8)),
    "lap2d": (lambda inp: tp.laplacian_2d(16, 16),
              dict(v1="v1_256", nev=5, which="SR", tol=1e-8)),
}


def _summary(d, h):
    return dict(mvproducts=h.mvproducts, restarts=h.restarts,
                nconverged=h.nconverged, converged=h.converged,
                eigenvalues=np.asarray(d.eigenvalues), R=np.asarray(d.R))


def solve_case(ctx, name):
    build, kw = SOLVES[name]
    kw = dict(kw, v1=ctx.inputs[kw["v1"]])
    op = build(ctx.inputs)
    sharded = shard_operator(op, ctx.mesh) if isinstance(
        op, tam.LinearOperator) else op
    d, h = tam.partial_schur(sharded, sharding=basis_sharding(ctx.mesh), **kw)
    out = _summary(d, h)
    out["q_type"] = type(d.Q).__name__
    out["q_placements"] = [(type(p).__name__, getattr(p, "dim", None))
                           for p in d.Q.placements]
    out["q_mesh_size"] = d.Q.device_mesh.size()
    out["q_local_rows"] = d.Q.to_local().shape[0]
    Q = d.Q.full_tensor()
    out["Q"] = Q.numpy()
    if name == "dgks":
        vals, X = tam.partial_eigen(d)
        out["eigen_values"] = np.asarray(vals)
        out["eigen_type"] = type(X).__name__
        out["eigen_vectors"] = X.full_tensor().numpy()
    if ctx.world == 1:
        # The unsharded solve in this process, for the bitwise check.
        d0, h0 = tam.partial_schur(op, **kw)
        out["unsharded"] = _summary(d0, h0)
        out["unsharded"]["Q"] = d0.Q.numpy()
        out["Q_local"] = d.Q.to_local().numpy()
    return out


def case_csr(ctx):
    """ShardedCsrOperator built from the banded and power-law matrices and
    a dense random pattern, in each gather mode the mesh has: this rank's
    matvec rows, the mode `auto` picked, footprint_elems, nnz, the rank's
    send table and one matvec's collectives."""
    n = 256
    x = torch.from_numpy(ctx.inputs["x_256"])
    comm = row_comm(basis_sharding(ctx.mesh), n)
    mats = {"banded": banded_csr(n)[1:], "powerlaw": powerlaw_csr(n, 1)[1:],
            "dense": (ctx.inputs["dense_indptr"], ctx.inputs["dense_indices"],
                      np.ones(n * 64))}
    modes = ["auto", "all"] + (["footprint"] if ctx.world > 1 else [])
    out = {}
    for mat, (indptr, indices, data) in mats.items():
        for mode in modes:
            sop = ShardedCsrOperator.build(indptr, indices, data, (n, n),
                                           ctx.mesh, gather=mode)
            COLLECTIVES.reset()
            y = sop.matvec(comm.local(x))
            out[mat, mode] = dict(
                y=y.numpy(), mode=sop.mode, footprint_elems=sop.footprint_elems,
                nnz=sop.nnz, collectives=COLLECTIVES.snapshot(),
                send_idx=None if sop.send_idx is None else sop.send_idx.numpy())
    return out


def case_convert(ctx):
    """operator_from_arrays("sharded_csr") from the JAX operator's arrays:
    this rank's rows of the matvec, in each mode JAX built."""
    x = torch.from_numpy(ctx.inputs["x_256"])
    comm = row_comm(basis_sharding(ctx.mesh), 256)
    out = {}
    for mode in ("all", "footprint"):
        key = f"jax_{mode}_"
        names = sorted((k for k in ctx.inputs if k.startswith(key)),
                       key=lambda k: int(k[len(key):]))
        if not names:
            continue
        op = operator_from_arrays(
            "sharded_csr", {"arrs": [ctx.inputs[k] for k in names]},
            {"mode": mode, "shape": (256, 256), "mesh": ctx.mesh})
        out[mode] = dict(y=op.matvec(comm.local(x)).numpy(), mode=op.mode,
                         footprint_elems=op.footprint_elems)
    return out


def case_budget(ctx):
    """The collectives of the DIA step at n = 1024, m = 20 (JAX's HLO
    budget test): each DGKS step's, the basis change's, and a low-sync
    range's against the DGKS range's over the same steps."""
    n, m = 1024, 20
    sh = basis_sharding(ctx.mesh)
    comm = row_comm(sh, n)
    op = shard_operator(tp.laplacian_1d(n), ctx.mesh)
    gen = torch.Generator().manual_seed(0)
    V = torch.zeros((m + 1, comm.n_local), dtype=torch.float64)
    H = torch.zeros((m + 1, m), dtype=torch.float64)
    texp.set_initial_vector(V, torch.from_numpy(ctx.inputs["v1_1024"]), comm)
    texp.expand_range(op, V, H, 0, 4, gen, comm)
    V0, H0 = V.clone(), H.clone()
    steps = []
    for j in range(4, m):
        COLLECTIVES.reset()
        texp.expand_range(op, V, H, j, j + 1, gen, comm)
        steps.append(COLLECTIVES.snapshot())
    COLLECTIVES.reset()
    texp.apply_basis_change(V, torch.eye(m + 1, dtype=torch.float64))
    basis = COLLECTIVES.snapshot()
    COLLECTIVES.reset()
    texp.expand_range_lowsync(op, V0, H0, 4, m, gen, comm)
    return dict(steps=steps, basis=basis, lowsync=COLLECTIVES.snapshot(),
                n=n, m=m)


def case_checkpoint(ctx):
    """A sharded solve saved (rank 0 writes the global checkpoint), loaded
    on every rank with its sharding and warm-started to more eigenvalues."""
    path = ctx.workdir / f"ckpt_{ctx.world}.npz"
    sh = basis_sharding(ctx.mesh)
    op = shard_operator(tp.laplacian_1d(256), ctx.mesh)
    ws = tam.ArnoldiWorkspace(256, 20, dtype=torch.float64, sharding=sh)
    d, h = tam.partial_schur(op, workspace=ws, v1=ctx.inputs["v1_256"], nev=3,
                             which="SR", tol=1e-8, sharding=sh)
    ws.save(path)
    dist.barrier()
    ws2 = tam.ArnoldiWorkspace.load(path, sharding=sh)
    local_cols = tuple(ws2.V.shape)
    d2, h2 = tam.partial_schur(op, workspace=ws2, start_from=h.nconverged,
                               nev=6, which="SR", tol=1e-8)
    return dict(first=_summary(d, h), warm=_summary(d2, h2), path=str(path),
                local_cols=local_cols)


def _message(fn):
    try:
        fn()
    except Exception as e:  # the test checks the type and the text
        return type(e).__name__, str(e)
    return None


def case_errors(ctx):
    """What the sharded entry points refuse, as (type, message)."""
    mesh = ctx.mesh
    sh = basis_sharding(mesh)
    op = tp.laplacian_1d(64)
    out = dict(
        extended=_message(lambda: tam.partial_schur(
            shard_operator(op, mesh), nev=2, sharding=sh, extended=True)),
        not_a_descriptor=_message(lambda: tam.partial_schur(
            op, nev=2, sharding=object())),
        vector_descriptor=_message(lambda: tam.partial_schur(
            op, nev=2, sharding=vector_sharding(mesh))),
        mesh_size=_message(lambda: make_mesh(ctx.world + 1)),
        pod_mesh=(make_pod_mesh().mesh_dim_names, make_pod_mesh().size()),
    )
    if ctx.world > 1:
        uneven = 64 * ctx.world + 1
        out["uneven"] = _message(lambda: shard_operator(
            tp.laplacian_1d(uneven), mesh))
        out["uneven_csr"] = _message(lambda: ShardedCsrOperator.build(
            *banded_csr(uneven)[1:], (uneven, uneven), mesh))
    else:
        out["footprint_one_rank"] = _message(lambda: ShardedCsrOperator.build(
            *banded_csr(64)[1:], (64, 64), mesh, gather="footprint"))
    return out


CASES = {
    **{name: (lambda ctx, name=name: solve_case(ctx, name)) for name in SOLVES},
    "csr": case_csr,
    "convert": case_convert,
    "budget": case_budget,
    "checkpoint": case_checkpoint,
    "errors": case_errors,
}


class Context:
    def __init__(self, rank, world, mesh, inputs, workdir):
        self.rank, self.world, self.mesh = rank, world, mesh
        self.inputs, self.workdir = inputs, workdir


def main(rank, world, init_method, workdir):
    workdir = Path(workdir)
    torch.set_num_threads(1)
    _device.DEFAULT = "cpu"
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        with np.load(workdir / "inputs.npz") as f:
            inputs = {k: f[k] for k in f.files}
        ctx = Context(rank, world, make_mesh(), inputs, workdir)
        results, seconds = {}, {}
        for name, case in CASES.items():
            t0 = time.perf_counter()
            try:
                results[name] = case(ctx)
            except Exception:  # reported to the test that reads this case
                results[name] = {"error": traceback.format_exc()}
            seconds[name] = time.perf_counter() - t0
        results["seconds"] = seconds
        with open(workdir / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
