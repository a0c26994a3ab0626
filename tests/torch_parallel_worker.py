"""One rank of a sharded test job of tests/test_torch_parallel.py and
tests/test_torch_parallel_extended.py.

    python tests/torch_parallel_worker.py RANK WORLD INIT_METHOD WORKDIR [GROUP]

Every rank of a job runs this script: it joins a gloo process group on the
CPU (`init_method`, a file:// URL under WORKDIR), reads the job's inputs
from WORKDIR/inputs.npz, runs every case of GROUPS[GROUP] ("main" by
default, CASES; "extended", EXT_CASES) on the `rows` mesh and pickles its
results to WORKDIR/rank<RANK>.pkl.  A case that raises leaves its
traceback under "error".  Only the port is imported (no JAX): the tests
hold these results to the JAX package's.  `spawn` starts a job.
"""

from __future__ import annotations

import os
import pickle
import subprocess
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
    DiaOperator,
    ShardedCsrOperator,
)
from arnoldimethod_torch.ops import df_expansion as tde  # noqa: E402
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


def wide_band(n, band, dtype=np.float64):
    """(diags, offsets) of the 1-D Laplacian with a coupling of -1/4 at
    +-band: a symmetric band wider than a rank's rows once n/P < band
    (n = 256, band = 100 at 4 ranks); diags[d, i] = A[i, i + offsets[d]],
    zero where out of range, for the DiaOperator of either package."""
    offsets = (-band, -1, 0, 1, band)
    i = np.arange(n)
    diags = np.zeros((len(offsets), n), dtype=dtype)
    for d, (off, v) in enumerate(zip(offsets, (-0.25, -1.0, 2.0, -1.0,
                                               -0.25))):
        diags[d, (i + off >= 0) & (i + off < n)] = v
    return diags, offsets


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
    "wide_dia": (lambda inp: DiaOperator(*wide_band(256, 100), (256, 256)),
                 dict(v1="v1_256", nev=4, which="SR", tol=1e-8)),
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


def case_halo(ctx):
    """RowComm.halo of x = 1..16 at every lo, hi of {0, 1, n/P, n/P + 1,
    n - 1} below n: this rank's result and the collectives each made;
    and one halo of (n/P, 2) rows, both words of a pair."""
    n = 16
    comm = row_comm(basis_sharding(ctx.mesh), n)
    x = comm.local(torch.arange(1.0, n + 1.0, dtype=torch.float64))
    sizes = sorted(v for v in {0, 1, comm.n_local, comm.n_local + 1, n - 1}
                   if v < n)
    out = {}
    for lo in sizes:
        for hi in sizes:
            COLLECTIVES.reset()
            y = comm.halo(x, lo, hi)
            out[lo, hi] = dict(y=y.numpy(), collectives=COLLECTIVES.snapshot())
    out["pairs"] = comm.halo(torch.stack((x, -x), dim=1), 5, n - 1).numpy()
    out["refused"] = _message(lambda: comm.halo(x, n, 0))
    return out


def case_wide_matvec(ctx):
    """F8: the DiaOperator of offsets (-5, 0, 5) at n = 16, a band wider
    than a rank's 4 rows at 4 ranks: this rank's rows of the sharded
    matvec and matvec_df (one halo each), and the collectives of the
    matvec."""
    n = 16
    op = DiaOperator(ctx.inputs["dia16"], (-5, 0, 5), (n, n))
    sop = shard_operator(op, ctx.mesh)
    x = torch.from_numpy(ctx.inputs["x_16"])
    xl = x * 2.0 ** -60
    COLLECTIVES.reset()
    y = sop.matvec(sop.comm.local(x))
    counts = COLLECTIVES.snapshot()
    yh, yl = sop.matvec_df(sop.comm.local(x), sop.comm.local(xl))
    return dict(operator=type(sop).__name__, y=y.numpy(), yh=yh.numpy(),
                yl=yl.numpy(), collectives=counts)


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
    """What the sharded entry points refuse, as (type, message); and what
    they once refused and now run, as a solve's summary."""
    mesh = ctx.mesh
    sh = basis_sharding(mesh)
    op = tp.laplacian_1d(64)
    out = dict(
        extended=_summary(*tam.partial_schur(
            shard_operator(tp.laplacian_1d(64, dtype=torch.float32), mesh),
            nev=2, sharding=sh, extended=True)),
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
    "halo": case_halo,
    "wide_matvec": case_wide_matvec,
    "checkpoint": case_checkpoint,
    "errors": case_errors,
}


# -- extended=True ------------------------------------------------------------

# The extended solves every extended job runs: name -> (operator builder,
# keywords), as SOLVES.  laplacian_1d(256) in float32 words is JAX's own
# sharded extended case (tests/test_extended.py), config 3's operator at
# 16^2 the size where both packages take the same count (F3), through the
# gathering wrapper (stencil5_df on the full grid); laplacian_1d(40) in
# float64 words the double-double case.
EXT_SOLVES = {
    "ext_lap256": (lambda inp: tp.laplacian_1d(256, dtype=torch.float32),
                   dict(v1="v1_256", nev=4, which="SR", tol=1e-10)),
    "ext_conv16": (lambda inp: tp.convection_diffusion_2d(
                       16, peclet=68.0, dtype=torch.float32, fmt="stencil"),
                   dict(v1="v1_conv", nev=10, which="LM", tol=1e-6,
                        mindim=30, maxdim=60, restarts=1000)),
    "ext_dd40": (lambda inp: tp.laplacian_1d(40, dtype=torch.float64),
                 dict(v1="v1_40", nev=4, which="SR", tol=1e-24)),
    "ext_wide": (lambda inp: DiaOperator(*wide_band(256, 100, np.float32),
                                         (256, 256)),
                 dict(v1="v1_256", nev=4, which="SR", tol=1e-12)),
}


def _ext_summary(d, h):
    out = dict(_summary(d, h), host_syncs=h.host_syncs)
    if hasattr(d, "R_lo"):
        out["R_lo"] = np.asarray(d.R_lo)
    return out


def ext_solve_case(ctx, name):
    """A sharded extended solve: its summary, the operator it ran, the
    collectives it made, Q (and Q_lo) whole; at one rank also the
    unsharded solve's, for the bitwise check."""
    build, kw = EXT_SOLVES[name]
    kw = dict(kw, v1=ctx.inputs[kw["v1"]], extended=True)
    op = build(ctx.inputs)
    sharded = shard_operator(op, ctx.mesh)
    COLLECTIVES.reset()
    d, h = tam.partial_schur(sharded, sharding=basis_sharding(ctx.mesh), **kw)
    out = _ext_summary(d, h)
    out["collectives"] = COLLECTIVES.snapshot()
    out["operator"] = type(sharded).__name__
    out["q_placements"] = [(type(p).__name__, getattr(p, "dim", None))
                           for p in d.Q.placements]
    out["Q"] = d.Q.full_tensor().numpy()
    out["Q_local"] = d.Q.to_local().numpy()
    if hasattr(d, "Q_lo"):
        out["Q_lo"] = d.Q_lo.full_tensor().numpy()
        out["Q_lo_local"] = d.Q_lo.to_local().numpy()
    if name == "ext_lap256":
        vals, X = tam.partial_eigen(d)
        out["eigen_values"] = np.asarray(vals)
        out["eigen_type"] = type(X).__name__
        out["eigen_vectors"] = X.full_tensor().numpy()
    if ctx.world == 1:
        d0, h0 = tam.partial_schur(op, **kw)
        out["unsharded"] = _ext_summary(d0, h0)
        out["unsharded"]["Q"] = d0.Q.numpy()
        if hasattr(d0, "Q_lo"):
            out["unsharded"]["Q_lo"] = d0.Q_lo.numpy()
    return out


def _ext_start(ctx, op, v1, m, dtype):
    """(V, Vl, Hh, Hl) of a sharded double-word basis of m + 1 rows whose
    first row is v1 / ||v1||, as partial_schur starts it."""
    comm = row_comm(basis_sharding(ctx.mesh), op.shape[0])
    V = torch.zeros((m + 1, comm.n_local), dtype=dtype)
    Vl = torch.zeros_like(V)
    H = torch.zeros((m + 1, m), dtype=dtype)
    texp.set_initial_vector(V, torch.from_numpy(v1), comm)
    tde.df_set_initial_vector(V, Vl, V[0], comm)
    return comm, V, Vl, H, H.clone()


def case_ext_stepwise(ctx):
    """The sharded df_expand_range against df_expand_range_stepwise from
    the same start and the same generator seed: laplacian_1d(256), the
    wide band and config 3's stencil in float32 words, and a diagonal
    operator whose start spans two eigenvectors (a breakdown at step 2,
    finished on the breakdown path with a random row).  Both results and
    the host reads."""
    n = 256
    diag = DiaOperator(torch.arange(1.0, n + 1.0)[None], (0,), (n, n))
    assert diag.dtype == torch.float32
    two = np.zeros(n)
    two[[3, n - 5]] = 1.0
    ops = {"lap256": (tp.laplacian_1d(n, dtype=torch.float32),
                      ctx.inputs["v1_256"], 20),
           "wide": (EXT_SOLVES["ext_wide"][0](ctx.inputs),
                    ctx.inputs["v1_256"], 20),
           "conv16": (EXT_SOLVES["ext_conv16"][0](ctx.inputs),
                      ctx.inputs["v1_conv"], 30),
           "breakdown": (diag, two, 8)}
    out = {}
    for name, (op, v1, m) in ops.items():
        sop = shard_operator(op, ctx.mesh)
        res = {}
        for way, expand in (("range", tde.df_expand_range),
                            ("stepwise", tde.df_expand_range_stepwise)):
            comm, V, Vl, Hh, Hl = _ext_start(ctx, op, v1, m, torch.float32)
            gen = torch.Generator().manual_seed(5)
            got = expand(sop, V, Vl, Hh, Hl, 0, m, gen, comm)
            reads = got[1] if way == "range" else got
            res[way] = dict(V=V.numpy(), Vl=Vl.numpy(), Hh=Hh.numpy(),
                            Hl=Hl.numpy(), reads=reads)
        out[name] = res
    return out


def _rank_sum_step(op, Vh, Vl, Hh, Hl, j, flags, comm):
    """A sharded Krylov step with each sum over the ranks one df_sum (a
    gather, then df_rank_sum), then df_axpy and df_normalize on the sums:
    the step before its kernels folded the sums themselves."""
    from arnoldimethod_torch.ops import df

    rows = j + 1
    wh, wl = tde._matvec_df(op, Vh[j], Vl[j])
    sh, sl = comm.df_sum([tde._sumsq(wh, wl),
                          df.df_project(Vh, Vl, wh, wl, rows)])
    r2, h1 = (sh[0], sl[0]), (sh[1:], sl[1:])
    w1, s1 = df.df_axpy(wh, wl, *h1, Vh, Vl, rows, True)
    sh, sl = comm.df_sum([s1, df.df_project(Vh, Vl, *w1, rows)])
    s1, c = (sh[0], sl[0]), (sh[1:], sl[1:])
    w2, s2 = df.df_axpy(*w1, *c, Vh, Vl, rows, True)
    sh, sl = comm.df_sum([s2])
    df.df_normalize(w1, s1, (Vh[rows], Vl[rows]), df.DgksStep(
        r2, w2, (sh[0], sl[0]), h1, c, (Hh, Hl), j, flags))


def case_ext_step_forms(ctx):
    """Steps 0..19 of config 3's stencil at 16^2 in float32 words, each
    run from one state both ways (`df_expansion._step`, its sums folded
    by the gathered forms, and `_rank_sum_step`): this rank's rows j + 1,
    H's columns and the flags of each way."""
    op = EXT_SOLVES["ext_conv16"][0](ctx.inputs)
    sop = shard_operator(op, ctx.mesh)
    comm, V, Vl, Hh, Hl = _ext_start(ctx, op, ctx.inputs["v1_conv"], 20,
                                     torch.float32)
    flags = torch.zeros(20)
    out = {"gathered": [], "rank_sum": []}
    for j in range(20):
        for way, step in (("rank_sum", _rank_sum_step),
                          ("gathered", tde._step)):
            step(sop, V, Vl, Hh, Hl, j, flags, comm)
            out[way].append([t.numpy().copy() for t in (
                V[j + 1], Vl[j + 1], Hh[:, j], Hl[:, j], flags[j:j + 1])])
    return out


def case_ext_budget(ctx):
    """The collectives of each extended Krylov step on the sharded DIA
    operator at n = 256, m = 20 (steps 4 to 19), and of the basis change."""
    n, m = 256, 20
    op = tp.laplacian_1d(n, dtype=torch.float32)
    sop = shard_operator(op, ctx.mesh)
    comm, V, Vl, Hh, Hl = _ext_start(ctx, op, ctx.inputs["v1_256"], m,
                                     torch.float32)
    gen = torch.Generator().manual_seed(0)
    tde.df_expand_range(sop, V, Vl, Hh, Hl, 0, 4, gen, comm)
    steps = []
    for j in range(4, m):
        COLLECTIVES.reset()
        tde.df_expand_range(sop, V, Vl, Hh, Hl, j, j + 1, gen, comm)
        steps.append(COLLECTIVES.snapshot())
    COLLECTIVES.reset()
    eye = torch.eye(m + 1)
    tde.df_apply_basis_change(V, Vl, eye, torch.zeros_like(eye))
    return dict(steps=steps, basis=COLLECTIVES.snapshot(), n=n, m=m)


def case_ext_checkpoint(ctx):
    """A sharded extended solve saved (V and Vlo gathered, rank 0 writes),
    every rank's gathered Vlo beside it, then loaded on every rank with
    its sharding and warm-started, extended, to more eigenvalues.  At two
    ranks only (None elsewhere): a cut low word needs P > 1."""
    if ctx.world != 2:
        return None
    path = ctx.workdir / f"ext_ckpt_{ctx.world}.npz"
    sh = basis_sharding(ctx.mesh)
    op = shard_operator(tp.laplacian_1d(256, dtype=torch.float32), ctx.mesh)
    ws = tam.ArnoldiWorkspace(256, 20, dtype=torch.float32, sharding=sh)
    kw = dict(which="SR", tol=1e-10, extended=True)
    d, h = tam.partial_schur(op, workspace=ws, v1=ctx.inputs["v1_256"], nev=3,
                             sharding=sh, **kw)
    ws.save(path)
    vlo = ws.comm.gather_rows(ws.Vlo.T).T.numpy()
    dist.barrier()
    ws2 = tam.ArnoldiWorkspace.load(path, sharding=sh)
    local = tuple(ws2.Vlo.shape)
    d2, h2 = tam.partial_schur(op, workspace=ws2, start_from=h.nconverged,
                               nev=6, **kw)
    return dict(first=_ext_summary(d, h), warm=_ext_summary(d2, h2),
                path=str(path), vlo=vlo, local_vlo=local)


EXT_CASES = {
    **{name: (lambda ctx, name=name: ext_solve_case(ctx, name))
       for name in EXT_SOLVES},
    "ext_stepwise": case_ext_stepwise,
    "ext_step_forms": case_ext_step_forms,
    "ext_budget": case_ext_budget,
    "ext_checkpoint": case_ext_checkpoint,
}

GROUPS = {"main": CASES, "extended": EXT_CASES}


def start(world, workdir, group="main"):
    """Start a job of `world` ranks of this script on the inputs in
    WORKDIR/inputs.npz (a file:// rendezvous under it, so parallel test
    workers never race for a port); returns its processes."""
    init = f"file://{workdir / 'rendezvous'}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), init, str(workdir),
         group], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(world)]


def finish(procs, workdir, timeout=300):
    """Wait for a started job; every rank's results, in rank order.  Fails
    with a rank's output if one exits non-zero."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"rank {r} of {len(procs)} failed:\n{out[-4000:]}")
    ranks = []
    for r in range(len(procs)):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def spawn(world, workdir, group="main"):
    """Run a job (`start`, then `finish`)."""
    return finish(start(world, workdir, group), workdir)


class Context:
    def __init__(self, rank, world, mesh, inputs, workdir):
        self.rank, self.world, self.mesh = rank, world, mesh
        self.inputs, self.workdir = inputs, workdir


def main(rank, world, init_method, workdir, group="main"):
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
        for name, case in GROUPS[group].items():
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
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         *sys.argv[5:6])
