"""The Krylov-Schur restart driver: `partial_schur`.

Orchestrates the two layers of the solver: the n-sized work on the device
(Arnoldi expansion and the basis-change GEMM, ops/expansion.py, or their
double-word forms in ops/df_expansion.py for extended=True) and the host
float64 (or double-double) dense kernels for the (maxdim+1)-sized work
(Francis QR, reordering, restoration, dense/).  All restart decisions (locking counts,
purge index, conjugate-pair splits, truncation size) are made on the host
from the small H; each restart pays one device step and one H readback.
Each phase of a solve is a span of trace.py: its host seconds go to
`History.timings`, and while a torch profiler records it is the range
arnoldi:<phase> (partial_schur > expand, dense_restart > schur and
reorder, truncate_expand, finish; the expansions' steps below them).

Behavioral reference: arnoldimethod_tpu/driver.py (the host method), which
follows ArnoldiMethod.jl src/run.jl (driver `_partialschur` :224-392,
convergence criterion :188-208, three-way partition :394-457, final sort
:459-502, residuals :519-545).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import trace
from .dense import native as _native
from .dense.device import STATE
from .dense.eig import collect_eigen, copy_eigenvalues, eigenvalue
from .dense.restore import restore_arnoldi
from .dense.schur import local_schur
from .dense.swaps import (
    is_end_of_11_block,
    is_start_of_11_block,
    rotate_right,
    swap,
)
from .models.operators import (
    DenseOperator,
    RowShardedOperator,
    SplitComplexDenseOperator,
    as_operator,
)
from .fused import fused_solve
from .parallel.mesh import GatheredOperator, distribute_rows, row_comm
from .ops.dd import DD_EPS, dd_collapse, dd_hi, dd_lo, dd_pack
from .ops.df_expansion import (
    df_apply_basis_change,
    df_expand_range,
    df_reorthogonalize_row,
    df_set_initial_vector,
    df_truncate_and_expand,
    split_f64,
)
from .ops.expansion import (
    apply_basis_change,
    expand_range,
    expand_range_lowsync,
    fp32_matmul,
    set_initial_vector,
    set_random_vector,
    truncate_and_expand,
    truncate_and_expand_lowsync,
)
from .targets import LI, SI, as_target, get_order
from .workspace import ArnoldiWorkspace

__all__ = ["History", "PartialSchur", "partial_schur"]

# Debug checks, the numerical analogue of sanitizers: with
# ARNOLDI_TPU_DEBUG set (and not "0"), every restart of the host method
# checks that H is finite and the basis orthonormal (the latter reads V
# back: debug only).  The same variable switches the JAX package's checks.
_DEBUG = os.environ.get("ARNOLDI_TPU_DEBUG", "0") != "0"


def _debug_checks(H, V, k, it, comm=None):
    """Raise FloatingPointError when H has a non-finite entry or the rows
    [0, k) of V are not orthonormal to 1e-3 (float32) or 1e-8 (a sharded
    V's Gram matrix summed over the ranks)."""
    if not np.isfinite(H).all():
        raise FloatingPointError(
            f"non-finite Hessenberg entries after restart {it}"
        )
    # Rows [0, k) are the basis proper; row k (the next-vector slot) is
    # legitimately ~0 when the Krylov space is exhausted.
    G = V[:k].conj() @ V[:k].T
    if comm is not None:
        comm.all_reduce_(G)
    err = float(np.linalg.norm(G.cpu().numpy() - np.eye(k)))
    limit = 1e-3 if V.dtype.to_real() == torch.float32 else 1e-8
    if err > limit:
        raise FloatingPointError(
            f"basis orthonormality lost after restart {it}: "
            f"||V V^H - I|| = {err:.2e}"
        )


class History:
    """Convergence summary: matrix-vector product count, number of
    converged eigenvalues, and whether the request was met
    (ref: run.jl:211-222, show.jl).  `restarts` counts the Krylov-Schur
    restart cycles and `purges` the restarts in which a previously locked
    Schur vector was purged (ref: run.jl:341-353).

    `timings` holds host wall-clock seconds of the solve's phases (trace.py
    keeps them), every key present for every method; a child's phase lies
    inside its parent's:
      'device': the expansion's host span, waits on the card included:
        every Krylov range with its H readback, and the final basis change
        (method="device": the whole fused solve, restarts included);
        'sync_wait' (child of 'device'): every device-to-host read inside
          it, so device - sync_wait is the host's own enqueue work;
      'dense': the host dense restart, and the final sort (0.0 with
        method="device");
        'dense_schur' (child of 'dense'): Francis QR, the Ritz values and
          the residual estimates of each restart;
        'dense_reorder' (child of 'dense'): the three-way partition and
          the Hessenberg restore of each restart, and the final sort.
    `dense_layer` names the host dense layer that ran ("native",
    the C++ core, or "numpy"), and `host_syncs` counts the device-to-host
    reads the expansion made to branch on: on the DGKS path one or two per
    Krylov step, the H readbacks not included; on the low-sync path
    (lowsync=True) and the extended path (extended=True) one per expansion
    range, which brings back H (both words, extended) and the range's
    breakdown flags together, and one more per rollback of a step that
    broke down (the extended start reads nothing); with method="device"
    every read of the solve: one state read a restart, one more a
    rollback, and the final readback."""

    def __init__(self, mvproducts, nconverged, converged, nev, restarts=0,
                 purges=0, timings=None, dense_layer=None, host_syncs=0):
        self.mvproducts = mvproducts
        self.nconverged = nconverged
        self.converged = converged
        self.nev = nev
        self.restarts = restarts
        self.purges = purges
        self.timings = timings or {}
        self.dense_layer = dense_layer
        self.host_syncs = host_syncs

    def __repr__(self):
        status = "Converged" if self.converged else "Not converged"
        return (
            f"{status}: {self.nconverged} of {self.nev} eigenvalues "
            f"in {self.mvproducts} matrix-vector products"
        )


class PartialSchur:
    """Partial Schur decomposition A Q = Q R: Q is an orthonormal
    (n, nconverged) tensor, R the (nconverged, nconverged) host
    quasi-upper-triangular factor, and `eigenvalues` the complex-valued
    diagonal-block eigenvalues (always complex-typed, ref:
    ArnoldiMethod.jl:120-137).

    The basis is held in the solver's rows layout (nconverged, n) as
    `Q_rows`; `Q` is its transposed view, made on first access.  After an
    extended=True solve with float64 words, Q and R hold the hi words and
    the attributes `Q_lo` (a tensor like Q) and `R_lo` (host) the lo
    words."""

    def __init__(self, Q, R, eigenvalues, Q_rows=None):
        if (Q is None) == (Q_rows is None):
            raise ValueError("exactly one of Q / Q_rows must be given")
        self._Q = Q
        self._Q_rows = Q_rows
        self.R = R
        self.eigenvalues = eigenvalues

    @property
    def Q(self):
        if self._Q is None:
            self._Q = self._Q_rows.T
        return self._Q

    @property
    def Q_rows(self):
        if self._Q_rows is None:
            self._Q_rows = self._Q.T
        return self._Q_rows

    def __repr__(self):
        return (
            f"PartialSchur decomposition (Q: {tuple(self.Q.shape)}, "
            f"R: {tuple(self.R.shape)}) with eigenvalues:\n"
            + repr(self.eigenvalues)
        )


def _is_pair_at(lams, ord_, pos, is_real):
    """True iff the sorted Ritz positions pos, pos+1 hold a conjugate pair
    (ref: include_conjugate_pair, run.jl:510-517)."""
    if not is_real or pos + 1 >= len(ord_):
        return False
    l1 = lams[ord_[pos]]
    return l1.imag != 0 and np.conj(l1) == lams[ord_[pos + 1]]


def _partition_three_way(R, Q, groups):
    """Partition the Schur blocks into [locked | retained | purged] by
    rotating group-1 and group-2 blocks forward (ref: run.jl:394-457)."""
    m = R.shape[1]
    hi = mi = lo = 0
    while hi < m:
        group = groups[hi]
        bs = 1 if is_start_of_11_block(R, hi) else 2
        if group == 3:
            hi += bs
        elif group == 2:
            rotate_right(R, mi, hi, Q)
            hi += bs
            mi += bs
        else:
            rotate_right(R, lo, hi, Q)
            hi += bs
            mi += bs
            lo += bs


def _sort_schur(R, Q, count, key):
    """Insertion sort of the leading `count` Schur blocks into the user's
    target order via direct swaps (ref: run.jl:459-502)."""
    if count <= 1:
        return
    next_idx = 0
    while next_idx < count:
        curr = next_idx
        curr_size = 1 if is_start_of_11_block(R, curr) else 2
        lam_curr = eigenvalue(R, curr)
        while curr > 0:
            prev_size = 1 if is_end_of_11_block(R, curr - 1) else 2
            prev = curr - prev_size
            lam_prev = eigenvalue(R, prev)
            if not key(lam_curr) < key(lam_prev):
                break
            swap(R, prev, prev_size == 1, curr_size == 1, Q)
            curr -= prev_size
        next_idx += curr_size


def _copy_residuals(rs, H, Q, h_last, x, lo, hi):
    """Ritz residuals ||A x - lam x|| = |q_m^T y| * |h_{m+1,m}| computed
    from the Hessenberg eigenvector y and the last row of Q
    (ref: run.jl:519-545)."""
    m = H.shape[1]
    rs[:] = 0.0
    for i in range(lo, hi):
        x[:] = 0
        klen = collect_eigen(x, H[:m, :], i)
        tmp = Q[m - 1, :klen] @ x[:klen]
        rs[i] = abs(tmp * h_last)
    return rs


def _schur_coupling_floor(rs, H, Q, h_last, lo, hi):
    """Floor each residual estimate by the Schur-column coupling
    |h_{m+1,m}| * |Q[m-1, i]| the truncation would discard when locking
    column i, with 2x2 blocks treated as a unit (both columns take the
    block max).  The reference judges convergence per Ritz eigenvector,
    but locking deflates the Schur basis: for the ill-conditioned 2x2
    blocks of a highly non-normal operator the discarded coupling can
    exceed the Ritz residual by orders of magnitude (the JAX package's
    docs/precision.md).  For normal operators this changes nothing."""
    m = H.shape[1]
    coupling = np.abs(h_last) * np.abs(np.asarray(Q[m - 1, :]))
    j = lo
    while j < hi:
        pair = j + 1 < m and H[j + 1, j] != 0
        if pair:
            v = max(rs[j], rs[j + 1], coupling[j], coupling[j + 1])
            rs[j] = rs[j + 1] = v
            j += 2
        else:
            rs[j] = max(rs[j], coupling[j])
            j += 1
    return rs


def partial_schur(
    A,
    *,
    n=None,
    dtype=None,
    v1=None,
    nev=None,
    which="LM",
    tol=None,
    mindim=None,
    maxdim=None,
    restarts=200,
    workspace=None,
    start_from=None,
    initialize=None,
    seed=0,
    device=None,
    sharding=None,
    method=None,
    extended=False,
    lowsync=False,
    split_complex=None,
    sparse_format="auto",
):
    """Compute an approximate partial Schur decomposition A Q = Q R with
    `nev` eigenvalues near the target `which`.

    A can be a LinearOperator, a square 2-D array or tensor, a
    scipy.sparse matrix, or a callable on tensors (then pass n= and
    dtype=).  Returns (PartialSchur, History).

    Keyword defaults mirror the reference exactly (run.jl:100-129):
    nev = min(6, n); which = 'LM'; tol = sqrt(eps(real dtype));
    mindim = min(max(10, nev), n); maxdim = min(max(20, 2 nev), n);
    restarts = 200.  Convergence: ||A x - lam x|| <= max(eps ||H||_F,
    tol |lam|), scale-invariant with a machine-epsilon floor
    (ref: run.jl:188-208).  which='LI' or 'SI' needs a complex operator
    dtype and raises ValueError for a real one.

    The solve runs where the basis lives: the workspace's device, else
    `device`, else the operator's device.  An operator built here from
    numpy, scipy or a callable goes to `device`, which defaults to the CUDA
    card (pass device="cpu" for the CPU); a tensor keeps its own device.  A
    random start comes from a torch.Generator seeded with `seed`.  Matmuls
    run in full FP32 (TF32 off for the duration of the call).

    Warm start / resume: pass `workspace` (an ArnoldiWorkspace holding a
    previous decomposition) plus `start_from` = previous nconverged
    (ref: partialschur!, run.jl:131-179).

    `sparse_format` ("auto" default): scipy.sparse input is repacked into
    the layout `models.operators.pick_sparse_format` picks for its pattern
    (DIA banded, BSR clustered, SELL irregular) on `device`; "csr" keeps
    the CSR gather path, or a layout name ('dia', 'bsr', 'sell', 'ell')
    forces one.  Ignored for operator, dense and callable input.

    `extended=True` runs the n-sized work (matvec, Gram-Schmidt, basis
    changes) in double-word arithmetic (ops/df_expansion.py): the basis is
    an unevaluated hi + lo pair, about eps_word^2 effective precision.
    float32 words reach tolerances down to ~1e-12 with the host float64
    dense layer; float64 words run the dense layer in double-double
    (ops/dd.py) and reach ~1e-28, returning Q/R as hi words with `Q_lo` and
    `R_lo` beside them.  With float32 words Q comes back as the float64
    combine hi + lo.  Needs a real dtype and, for full accuracy, an
    operator with `matvec_df(xh, xl)` (DiaOperator, Stencil5Operator);
    others take two plain matvecs.  The default tol drops to eps_word.
    On a CUDA card the double-word work runs in the kernels of
    `csrc/df.cu` (ops/df.py).  Both DGKS passes run every step and the
    step's decisions stay on the device; H and the range's breakdown
    flags come back in one transfer a restart, as with lowsync.

    `lowsync=True` runs the low-synchronization CGS2 expansion
    (ops/expansion.py::expand_range_lowsync): two contractions a Krylov
    step, the second pass always, and the breakdown test kept on the
    device, so a step makes no host read; H and the range's breakdown
    flags come back in one transfer a restart.  Real and complex dtypes;
    not with extended=True or method="device".

    `split_complex=True` is accepted for the JAX package's callers: a
    complex operator runs the native complex host path (the card has
    complex arithmetic, so the basis is not split into real words), a
    DenseOperator through `SplitComplexDenseOperator` as the JAX package
    wraps it, and a real dtype ignores the flag.  Not with lowsync,
    extended or method="device".  None and False run the native path.

    `method` None or "host" runs the host dense restart.  method="device"
    runs the whole restart on the device in the working dtype (fused.py):
    the DGKS expansion with its decisions kept on the device, and the dense
    phase as one launch of the restart kernel (`csrc/dense_restart.cu`) on
    the card, or its plain version on the CPU; one state read a restart.
    Real dtypes only; not with lowsync, extended or split_complex.

    `sharding=parallel.basis_sharding(mesh)` runs the solve row-sharded,
    SPMD over torch.distributed: every rank of the mesh calls partial_schur
    with the same arguments (`v1` the global vector) and holds its n/P rows
    of the basis; the contractions are summed over the ranks
    (parallel/comm.py) and the host decisions, taken from the summed
    values, agree on every rank.  Give `parallel.shard_operator(op, mesh)`;
    any other operator runs whole on every rank behind a wrapper that
    gathers x.  The host method (DGKS, lowsync, complex, split_complex,
    extended) and method="device" take it.  With extended=True each
    double-word sum is a local partial and one sum over the ranks in
    df_sum's tree order (`parallel.comm.RowComm.df_sum`): at one rank the
    solve is bitwise the unsharded one; on P ranks the low words differ
    from the unsharded sums' at rounding level.  `PartialSchur.Q` (and
    `Q_lo`) comes back as a DTensor placed Shard(0) on the mesh.
    """
    if method not in (None, "host", "device"):
        raise ValueError(f"method must be 'host' or 'device', got {method!r}")
    if extended and method == "device":
        raise ValueError(
            "extended=True runs the dense layer on the host (its float64 is "
            "below the double-word floor); method='device' is not compatible"
        )
    if extended and lowsync:
        raise ValueError(
            "lowsync applies to the plain expansion; extended=True has its "
            "own (double-word) orthogonalization"
        )
    if lowsync and method == "device":
        raise ValueError("lowsync is a host-method option")
    if sharding is None and workspace is not None:
        sharding = workspace.sharding

    op = as_operator(A, n=n, dtype=dtype, device=device,
                     sparse_format=sparse_format)
    n = op.shape[0]
    if op.shape[0] != op.shape[1]:
        raise ValueError("matrix is not square")
    target = as_target(which)
    if isinstance(target, (LI, SI)) and not op.dtype.is_complex:
        # A real operator's spectrum is symmetric about the real axis, so
        # ordering by imaginary part is meaningless (docs/index.md:49-57);
        # the JAX package accepts it and may return a wrong answer marked
        # converged.
        complex_dtype = (torch.complex64 if op.dtype == torch.float32
                         else torch.complex128)
        raise ValueError(
            f"which={type(target).__name__} needs a complex operator dtype, "
            f"got {op.dtype}: give the operator as {complex_dtype} (real "
            f"data cast to complex solves correctly)"
        )

    if nev is None:
        nev = min(6, n)
    if nev < 1:
        raise ValueError("nev cannot be less than 1")
    if mindim is None:
        mindim = min(max(10, nev), n)
    if maxdim is None:
        maxdim = min(max(20, 2 * nev), n)
    if workspace is not None:
        mindim = min(mindim, workspace.V.shape[0] - 1)
        maxdim = min(maxdim, workspace.V.shape[0] - 1)
    if not (nev <= mindim <= maxdim <= n):
        raise ValueError(
            "nev <= mindim <= maxdim <= size(A, 1) does not hold, got "
            f"{nev} <= {mindim} <= {maxdim} <= {n}"
        )

    work_dtype = op.dtype
    if extended and work_dtype not in (torch.float32, torch.float64):
        raise ValueError(
            f"extended=True supports real dtypes only (float32 or float64 "
            f"words), got {work_dtype}"
        )
    if split_complex and work_dtype.is_complex:
        if lowsync or extended:
            raise ValueError(
                "split-complex solves use the plain DGKS expansion "
                "(lowsync/extended are real-dtype options)"
            )
        if method == "device":
            raise ValueError(
                "complex matrices run split-complex on the host method"
            )
        if isinstance(op, DenseOperator):
            op = SplitComplexDenseOperator(op.A,
                                           word_dtype=work_dtype.to_real())
        if workspace is not None and not workspace.dtype.is_complex:
            # The JAX package's split-complex solves take a real workspace
            # (the real word; `Vim` holds the imaginary one): here the
            # basis is native complex.
            workspace.V = workspace.V.to(work_dtype)
            workspace.H = workspace.H.astype(np.complex128)
    if method == "device" and work_dtype.is_complex:
        raise ValueError(
            "method='device' supports real dtypes only (split-complex pair "
            "bookkeeping, as in the JAX package)"
        )
    comm = None
    if sharding is not None:
        comm = row_comm(sharding, n)
        if not isinstance(op, RowShardedOperator):
            op = GatheredOperator(op, comm)
        if workspace is not None and workspace.comm is None:
            raise ValueError("a sharded solve needs a sharded workspace "
                             "(ArnoldiWorkspace(..., sharding=sharding))")
    order_key = get_order(target)
    if tol is None:
        # extended: the double-word noise floor is ~eps^2, so the default
        # tolerance drops to eps of the single word.
        eps = torch.finfo(work_dtype.to_real()).eps
        tol = float(eps if extended else np.sqrt(eps))

    if workspace is None:
        dev = torch.device(device) if device is not None else op.device
    else:
        dev = workspace.device
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)

    with fp32_matmul(), trace.solve() as timings:
        if workspace is None:
            ws = ArnoldiWorkspace(n, maxdim, dtype=work_dtype, device=dev,
                                  sharding=sharding)
            if start_from is not None and start_from != 0:
                raise ValueError("start_from requires an explicit workspace")
            active0 = 0
            if v1 is not None:
                v1 = torch.as_tensor(v1)
                if tuple(v1.shape) != (n,):
                    raise ValueError("v1 should have the same dimension as A")
                set_initial_vector(ws.V, v1, comm)
            else:
                set_random_vector(ws.V, 0, generator, comm)
        else:
            ws = workspace
            if maxdim >= ws.V.shape[0]:
                raise ValueError(
                    "maxdim should be strictly less than V's row count"
                )
            active0 = 0 if start_from is None else int(start_from)
            if not 0 <= active0 <= maxdim:
                raise ValueError("start_from should be between 0 and maxdim")
            ws.H[:, active0:] = 0
            if initialize is None:
                initialize = active0 == 0 and v1 is None
            if v1 is not None:
                if active0 != 0:
                    raise ValueError("v1 requires start_from == 0")
                set_initial_vector(ws.V, torch.as_tensor(v1), comm)
            elif initialize:
                set_random_vector(ws.V, active0, generator, comm)

        if method == "device":
            schur, history = _partial_schur_device(
                op, ws, mindim, maxdim, nev, tol, restarts, target, generator,
                timings, active0, comm)
        else:
            schur, history = _partial_schur(
                op, ws, mindim, maxdim, nev, tol, restarts, target, order_key,
                active0, generator, timings, extended, lowsync,
                sc=bool(split_complex) and work_dtype.is_complex, comm=comm,
            )
    if comm is not None:
        sharded = PartialSchur(distribute_rows(schur.Q, sharding.mesh),
                               schur.R, schur.eigenvalues)
        if hasattr(schur, "Q_lo"):
            sharded.Q_lo = distribute_rows(schur.Q_lo, sharding.mesh)
            sharded.R_lo = schur.R_lo
        schur = sharded
    return schur, history


def _join(Hwords, dd):
    """The double-word Hessenberg's host words (hi, lo) as the float64 sum
    (float32 words) or as DD scalars (float64 words)."""
    Hh, Hl = Hwords
    if dd:
        return dd_pack(Hh, Hl)
    return Hh.astype(np.float64) + Hl.astype(np.float64)


def _df_words(Qbig, dd, V):
    """A host basis-change matrix as the double-word pair of V's type: the
    DD words themselves, or the float64 matrix split into two words."""
    if dd:
        return (torch.from_numpy(dd_hi(Qbig)).to(V.device),
                torch.from_numpy(dd_lo(Qbig)).to(V.device))
    return split_f64(Qbig, V.dtype, V.device)


def _partial_schur_device(op, ws, mindim, maxdim, nev, tol, restarts,
                          target, generator, timings, active0=0, comm=None):
    """The solve with its restarts on the device (fused.py), repackaged in
    the same PartialSchur/History types, leaving the workspace coherent for
    a later warm start by either method.  For a warm start the locked H
    block goes through the working dtype, as in the JAX package.  The
    whole fused solve is timings["device"]; "dense" and its parts stay
    0.0."""
    with trace.span(key="device"):
        V = ws.V
        Hdev = torch.as_tensor(ws.H).to(dtype=V.dtype, device=V.device)
        lam, state, reads = fused_solve(
            op, V, Hdev, nev, mindim, tol, restarts, generator,
            type(target).__name__, active0, comm=comm)
        # One batched readback of everything the host needs.
        packed = trace.to_numpy(torch.cat((Hdev.reshape(-1), lam.reshape(-1),
                                           state.to(Hdev.dtype))))
        reads += 1
        m = maxdim
        Hh = packed[:Hdev.numel()].reshape(Hdev.shape).astype(ws.H.dtype)
        lre = packed[Hdev.numel():Hdev.numel() + m].astype(np.float64)
        lim = packed[Hdev.numel() + m:Hdev.numel() + 2 * m].astype(np.float64)
        st = packed[Hdev.numel() + 2 * m:].astype(np.int64)
    if not st[STATE["qr_ok"]]:
        raise RuntimeError("QR algorithm did not converge")
    ncv = int(st[STATE["active"]])
    ws.H[:] = Hh
    # The real single-word path: double-word or split-complex words of an
    # earlier run on this workspace are stale now.
    ws.Vlo = None
    ws.Vim = None
    ws.Hlo = None
    history = History(
        int(st[STATE["prods"]]), ncv, ncv >= nev, nev,
        restarts=int(st[STATE["it"]]), purges=int(st[STATE["purges"]]),
        timings=timings, host_syncs=reads,
    )
    lam_c = lre + 1j * lim
    schur = PartialSchur(None, Hh[:ncv, :ncv].copy(), lam_c[:ncv].copy(),
                         Q_rows=V[:ncv].clone())
    return schur, history


def _partial_schur(op, ws, mindim, maxdim, nev, tol, restarts, target,
                   order_key, active0, generator, timings, extended=False,
                   lowsync=False, sc=False, comm=None):
    m = maxdim
    # Dense restart kernels: the native C++ core when it builds and the
    # workspace fits its scratch buffers; the numpy layer otherwise
    # (identical semantics, both on the host).
    use_native = _native.available() and m + 1 <= _native.MAX_DIM
    H = ws.H  # host authority, float64/complex128
    V = ws.V  # updated in place
    is_real = not np.iscomplexobj(H)
    eps_work = float(torch.finfo(V.dtype.to_real()).eps)
    # extended with float64 words: the dense restart layer itself runs in
    # double-double (ops/dd.py object arrays through the same numpy
    # kernels), so the criterion floor is the dd epsilon and tolerances
    # down to ~1e-28 certify.  With float32 words hi + lo fits a float64
    # exactly, so the plain float64 dense layer suffices, and the floor is
    # eps_word^2 but never below the host float64 epsilon.
    dd = extended and V.dtype == torch.float64
    dense_tol = None
    if dd:
        eps_work = max(eps_work * eps_work, DD_EPS)
        dense_tol = DD_EPS
        use_native = False  # the C++ layer is float64 only
    elif extended:
        eps_work = max(eps_work * eps_work, float(np.finfo(H.dtype).eps))

    lams = np.zeros(m, dtype=complex)
    rs = np.zeros(m, dtype=float)
    x = np.zeros(m, dtype=complex)
    groups = np.zeros(m, dtype=int)

    Hdev = torch.as_tensor(H).to(dtype=V.dtype, device=V.device)

    active = active0
    prods = m - active0
    purge_events = 0
    syncs = 0

    Vlo = Hlo = None
    if extended:
        # Resume the low word of an earlier extended run (a warm start at
        # double-word accuracy); rows past the locked prefix are stale.
        Vlo = ws.Vlo
        if Vlo is None or Vlo.shape != V.shape or Vlo.dtype != V.dtype:
            Vlo = torch.zeros_like(V)
        Vlo[active0:] = 0
        Hlo = torch.zeros_like(Hdev)
        if active0 == 0:
            # The start row was normalized in one word: again, in two.
            df_set_initial_vector(V, Vlo, V[0], comm)
        else:
            # The seed row is only single-word orthogonal to the locked
            # double-word prefix.
            df_reorthogonalize_row(V, Vlo, active0, comm)

    # Initial expansion straight to a maxdim-sized relation (the reference
    # stops at mindim first, but nothing happens in between,
    # run.jl:260-275).  The host array stays authoritative for locked
    # columns (no low-precision round trip of converged data).
    with trace.span("expand", "device"):
        if lowsync:
            Hpull, _, reads = expand_range_lowsync(op, V, Hdev, active0, m,
                                                   generator, comm)
            syncs += reads
        else:
            if extended:
                words, reads = df_expand_range(op, V, Vlo, Hdev, Hlo,
                                               active0, m, generator, comm)
                syncs += reads
                Hpull = _join(words, dd)
            else:
                syncs += expand_range(op, V, Hdev, active0, m, generator,
                                      comm)
                Hpull = trace.to_numpy(Hdev)
        if dd:
            # The host Hessenberg becomes an object array of DD scalars for
            # the whole restart loop; a warm start rehydrates the locked
            # block from both words (ws.H the hi words, ws.Hlo the lo
            # words).
            resume = active0 > 0 and ws.Hlo is not None
            H = dd_pack(H, ws.Hlo) if resume else dd_pack(H)
        H[:, active0:m] = Hpull[:, active0:m]

    # On exit, `pending_Q` holds the not-yet-applied final truncation; it
    # is composed with the final sort into a single GEMM.
    pending_Q = None

    it = 0
    for it in range(1, restarts + 1):
        # Dense restart phase (host, f64).
        with trace.span("dense_restart", "dense"):
            Q = np.eye(m, dtype=H.dtype)
            with trace.span("schur", "dense_schur"):
                if use_native:
                    _native.local_schur(H[:m, :], active, m, Q)
                    _native.copy_eigenvalues(lams, H[:m, :], 0, m)
                    _native.copy_residuals(rs, H[:m, :], Q, H[m, m - 1],
                                           active, m)
                    He, Qe = H, Q
                else:
                    local_schur(H[:m, :], active, m, Q, tol=dense_tol)
                    copy_eigenvalues(lams, H[:m, :], 0, m, tol=dense_tol)
                    # Residual estimates in float64 even in dd mode: the
                    # tiny last-row couplings are exact float64 values (only
                    # their low words drop), all the locking decision
                    # needs.  The similarity transforms above stay
                    # double-double.
                    He = dd_collapse(H) if dd else H
                    Qe = dd_collapse(Q) if dd else Q
                    _copy_residuals(rs, He, Qe, He[m, m - 1], x, active, m)
                _schur_coupling_floor(rs, He, Qe, He[m, m - 1], active, m)
            ord_ = np.array(
                sorted(range(m), key=lambda i: (order_key(lams[i]), i))
            )
            h_frob = np.linalg.norm(dd_hi(H) if dd else H)

            def isconverged(idx):
                return rs[idx] <= max(eps_work * h_frob, tol * abs(lams[idx]))

            # [locked | retained | purged] partitioning.  Keep nev or nev+1
            # depending on whether the cut would split a conjugate pair.
            effective_nev = (nev + 1 if _is_pair_at(lams, ord_, nev - 1,
                                                    is_real) else nev)

            nlock = 0
            for i in range(effective_nev):
                if isconverged(ord_[i]):
                    groups[ord_[i]] = 1
                    nlock += 1
                else:
                    groups[ord_[i]] = 2

            # Truncation size k: roughly mindim active columns, at most halfway
            # to maxdim, never splitting a pair (ref: run.jl:310-339).
            ideal_size = min(nlock + mindim, (mindim + maxdim) // 2)
            k = effective_nev
            i = effective_nev
            while i < m:
                pair = _is_pair_at(lams, ord_, i, is_real)
                num = 2 if pair else 1
                if k < ideal_size and not isconverged(ord_[i]):
                    group = 2
                    k += num
                else:
                    group = 3
                groups[ord_[i]] = group
                if pair:
                    groups[ord_[i + 1]] = group
                i += num

            # Index of the first formerly-locked vector that is being purged
            # (ref: run.jl:341-353).
            purge = 0
            while purge < active and groups[purge] == 1:
                purge += 1
            if purge < active:
                purge_events += 1

            with trace.span("reorder", "dense_reorder"):
                if use_native:
                    _native.partition_three_way(H[:m, :], Q, groups)
                    _native.restore_arnoldi(H, nlock, k, Q)
                else:
                    _partition_three_way(H[:m, :], Q, groups)
                    restore_arnoldi(H, nlock, k, Q)

            # Basis-change matrix: columns [purge, k) from Q, row k takes the
            # old row m (the next-vector slot), everything else passes through
            # untouched (ref: run.jl:363-365).
            Qbig = np.eye(m + 1, dtype=H.dtype)
            Qbig[:, purge:k] = 0
            Qbig[purge:m, purge:k] = Q[purge:m, purge:k]
            if k < m:
                Qbig[:, k] = 0
                Qbig[m, k] = 1

        active = nlock
        if active >= nev or it == restarts:
            # Applied below, composed with the final sort's GEMM.
            pending_Q = Qbig
            break

        # The device step of this restart: apply the truncation to V and
        # expand from k back to maxdim; then the one H readback.
        with trace.span("truncate_expand", "device"):
            if extended:
                # dd: Qbig's true hi/lo words (a split of the rounded value
                # would zero the low word).
                Qh, Ql = _df_words(Qbig, dd, V)
                words, reads = df_truncate_and_expand(
                    op, V, Vlo, Hdev, Hlo, Qh, Ql, k, m, generator, comm)
                syncs += reads
                Hpull = _join(words, dd)
            else:
                Qdev = torch.as_tensor(Qbig).to(dtype=V.dtype, device=V.device)
                if lowsync:
                    Hpull, _, reads = truncate_and_expand_lowsync(
                        op, V, Hdev, Qdev, k, m, generator, comm)
                    syncs += reads
                else:
                    syncs += truncate_and_expand(op, V, Hdev, Qdev, k, m,
                                                 generator, comm)
                    Hpull = trace.to_numpy(Hdev)
            H[:, k:m] = Hpull[:, k:m]
            prods += m - k

        if _DEBUG and not sc and not dd:
            # The JAX package's exemptions: split-complex (there V is only
            # the real word) and dd (H is an object array the finiteness
            # check cannot see through).
            _debug_checks(H, V, m, it, comm)

        # Keep the workspace coherent after every restart, so an exception
        # leaves a resumable state (dd: H is a fresh object array).
        ws.Vlo = Vlo
        if dd:
            ws.H[:] = dd_hi(H)
            ws.Hlo = dd_lo(H)

    nconverged = active

    # Sort the converged eigenvalues in the user's target order, and apply
    # the pending truncation + sort to V in one composed GEMM.
    with trace.span("finish"):
        with trace.span(key="dense"):
            Q = np.eye(m, dtype=H.dtype)
            with trace.span("reorder", "dense_reorder"):
                if use_native:
                    _native.sort_schur(H[:m, :], Q, nconverged,
                                       type(target).__name__)
                else:
                    _sort_schur(H[:m, :], Q, nconverged, order_key)
            Qbig = np.eye(m + 1, dtype=H.dtype)
            Qbig[:m, :m] = Q
            if pending_Q is not None:
                Qbig = pending_Q @ Qbig
        with trace.span(key="device"):
            if extended:
                df_apply_basis_change(V, Vlo, *_df_words(Qbig, dd, V))
                if dd:
                    # hi + lo would round lo away: Q carries the hi words,
                    # Q_lo the rest (a copy each, as below).
                    Q_rows = V[:nconverged].clone()
                    Q_lo = Vlo[:nconverged].clone().T
                else:
                    # float32 words: the combined value is exact in float64.
                    Q_rows = (V[:nconverged].double()
                              + Vlo[:nconverged].double())
            else:
                apply_basis_change(V, torch.as_tensor(Qbig).to(
                    dtype=V.dtype, device=V.device))
                # A copy: the workspace's V changes under any later solve
                # with it.
                Q_rows = V[:nconverged].clone()

    if nconverged > 0:
        if use_native:
            _native.copy_eigenvalues(lams, H[:m, :], 0, nconverged)
        else:
            copy_eigenvalues(lams, H[:m, :], 0, nconverged, tol=dense_tol)

    # The low word makes the workspace a double-word checkpoint after an
    # extended run; a plain solve invalidates it (V moved without it).
    ws.Vlo = Vlo
    ws.Hlo = None
    R = H[:nconverged, :nconverged]
    if dd:
        ws.H[:] = dd_hi(H)
        ws.Hlo = dd_lo(H)
        R = dd_hi(R)

    history = History(
        prods, nconverged, nconverged >= nev, nev, restarts=it,
        purges=purge_events, timings=timings,
        dense_layer="native" if use_native else "numpy", host_syncs=syncs,
    )
    schur = PartialSchur(None, R.copy(), lams[:nconverged].copy(),
                         Q_rows=Q_rows)
    if dd:
        schur.Q_lo = Q_lo
        schur.R_lo = dd_lo(H[:nconverged, :nconverged])
    return schur, history
