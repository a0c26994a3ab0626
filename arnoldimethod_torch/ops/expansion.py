"""Arnoldi expansion: the n-sized device work of the solver.

Per Krylov step: one matvec, then classical Gram-Schmidt with DGKS
re-orthogonalization (eta = sqrt(2)/2, the ARPACK constant).  The basis V is
a (maxdim+1, n) tensor with the vectors as rows; the projection
coefficients are one GEMV against the filled rows V[:j+1].  Everything
updates V and the device Hessenberg H in place.

The two data-dependent decisions of a DGKS step, whether to run the second
Gram-Schmidt pass and whether the new vector broke down, are Python
branches on values read back from the device: one host sync per step, two
when the second pass runs.  Each function that expands returns the number
of syncs it made, so a caller can count them.

The low-sync expansion (`expand_range_lowsync`, the JAX package's
`expand_range_lowsync_impl`) runs CGS2 unconditionally and takes ||w||^2
from the same contraction as the coefficients, so its only data-dependent
decision is the breakdown test.  That test stays on the device: each step
writes the keep branch speculatively and records its flag in a device
tensor, and the flags are read once a range, in the same transfer as the
Hessenberg.  A step that broke down is finished on the breakdown path
after that read and the steps after it are run again; `LOWSYNC` counts
such rollbacks and the matvecs they threw away.

`method="device"` runs the DGKS step with the same deferral
(`expand_range_device`): both Gram-Schmidt passes run and `torch.where`
keeps what the host step's branch would; the restart kernel reads the
flags, and the fused loop finishes a step that broke down with the same
`finish_breakdown`.

Sharded (`comm`, a `parallel.comm.RowComm`): V holds this rank's columns
of the basis and every function that contracts over n sums its local
products over the ranks with one all-reduce a pass, the norm ||w||^2 in the
same buffer as V^H w where the pass has both: a DGKS step makes two
all-reduces, four when its second pass runs; a CGS2 step two; the device
method's step three.  The decisions are taken from the summed values,
which every rank receives bit for bit the same, so every rank decides
alike.  A random row is drawn at full length n from the generator (seeded
alike on every rank) and each rank keeps its rows.  The basis change needs
no collective.  With comm None (and at one rank, where the sum over ranks
is the local value) the arithmetic is exactly the unsharded one.

Every step loop here and in ops/df_expansion.py marks its phases with the
spans of trace.py: a Krylov step is the profiler range arnoldi:step and its
operator application arnoldi:matvec (while a profiler records; the rest of
the step is its Gram-Schmidt), and every host read adds its wait to the
running solve's `timings["sync_wait"]`.

Contractions run in full FP32 (or the working precision): call them inside
`fp32_matmul()`, which turns TF32 off, as `partial_schur` does.  A basis
that loses orthogonality to TF32 rounding stalls the restart.

Behavioral reference: arnoldimethod_tpu/ops/expansion.py, which follows
ArnoldiMethod.jl src/expansion.jl (orthogonalize! :69-109, reinitialize!
:12-59, iterate_arnoldi! :116-133).  Breakdown (new vector numerically in
the span) zeroes H[j+1, j] and replaces the row with a fresh random vector
orthogonal to the basis, except when the basis already spans the space.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import trace
from .df32 import ETA

__all__ = [
    "ETA",
    "LOWSYNC",
    "apply_basis_change",
    "expand_range",
    "expand_range_device",
    "expand_range_lowsync",
    "expand_range_lowsync_stepwise",
    "finish_breakdown",
    "fp32_matmul",
    "orthonormalize_rows",
    "set_initial_vector",
    "set_random_vector",
    "truncate_and_expand",
    "truncate_and_expand_lowsync",
]


@contextlib.contextmanager
def fp32_matmul():
    """Turn TF32 off for matmuls and cuDNN inside the block, restoring the
    caller's settings on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _global_n(V, comm):
    """The basis's length n: V's own, or the sharded basis's global one."""
    return V.shape[1] if comm is None else comm.n


def _summed(t, comm):
    """t summed over the ranks (in place), or t itself unsharded."""
    return t if comm is None else comm.all_reduce_(t)


def _coeffs(B, w, comm, norm=False):
    """(B^H w, ||w||^2 or None), summed over the ranks in one all-reduce:
    the norm rides in the coefficients' buffer."""
    h = torch.mv(B.conj(), w)
    if not norm:
        return _summed(h, comm), None
    s = torch.real(torch.vdot(w, w))
    if comm is None:
        return h, s
    buf = comm.all_reduce_(torch.cat((h, s.reshape(1).to(h.dtype))))
    return buf[:-1], torch.real(buf[-1])


def _norm(w, comm=None):
    s = torch.real(torch.vdot(w, w))
    if comm is not None:
        s = comm.all_reduce_(s.reshape(1))[0]
    return torch.sqrt(s)


def _project(B, w, comm=None):
    """h = B^H w and the projection update w - B^T h over the rows of B."""
    h, _ = _coeffs(B, w, comm)
    return h, w - torch.mv(B.T, h)


def _dgks_orthogonalize(B, w, comm=None):
    """Two-stage DGKS against the rows of B.  Returns (w, h, breakdown,
    wnorm, syncs): breakdown iff the final norm <= ETA * the norm before
    the last pass (ref: expansion.jl:69-109)."""
    h, r2 = _coeffs(B, w, comm, norm=True)
    rnorm = torch.sqrt(r2)
    w = w - torch.mv(B.T, h)
    wnorm = _norm(w, comm)
    with trace.span(key="sync_wait"):
        r, wn = torch.stack((rnorm, wnorm)).tolist()
    if wn < ETA * r:
        c, w = _project(B, w, comm)
        h = h + c
        wnorm2 = _norm(w, comm)
        with trace.span(key="sync_wait"):
            wn2 = wnorm2.item()
        return w, h, wn2 <= ETA * wn, wnorm2, 2
    return w, h, wn <= ETA * r, wnorm, 1


def _random_unit_vector(generator, n, dtype, device, B, comm=None):
    """Fresh random vector orthonormalized against the rows of B
    (ref: reinitialize!, expansion.jl:12-59).  Sharded, the full length-n
    draw, this rank's rows of it."""
    v = torch.randn(n, dtype=dtype, device=device, generator=generator)
    if comm is not None:
        v = comm.local(v)
    _, v = _project(B, v, comm)
    _, v = _project(B, v, comm)
    return v / _norm(v, comm)


def expand_range(op, V, H, j0, j1, generator, comm=None):
    """Extend the Arnoldi relation A V[:j].T = V[:j+1].T H[:j+1, :j] by
    computing basis rows j0+1 .. j1 and H columns j0 .. j1-1, in place.

    V: (maxdim+1, n) basis rows; H: (maxdim+1, maxdim) device Hessenberg
    (only columns [j0, j1) are written; the caller owns the authoritative
    host copy of older columns).  `generator` draws the random vectors of
    the breakdown path.  Returns the number of host syncs made."""
    n = _global_n(V, comm)
    syncs = 0
    for j in range(j0, j1):
        with trace.span("step"):
            with trace.span("matvec"):
                w = op.matvec(V[j])
            B = V[: j + 1]
            w, h, breakdown, wnorm, s = _dgks_orthogonalize(B, w, comm)
            syncs += s
            H[:, j] = 0
            H[: j + 1, j] = h
            if not breakdown:
                H[j + 1, j] = wnorm
                V[j + 1] = w / wnorm
            elif j + 1 < n:
                # H[j+1, j] stays zero: deflation.
                V[j + 1] = _random_unit_vector(generator, n, V.dtype,
                                               V.device, B, comm)
            else:
                # The basis already spans the whole space (expansion.jl:127).
                V[j + 1] = w
    return syncs


class LowSyncCounts:
    """What the low-sync expansion's speculation cost: `rollbacks` counts
    the breakdowns found after their range had run on, `discarded_matvecs`
    the speculative steps (one matvec each) thrown away with them.  Reset
    them to 0 to count one solve."""

    def __init__(self):
        self.rollbacks = 0
        self.discarded_matvecs = 0


LOWSYNC = LowSyncCounts()


def _cgs2_step(op, V, H, j, comm=None):
    """The arithmetic of one low-sync Krylov step, JAX's step for step:
    the unnormalized w goes into the spare row j+1 first, so one
    contraction V[:j+2]^H w gives the coefficients and ||w||^2; a second
    pass the same way; h = h1 + h2 into H[:j+1, j]; the final norm by the
    Pythagorean identity.  Leaves the unnormalized w in V[j+1] and returns
    (wnorm, breakdown), both on the device (no host read).  Each update
    w - V[:j+1]^T h is one in-place GEMV.  JAX also takes the pre-pass
    norm re(c1[j+1]) and drops it unused."""
    with trace.span("matvec"):
        w = op.matvec(V[j])
    B = V[: j + 1]
    C = V[: j + 2].conj()
    row = V[j + 1]
    row.copy_(w)
    c1 = _summed(torch.mv(C, row), comm)
    row.addmv_(B.T, c1[: j + 1], alpha=-1)
    c2 = _summed(torch.mv(C, row), comm)
    h2 = c2[: j + 1]
    row.addmv_(B.T, h2, alpha=-1)
    torch.add(c1[: j + 1], h2, out=H[: j + 1, j])
    w1norm2 = torch.real(c2[j + 1])
    wnorm = torch.sqrt(torch.clamp(
        w1norm2 - torch.real(torch.vdot(h2, h2)), min=0.0))
    # Breakdown is judged against the norm after the first pass.
    breakdown = wnorm <= ETA * torch.sqrt(torch.clamp(w1norm2, min=0.0))
    return wnorm, breakdown


def expand_range_lowsync_stepwise(op, V, H, j0, j1, generator, comm=None):
    """The low-sync expansion with each step's breakdown flag read as the
    step makes it: the plain version that `expand_range_lowsync` must
    equal bit for bit.  Returns (flags of steps j0..j1-1, host reads)."""
    n = _global_n(V, comm)
    H[:, j0:j1] = 0
    flags = []
    for j in range(j0, j1):
        with trace.span("step"):
            wnorm, breakdown = _cgs2_step(op, V, H, j, comm)
        flags.append(bool(breakdown))
        if not flags[-1]:
            H[j + 1, j] = wnorm
            V[j + 1].div_(wnorm)
        elif j + 1 < n:
            # H[j+1, j] stays zero: deflation.
            V[j + 1] = _random_unit_vector(generator, n, V.dtype, V.device,
                                           V[: j + 1], comm)
        # else the basis spans the whole space and V[j+1] keeps w
        # (expansion.jl:127).
    return flags, len(flags)


def _speculate(op, V, H, j0, j1, flags, step=_cgs2_step, comm=None):
    """Steps j0..j1-1 of `step`, each written as if it kept its vector,
    its breakdown flag recorded in `flags[j]`; no host read."""
    for j in range(j0, j1):
        with trace.span("step"):
            wnorm, breakdown = step(op, V, H, j, comm)
            H[j + 1, j] = wnorm
            # A step that broke down keeps w unscaled: the row stays finite
            # for the steps that run on it until the flags are read, and it
            # is already the row of the breakdown path when j+1 == n.
            row = V[j + 1]
            torch.where(breakdown, row, row / wnorm, out=row)
            flags[j] = breakdown


def finish_breakdown(V, H, j, j1, generator, comm=None):
    """Finish step j, found broken down after its range ran on to j1, on
    the breakdown path: H[j+1, j] = 0 and a fresh random row (w itself
    stays when j+1 == n).  Counts the rollback in `LOWSYNC`."""
    LOWSYNC.rollbacks += 1
    LOWSYNC.discarded_matvecs += j1 - 1 - j
    H[j + 1, j] = 0
    n = _global_n(V, comm)
    if j + 1 < n:
        V[j + 1] = _random_unit_vector(generator, n, V.dtype, V.device,
                                       V[: j + 1], comm)


def _dgks_step(op, V, H, j, comm=None):
    """One DGKS step with its decisions kept on the device: both passes
    run, and torch.where takes what the host step's branch would, compared
    in float64 as the host compares its read values.  Leaves w in V[j+1]
    and h in H[:j+1, j] and returns (wnorm, breakdown) on the device; the
    arithmetic is `_dgks_orthogonalize`'s, bit for bit."""
    with trace.span("matvec"):
        w = op.matvec(V[j])
    B = V[: j + 1]
    h1, r2 = _coeffs(B, w, comm, norm=True)
    rnorm = torch.sqrt(r2)
    w1 = w - torch.mv(B.T, h1)
    c, s1 = _coeffs(B, w1, comm, norm=True)
    wnorm1 = torch.sqrt(s1)
    w2 = w1 - torch.mv(B.T, c)
    h2 = h1 + c
    wnorm2 = _norm(w2, comm)
    second = wnorm1.double() < ETA * rnorm.double()
    V[j + 1] = torch.where(second, w2, w1)
    H[:, j] = 0
    H[: j + 1, j] = torch.where(second, h2, h1)
    wnorm = torch.where(second, wnorm2, wnorm1)
    ref = torch.where(second, wnorm1, rnorm)
    return wnorm, wnorm.double() <= ETA * ref.double()


def expand_range_device(op, V, H, j0, j1, flags, comm=None):
    """The DGKS expansion of basis rows j0+1 .. j1 and H columns
    j0 .. j1-1 with no host read (`method="device"`): each step's two
    decisions stay on the device and its breakdown flag goes to
    `flags[j]` (cleared first over [j0, j1)), the steps written as if
    they kept their vectors.  Whoever reads the flags finishes the first
    step that broke down with `finish_breakdown` and runs the steps after
    it again; the result then equals `expand_range` bit for bit."""
    flags[j0:j1] = 0
    _speculate(op, V, H, j0, j1, flags, step=_dgks_step, comm=comm)


def expand_range_lowsync(op, V, H, j0, j1, generator, comm=None):
    """The low-sync expansion of basis rows j0+1 .. j1 and H columns
    j0 .. j1-1, in place, with the breakdown decisions deferred: the steps
    run on without a host read, and one transfer brings back H and every
    step's flag.  If step j* broke down, it is finished on the breakdown
    path (H[j*+1, j*] = 0 and a fresh random row, or w itself when
    j*+1 == n) and the steps from j*+1 run again, one more read.  The
    result equals `expand_range_lowsync_stepwise` bit for bit, and the
    generator advances only where that version's does.

    Returns (H on the host as a numpy array, the flags of steps j0..j1-1,
    host reads made)."""
    size = H.numel()
    H[:, j0:j1] = 0
    flags = torch.zeros(H.shape[1], dtype=H.dtype, device=H.device)
    final = [False] * (j1 - j0)
    reads = 0
    start = j0
    while True:
        _speculate(op, V, H, start, j1, flags, comm=comm)
        packed = trace.to_numpy(torch.cat((H.reshape(-1), flags)))
        reads += 1
        Hh = packed[:size].reshape(H.shape)
        broke = np.flatnonzero(packed[size + start: size + j1])
        if broke.size == 0:
            return Hh, final, reads
        j = start + int(broke[0])
        final[j - j0] = True
        finish_breakdown(V, H, j, j1, generator, comm)
        Hh[j + 1, j] = 0
        start = j + 1
        if start == j1:
            return Hh, final, reads


def apply_basis_change(V, Qbig):
    """V <- Qbig^T @ V in place: one (m+1, m+1) x (m+1, n) GEMM implements
    the Krylov-Schur truncation / final reordering of the basis
    (ref: run.jl:363-365, 382-383).  The product goes to a temporary and is
    copied back, so V keeps its storage."""
    V.copy_(torch.matmul(Qbig.T, V))
    return V


def truncate_and_expand(op, V, H, Qbig, j0, j1, generator, comm=None):
    """One restart's device step: the truncation basis change, then the
    expansion from j0 back to j1.  Returns the number of host syncs."""
    apply_basis_change(V, Qbig)
    return expand_range(op, V, H, j0, j1, generator, comm)


def truncate_and_expand_lowsync(op, V, H, Qbig, j0, j1, generator,
                                comm=None):
    """The low-sync twin of `truncate_and_expand`; returns what
    `expand_range_lowsync` returns."""
    apply_basis_change(V, Qbig)
    return expand_range_lowsync(op, V, H, j0, j1, generator, comm)


def set_initial_vector(V, v, comm=None):
    """V[0] = v / ||v||; v is not mutated and need not be normalized
    (ref: run.jl:38, reinitialize! with j == 0).  Sharded, v is the global
    vector and V[0] takes this rank's rows."""
    v = v.to(dtype=V.dtype, device=V.device)
    if comm is not None:
        v = comm.local(v)
    V[0] = v / _norm(v, comm)
    return V


def set_random_vector(V, j, generator, comm=None):
    """V[j] = fresh random unit vector orthogonal to rows [0, j), the
    warm-start reinitialization (partialschur! with initialize=true)."""
    V[j] = _random_unit_vector(generator, _global_n(V, comm), V.dtype,
                               V.device, V[:j], comm)
    return V


def orthonormalize_rows(X, generator, comm=None):
    """Orthonormalize the rows of X (k, n) in place with CGS2/DGKS.  Rows
    that fall in the span of earlier rows (breakdown) are replaced with
    fresh random orthonormal directions, so the result always has full row
    rank."""
    k, n = X.shape[0], _global_n(X, comm)
    for j in range(k):
        B = X[:j]
        w, _, breakdown, wnorm, _ = _dgks_orthogonalize(B, X[j], comm)
        if breakdown:
            X[j] = _random_unit_vector(generator, n, X.dtype, X.device, B,
                                       comm)
        else:
            X[j] = w / wnorm
    return X
