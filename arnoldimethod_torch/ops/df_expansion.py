"""Extended-precision Arnoldi expansion: the n-sized work of the solver in
double-word arithmetic (ops/df32.py), with the Krylov basis stored as an
unevaluated (V_hi, V_lo) pair.

With float32 words the working precision is about 2^-48, so the solver can
honour tolerances down to ~1e-12; with float64 words (and the host
double-double layer, ops/dd.py) down to ~1e-28, the reference's Double64
workflow (readme.md:81-99).

Step for step this is arnoldimethod_tpu/ops/df_expansion.py (same DGKS eta,
same breakdown handling; ArnoldiMethod.jl src/expansion.jl), with the
operator applied through `matvec_df(xh, xl) -> (yh, yl)`.  What differs:

  - The n-sized work goes through `ops/df.py`: on a CUDA tensor its
    kernels, on a CPU tensor their plain versions.  A masked row of the
    JAX package (a row past the current step) is simply not visited: its
    coefficient is zero, and adding a zero double word changes no value.
  - The step's scalar work (the Newton step of each norm, the reciprocal,
    the DGKS and breakdown decisions) runs inside df_normalize, from the
    sums of squares on the card: both Gram-Schmidt passes always run and
    the kernel keeps what the JAX package's `lax.cond`s would.  The sum of
    squares of a pass's result comes from the pass's own df_axpy launch
    (norm=True), the same bits as df_norm's sum.
  - The breakdown is deferred, as in ops/expansion.py's low-sync range:
    each step is written as if it kept its vector, its flag goes to a
    device tensor, and the flags come back once a range in the same
    transfer as the Hessenberg pair.  The first step that broke down is
    finished on the breakdown path and the steps after it run again (one
    more read); `expansion.LOWSYNC` counts such rollbacks.  The result is
    bitwise `df_expand_range_stepwise`'s, which decides each step on the
    host from numpy scalars of the word type (one or two reads a step).
  - Random rows come from the solve's `torch.Generator`; it advances only
    where the stepwise version's does.
  - V and the device Hessenberg pair (Hh, Hl) are updated in place.
"""

from __future__ import annotations

import numpy as np
import torch

from . import df, df32
from .df32 import ETA
from .expansion import LOWSYNC

__all__ = [
    "df_apply_basis_change",
    "df_expand_range",
    "df_expand_range_stepwise",
    "df_reorthogonalize_row",
    "df_set_initial_vector",
    "df_set_random_vector",
    "df_truncate_and_expand",
    "split_f64",
]


def _host(*scalars):
    """Device scalars to host numpy scalars of the word type: a single read
    (a sync on the card)."""
    return torch.stack([s.reshape(()) for s in scalars]).cpu().numpy()


def _eta(x):
    """The DGKS constant in x's word type (JAX: a weak Python scalar)."""
    return x.dtype.type(ETA)


def _sumsq(wh, wl):
    """The double-word sum of squares of w (df32.df_norm's sum)."""
    ch, cl = df.df_project(wh[None], wl[None], wh, wl, 1)
    return ch[0], cl[0]


def _masked_project(Vh, Vl, wh, wl, rows, acc=None, norm=False):
    """h = V[:rows] w and the projection update w - h V[:rows] in double
    word; with acc, acc <- acc + h as well (the JAX package's
    _df_masked_project).  With norm, also the updated w's sum of squares
    (df_axpy's fused form): (h, w, sum)."""
    ch, cl = df.df_project(Vh, Vl, wh, wl, rows, acc)
    out = df.df_axpy(wh, wl, ch, cl, Vh, Vl, rows, norm)
    return ((ch, cl), *out) if norm else ((ch, cl), out)


def _random_unit(generator, Vh, Vl, rows, out):
    """A fresh random unit vector orthogonal to V[:rows], double word, into
    the pair `out`."""
    zh = torch.randn(Vh.shape[1], dtype=Vh.dtype, device=Vh.device,
                     generator=generator)
    zl = torch.zeros_like(zh)
    _, z = _masked_project(Vh, Vl, zh, zl, rows)
    _, z, z2 = _masked_project(Vh, Vl, *z, rows, norm=True)
    df.df_normalize(z, z2, out)


def _matvec_df(op, xh, xl):
    if hasattr(op, "matvec_df"):
        return op.matvec_df(xh, xl)
    # Two plain matvecs: the matvec's own rounding then floors the residual
    # at ~eps_word * ||A||; operators wanting the full double word implement
    # matvec_df.
    yh, yl = op.matvec(xh), op.matvec(xl)
    return df32.df_add(yh, torch.zeros_like(yh), yl, torch.zeros_like(yl))


def _step(op, Vh, Vl, Hh, Hl, j, flags):
    """Krylov step j with no host read: the matvec, its sum of squares,
    both Gram-Schmidt passes (each norm fused into its df_axpy), then
    df_normalize's step form, which decides, writes V[j+1], H's column j
    and flags[j].  Seven launches with a one-launch matvec_df."""
    wh, wl = _matvec_df(op, Vh[j], Vl[j])
    r2 = _sumsq(wh, wl)
    h1, w1, s1 = _masked_project(Vh, Vl, wh, wl, j + 1, norm=True)
    c, w2, s2 = _masked_project(Vh, Vl, *w1, j + 1, norm=True)
    df.df_normalize(w1, s1, (Vh[j + 1], Vl[j + 1]),
                    df.DgksStep(r2, w2, s2, h1, c, (Hh, Hl), j, flags))


def _finish_breakdown(Vh, Vl, Hh, Hl, j, j1, generator):
    """Finish step j, found broken down after its range ran on to j1, on
    the breakdown path: H[j+1, j] = 0 and a fresh random row (w itself
    stays when j+1 == n).  Counts the rollback in `LOWSYNC`."""
    LOWSYNC.rollbacks += 1
    LOWSYNC.discarded_matvecs += j1 - 1 - j
    Hh[j + 1, j] = 0
    Hl[j + 1, j] = 0
    if j + 1 < Vh.shape[1]:
        _random_unit(generator, Vh, Vl, j + 1, (Vh[j + 1], Vl[j + 1]))


def df_expand_range(op, Vh, Vl, Hh, Hl, j0, j1, generator):
    """Extend A V[:j].T = V[:j+1].T H[:j+1, :j] in double word, writing
    basis rows j0+1 .. j1 and the columns j0 .. j1-1 of the device pair
    (Hh, Hl), in place, with no host read inside a step.  One transfer
    brings back (Hh, Hl) and every step's breakdown flag.  If step j*
    broke down, it is finished on the breakdown path and the steps from
    j*+1 run again, one more read.  The result equals
    `df_expand_range_stepwise` bit for bit.

    Returns ((Hh, Hl) on the host as numpy arrays of the word type, host
    reads made)."""
    size = Hh.numel()
    flags = torch.zeros(Hh.shape[1], dtype=Hh.dtype, device=Hh.device)
    reads = 0
    start = j0
    while True:
        for j in range(start, j1):
            _step(op, Vh, Vl, Hh, Hl, j, flags)
        packed = torch.cat((Hh.reshape(-1), Hl.reshape(-1), flags))
        packed = packed.cpu().numpy()
        reads += 1
        host = (packed[:size].reshape(Hh.shape),
                packed[size:2 * size].reshape(Hh.shape))
        broke = np.flatnonzero(packed[2 * size + start:2 * size + j1])
        if broke.size == 0:
            return host, reads
        j = start + int(broke[0])
        _finish_breakdown(Vh, Vl, Hh, Hl, j, j1, generator)
        host[0][j + 1, j] = host[1][j + 1, j] = 0
        start = j + 1
        if start == j1:
            return host, reads


def _dgks(Vh, Vl, wh, wl, rows):
    """Two-stage DGKS against V[:rows] in double word, decided on the host.
    Returns (w, its device sum of squares, (hh, hl), the host double-word
    norm of w, ref, reads): ref the hi word of the norm before the last
    pass."""
    r2 = _sumsq(wh, wl)
    (hh, hl), w, s = _masked_project(Vh, Vl, wh, wl, rows, norm=True)
    host = _host(*r2, *s)
    rnorm = df32.df_sqrt(host[0], host[1])[0]
    wnorm = df32.df_sqrt(host[2], host[3])
    if wnorm[0] < _eta(rnorm) * rnorm:
        _, w, s = _masked_project(Vh, Vl, *w, rows, acc=(hh, hl), norm=True)
        return w, s, (hh, hl), df32.df_sqrt(*_host(*s)), wnorm[0], 2
    return w, s, (hh, hl), wnorm, rnorm, 1


def df_expand_range_stepwise(op, Vh, Vl, Hh, Hl, j0, j1, generator):
    """The expansion with each step's decisions made on the host as the
    step makes them, from numpy scalars of the word type (one read after
    the first Gram-Schmidt pass, one more when the second runs): the plain
    version that `df_expand_range` must equal bit for bit.  On no path of
    partial_schur.  Returns the number of host reads made."""
    n = Vh.shape[1]
    syncs = 0
    for j in range(j0, j1):
        wh, wl = _matvec_df(op, Vh[j], Vl[j])
        w, s, (hh, hl), (nh, nl), ref, reads = _dgks(Vh, Vl, wh, wl, j + 1)
        syncs += reads
        Hh[:, j] = hh
        Hl[:, j] = hl
        if not nh <= _eta(ref) * ref:
            df.df_normalize(w, s, (Vh[j + 1], Vl[j + 1]))
            Hh[j + 1, j] = float(nh)
            Hl[j + 1, j] = float(nl)
        elif j + 1 < n:
            # H[j+1, j] stays zero: deflation.
            _random_unit(generator, Vh, Vl, j + 1, (Vh[j + 1], Vl[j + 1]))
        else:
            # The basis already spans the whole space.
            Vh[j + 1], Vl[j + 1] = w
    return syncs


def df_apply_basis_change(Vh, Vl, Qh, Ql, rows=None):
    """V[:rows] <- (Q^T V)[:rows] with both the basis and the (m+1, m+1)
    matrix double word: out[i] = sum_j Q[j, i] V[j], rows j in order (all
    rows by default).  In place: the kernel writes V itself where its plan
    allows, else a temporary copied back."""
    df.df_basis_change(Vh, Vl, Qh, Ql, rows, out=(Vh, Vl))


def df_truncate_and_expand(op, Vh, Vl, Hh, Hl, Qh, Ql, j0, j1, generator):
    """One restart's device step: the truncation basis change, then the
    expansion from j0 back to j1; returns what `df_expand_range` returns.
    When the expansion runs to the last row (j1 = m, as every restart does),
    only rows 0..j0 of the change are computed: the expansion rewrites rows
    j0+1..j1 before it reads them (the JAX package computes them and
    overwrites them, so V ends bitwise the same)."""
    rows = j0 + 1 if j1 == Vh.shape[0] - 1 else None
    df_apply_basis_change(Vh, Vl, Qh, Ql, rows)
    return df_expand_range(op, Vh, Vl, Hh, Hl, j0, j1, generator)


def df_set_initial_vector(Vh, Vl, v):
    """V[0] = v / ||v|| in double word (v single-word, not mutated); no
    host read."""
    vh = v.to(dtype=Vh.dtype, device=Vh.device, copy=True)
    vl = torch.zeros_like(vh)
    df.df_normalize((vh, vl), _sumsq(vh, vl), (Vh[0], Vl[0]))


def df_reorthogonalize_row(Vh, Vl, j):
    """Orthogonalize row j against rows [0, j) and renormalize, in double
    word: on a warm start the seed row was placed by the single-word path.
    No host read."""
    wh, wl = Vh[j].clone(), Vl[j].clone()
    _, w = _masked_project(Vh, Vl, wh, wl, j)
    _, w, w2 = _masked_project(Vh, Vl, *w, j, norm=True)
    df.df_normalize(w, w2, (Vh[j], Vl[j]))


def df_set_random_vector(Vh, Vl, j, generator):
    """V[j] = a fresh random unit vector orthogonal to rows [0, j)."""
    _random_unit(generator, Vh, Vl, j, (Vh[j], Vl[j]))


def split_f64(Q, dtype, device):
    """A host float64 matrix as a double-word pair of torch `dtype` on
    `device`: hi = round(Q), lo = round(Q - hi)."""
    word = torch.empty(0, dtype=dtype).numpy().dtype
    hi = np.asarray(Q, dtype=word)
    lo = np.asarray(Q - hi.astype(np.float64), dtype=word)
    return (torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device))
