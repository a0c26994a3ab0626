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
  - The scalar work (the Newton step of each norm, the reciprocal, the
    DGKS and breakdown tests) runs on the host, on numpy scalars of the
    word type, with the operations of df32.py: one device-to-host read
    after the first Gram-Schmidt pass, one more when the second pass runs.
  - Random rows come from the solve's `torch.Generator`.
  - V and the device Hessenberg pair (Hh, Hl) are updated in place.
"""

from __future__ import annotations

import numpy as np
import torch

from . import df, df32
from .expansion import ETA

__all__ = [
    "df_apply_basis_change",
    "df_expand_range",
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


def _norm(wh, wl):
    """The double-word norm of w on the host (one read)."""
    s = _host(*_sumsq(wh, wl))
    return df32.df_sqrt(s[0], s[1])


def _masked_project(Vh, Vl, wh, wl, rows, acc=None):
    """h = V[:rows] w and the projection update w - h V[:rows] in double
    word; with acc, acc <- acc + h as well (the JAX package's
    _df_masked_project)."""
    ch, cl = df.df_project(Vh, Vl, wh, wl, rows, acc)
    return (ch, cl), df.df_axpy(wh, wl, ch, cl, Vh, Vl, rows)


def _normalize(wh, wl, nh, nl, out=None):
    """w / ||w|| for the host double-word norm (nh, nl)."""
    ih, il = df32.df_inv(nh, nl)
    return df.df_mul_by(wh, wl, ih, il, out)


def _dgks(Vh, Vl, wh, wl, rows):
    """Two-stage DGKS against V[:rows] in double word.  Returns (wh, wl, hh,
    hl, norm, ref, syncs): norm the host double-word norm of the returned w,
    ref the hi word of the norm before the last pass."""
    r2 = _sumsq(wh, wl)
    (hh, hl), (wh, wl) = _masked_project(Vh, Vl, wh, wl, rows)
    s = _host(*r2, *_sumsq(wh, wl))
    rnorm = df32.df_sqrt(s[0], s[1])[0]
    wnorm = df32.df_sqrt(s[2], s[3])
    if wnorm[0] < _eta(rnorm) * rnorm:
        _, (wh, wl) = _masked_project(Vh, Vl, wh, wl, rows, acc=(hh, hl))
        return wh, wl, hh, hl, _norm(wh, wl), wnorm[0], 2
    return wh, wl, hh, hl, wnorm, rnorm, 1


def _random_unit(generator, Vh, Vl, rows):
    """A fresh random unit vector orthogonal to V[:rows], double word."""
    zh = torch.randn(Vh.shape[1], dtype=Vh.dtype, device=Vh.device,
                     generator=generator)
    zl = torch.zeros_like(zh)
    _, (zh, zl) = _masked_project(Vh, Vl, zh, zl, rows)
    _, (zh, zl) = _masked_project(Vh, Vl, zh, zl, rows)
    return _normalize(zh, zl, *_norm(zh, zl))


def _matvec_df(op, xh, xl):
    if hasattr(op, "matvec_df"):
        return op.matvec_df(xh, xl)
    # Two plain matvecs: the matvec's own rounding then floors the residual
    # at ~eps_word * ||A||; operators wanting the full double word implement
    # matvec_df.
    yh, yl = op.matvec(xh), op.matvec(xl)
    return df32.df_add(yh, torch.zeros_like(yh), yl, torch.zeros_like(yl))


def df_expand_range(op, Vh, Vl, Hh, Hl, j0, j1, generator):
    """Extend A V[:j].T = V[:j+1].T H[:j+1, :j] in double word, writing
    basis rows j0+1 .. j1 and the columns j0 .. j1-1 of the device pair
    (Hh, Hl), in place.  Returns the number of host reads made."""
    n = Vh.shape[1]
    syncs = 0
    for j in range(j0, j1):
        wh, wl = _matvec_df(op, Vh[j], Vl[j])
        wh, wl, hh, hl, (nh, nl), ref, s = _dgks(Vh, Vl, wh, wl, j + 1)
        syncs += s
        Hh[:, j] = hh
        Hl[:, j] = hl
        if not nh <= _eta(ref) * ref:
            _normalize(wh, wl, nh, nl, out=(Vh[j + 1], Vl[j + 1]))
            Hh[j + 1, j] = float(nh)
            Hl[j + 1, j] = float(nl)
        elif j + 1 < n:
            # H[j+1, j] stays zero: deflation.
            Vh[j + 1], Vl[j + 1] = _random_unit(generator, Vh, Vl, j + 1)
            syncs += 1
        else:
            # The basis already spans the whole space.
            Vh[j + 1], Vl[j + 1] = wh, wl
    return syncs


def df_apply_basis_change(Vh, Vl, Qh, Ql, rows=None):
    """V[:rows] <- (Q^T V)[:rows] with both the basis and the (m+1, m+1)
    matrix double word: out[i] = sum_j Q[j, i] V[j], rows j in order (all
    rows by default).  In place: the kernel writes V itself where its plan
    allows, else a temporary copied back."""
    df.df_basis_change(Vh, Vl, Qh, Ql, rows, out=(Vh, Vl))


def df_truncate_and_expand(op, Vh, Vl, Hh, Hl, Qh, Ql, j0, j1, generator):
    """One restart's device step: the truncation basis change, then the
    expansion from j0 back to j1.  Returns the number of host reads.  When
    the expansion runs to the last row (j1 = m, as every restart does), only
    rows 0..j0 of the change are computed: the expansion rewrites rows
    j0+1..j1 before it reads them (the JAX package computes them and
    overwrites them, so V ends bitwise the same)."""
    rows = j0 + 1 if j1 == Vh.shape[0] - 1 else None
    df_apply_basis_change(Vh, Vl, Qh, Ql, rows)
    return df_expand_range(op, Vh, Vl, Hh, Hl, j0, j1, generator)


def df_set_initial_vector(Vh, Vl, v):
    """V[0] = v / ||v|| in double word (v single-word, not mutated)."""
    vh = v.to(dtype=Vh.dtype, device=Vh.device, copy=True)
    vl = torch.zeros_like(vh)
    _normalize(vh, vl, *_norm(vh, vl), out=(Vh[0], Vl[0]))


def df_reorthogonalize_row(Vh, Vl, j):
    """Orthogonalize row j against rows [0, j) and renormalize, in double
    word: on a warm start the seed row was placed by the single-word path."""
    wh, wl = Vh[j].clone(), Vl[j].clone()
    _, (wh, wl) = _masked_project(Vh, Vl, wh, wl, j)
    _, (wh, wl) = _masked_project(Vh, Vl, wh, wl, j)
    _normalize(wh, wl, *_norm(wh, wl), out=(Vh[j], Vl[j]))


def df_set_random_vector(Vh, Vl, j, generator):
    """V[j] = a fresh random unit vector orthogonal to rows [0, j)."""
    Vh[j], Vl[j] = _random_unit(generator, Vh, Vl, j)


def split_f64(Q, dtype, device):
    """A host float64 matrix as a double-word pair of torch `dtype` on
    `device`: hi = round(Q), lo = round(Q - hi)."""
    word = torch.empty(0, dtype=dtype).numpy().dtype
    hi = np.asarray(Q, dtype=word)
    lo = np.asarray(Q - hi.astype(np.float64), dtype=word)
    return (torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device))
