"""Arnoldi expansion: the n-sized device work of the solver.

Per Krylov step: one matvec, then classical Gram-Schmidt with DGKS
re-orthogonalization (eta = sqrt(2)/2, the ARPACK constant).  The basis V is
a (maxdim+1, n) tensor with the vectors as rows; the projection
coefficients are one GEMV against the filled rows V[:j+1].  Everything
updates V and the device Hessenberg H in place.

The two data-dependent decisions of a step, whether to run the second
Gram-Schmidt pass and whether the new vector broke down, are Python
branches on values read back from the device: one host sync per step, two
when the second pass runs.  Each function that expands returns the number
of syncs it made, so a caller can count them.

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

import torch

__all__ = [
    "ETA",
    "apply_basis_change",
    "expand_range",
    "fp32_matmul",
    "orthonormalize_rows",
    "set_initial_vector",
    "set_random_vector",
    "truncate_and_expand",
]

ETA = 0.7071067811865476  # sqrt(2)/2, the ARPACK DGKS constant


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


def _norm(w):
    return torch.sqrt(torch.real(torch.vdot(w, w)))


def _project(B, w):
    """h = B^H w and the projection update w - B^T h over the rows of B."""
    h = torch.mv(B.conj(), w)
    return h, w - torch.mv(B.T, h)


def _dgks_orthogonalize(B, w):
    """Two-stage DGKS against the rows of B.  Returns (w, h, breakdown,
    wnorm, syncs): breakdown iff the final norm <= ETA * the norm before
    the last pass (ref: expansion.jl:69-109)."""
    rnorm = _norm(w)
    h, w = _project(B, w)
    wnorm = _norm(w)
    r, wn = torch.stack((rnorm, wnorm)).tolist()
    if wn < ETA * r:
        c, w = _project(B, w)
        h = h + c
        wnorm2 = _norm(w)
        wn2 = wnorm2.item()
        return w, h, wn2 <= ETA * wn, wnorm2, 2
    return w, h, wn <= ETA * r, wnorm, 1


def _random_unit_vector(generator, n, dtype, device, B):
    """Fresh random vector orthonormalized against the rows of B
    (ref: reinitialize!, expansion.jl:12-59)."""
    v = torch.randn(n, dtype=dtype, device=device, generator=generator)
    _, v = _project(B, v)
    _, v = _project(B, v)
    return v / _norm(v)


def expand_range(op, V, H, j0, j1, generator):
    """Extend the Arnoldi relation A V[:j].T = V[:j+1].T H[:j+1, :j] by
    computing basis rows j0+1 .. j1 and H columns j0 .. j1-1, in place.

    V: (maxdim+1, n) basis rows; H: (maxdim+1, maxdim) device Hessenberg
    (only columns [j0, j1) are written; the caller owns the authoritative
    host copy of older columns).  `generator` draws the random vectors of
    the breakdown path.  Returns the number of host syncs made."""
    n = V.shape[1]
    syncs = 0
    for j in range(j0, j1):
        w = op.matvec(V[j])
        B = V[: j + 1]
        w, h, breakdown, wnorm, s = _dgks_orthogonalize(B, w)
        syncs += s
        H[:, j] = 0
        H[: j + 1, j] = h
        if not breakdown:
            H[j + 1, j] = wnorm
            V[j + 1] = w / wnorm
        elif j + 1 < n:
            # H[j+1, j] stays zero: deflation.
            V[j + 1] = _random_unit_vector(generator, n, V.dtype, V.device, B)
        else:
            # The basis already spans the whole space (expansion.jl:127).
            V[j + 1] = w
    return syncs


def apply_basis_change(V, Qbig):
    """V <- Qbig^T @ V in place: one (m+1, m+1) x (m+1, n) GEMM implements
    the Krylov-Schur truncation / final reordering of the basis
    (ref: run.jl:363-365, 382-383).  The product goes to a temporary and is
    copied back, so V keeps its storage."""
    V.copy_(torch.matmul(Qbig.T, V))
    return V


def truncate_and_expand(op, V, H, Qbig, j0, j1, generator):
    """One restart's device step: the truncation basis change, then the
    expansion from j0 back to j1.  Returns the number of host syncs."""
    apply_basis_change(V, Qbig)
    return expand_range(op, V, H, j0, j1, generator)


def set_initial_vector(V, v):
    """V[0] = v / ||v||; v is not mutated and need not be normalized
    (ref: run.jl:38, reinitialize! with j == 0)."""
    v = v.to(dtype=V.dtype, device=V.device)
    V[0] = v / _norm(v)
    return V


def set_random_vector(V, j, generator):
    """V[j] = fresh random unit vector orthogonal to rows [0, j), the
    warm-start reinitialization (partialschur! with initialize=true)."""
    V[j] = _random_unit_vector(generator, V.shape[1], V.dtype, V.device, V[:j])
    return V


def orthonormalize_rows(X, generator):
    """Orthonormalize the rows of X (k, n) in place with CGS2/DGKS.  Rows
    that fall in the span of earlier rows (breakdown) are replaced with
    fresh random orthonormal directions, so the result always has full row
    rank."""
    k, n = X.shape
    for j in range(k):
        B = X[:j]
        w, _, breakdown, wnorm, _ = _dgks_orthogonalize(B, X[j])
        if breakdown:
            X[j] = _random_unit_vector(generator, n, X.dtype, X.device, B)
        else:
            X[j] = w / wnorm
    return X
