"""Restore the Hessenberg structure after Krylov-Schur truncation (host).

After the three-way partition, the Arnoldi residual term is a full row
h * e_m^T Q; this module zeroes the trailing entries of Q's last row with
Givens rotations (entries are residual norms of wildly different
magnitudes, so rotations beat one big Householder for stability — see
reference docs/src/index.md:395-399), absorbs the coupling into
H[hi, hi-1], and then restores the Hessenberg form of the now-dense active
block with a backward sweep of Householder reflectors applied from both
sides and accumulated into Q.

Behavioral reference: ArnoldiMethod.jl src/restore_hessenberg.jl:16-182.
"""

from __future__ import annotations

import numpy as np

from ..ops.dd import copysign_, hypot_, sqrt_
from .rotations import givens, lmul2, rmul2

__all__ = ["reflector", "restore_arnoldi"]


def reflector(y):
    """In-place Householder reflector mapping y to beta * e_k (k = len(y)).

    After the call y[:-1] holds v and y[-1] = beta, where
    P = I - tau [v; 1][v; 1]^H satisfies P @ y_original = beta e_k with
    1 <= Re(tau) <= 2.  Returns conj(tau); tau = 0 in the trivial case.
    Based on the LAPACK 3.8 clarfg recipe (ref: restore_hessenberg.jl:16-45).
    """
    k = y.shape[0]
    # No float() collapse: in double-double mode (ops/dd.py) the norm
    # must keep its low word — a rounded reflector would cap Q's
    # orthogonality at f64.
    xnrm2 = np.sum(np.abs(y[: k - 1]) ** 2)
    alpha = y[k - 1]

    if xnrm2 == 0 and alpha.imag == 0:
        return 0 * alpha

    beta = -copysign_(hypot_(abs(alpha), sqrt_(xnrm2)), alpha.real)
    tau = (beta - alpha) / beta
    y[: k - 1] *= 1 / (alpha - beta)
    y[k - 1] = beta
    return np.conj(tau)


def _refl_lmul(v, tau, offset, H, j0, j1):
    """Rows offset..offset+len(v) of H[:, j0:j1] <- P @ rows (P as above)."""
    if tau == 0 or j0 >= j1:
        return
    k = v.shape[0] + 1
    seg = H[offset : offset + k, j0:j1]
    d = v.conj() @ seg[:-1, :] + seg[-1, :]
    d = tau * d
    seg[:-1, :] -= np.outer(v, d)
    seg[-1, :] -= d


def _refl_rmul(H, v, tau, offset, r0, r1):
    """Columns offset..offset+len(v) of H[r0:r1, :] <- cols @ P^H."""
    if tau == 0 or r0 >= r1:
        return
    k = v.shape[0] + 1
    seg = H[r0:r1, offset : offset + k]
    d = seg[:, :-1] @ v + seg[:, -1]
    d = np.conj(tau) * d
    seg[:, :-1] -= np.outer(d, v.conj())
    seg[:, -1] -= d


def restore_arnoldi(H, lo, hi, Q):
    """Restore the Arnoldi/Hessenberg structure of the active window
    [lo, hi) (0-based, half-open) of the workspace H ((maxdim+1) x maxdim)
    after truncation, updating Q (maxdim x maxdim) accordingly.

    Ref: restore_hessenberg.jl:75-134 (called as restore_arnoldi!(H,
    nlock+1, k, Q, G) from run.jl:360 — here lo = nlock, hi = k).
    """
    if lo >= hi - 1:
        # Active window of <= 1 column: the driver is about to terminate
        # (k can only shrink to nlock+1 once nlock >= nev), so the residual
        # coupling is never read again.  Mirror the reference's early exit
        # (restore_hessenberg.jl:82).
        return

    m, n = H.shape
    last = Q.shape[0] - 1

    # Pass 1: Givens rotations zeroing Q[last, lo:hi-1] left-to-right,
    # applied as a similarity to H and accumulated into Q.
    nrm = Q[last, lo]
    for i in range(lo, hi - 1):
        c, s, nrm = givens(Q[last, i + 1], nrm)
        # The reference uses Rotation2(c, -s, i) here.
        rmul2(H, c, -s, i, 0, min(i + 3, hi))
        lmul2(c, -s, H, i, 0, hi)
        rmul2(Q, c, -s, i, 0, Q.shape[0])

    # Absorb the residual coupling: we want the trailing term of the
    # truncated relation to be h * v_{hi} * e_{hi-1}^T.
    H[hi, hi - 1] = Q[last, hi - 1] * H[m - 1, n - 1]

    # Pass 2: backward sweep of Householder reflectors turning the dense
    # block H[lo:hi, lo:hi] back into Hessenberg form.
    for length in range(hi - 1 - lo, 1, -1):
        row = lo + length

        # Reflector built from (the conjugate of) the leading row segment.
        y = np.conj(H[row, lo : lo + length]).copy()
        tau = reflector(y)
        v = y[:-1]

        _refl_rmul(H, v, tau, lo, 0, row)
        H[row, lo : lo + length - 1] = 0
        H[row, lo + length - 1] = np.conj(y[-1])
        _refl_lmul(v, tau, lo, H, lo, hi)
        _refl_rmul(Q, v, tau, lo, 0, Q.shape[0])
