"""LAPACK-free Schur factorization of small Hessenberg matrices (host, f64).

Implements the Francis implicitly-shifted QR iteration on an active window
of an upper Hessenberg matrix, accumulating the orthogonal similarity into
Q.  Real matrices get the quasi-Schur form (2x2 blocks for conjugate pairs,
single Wilkinson shift with a stabilized rotation for real pairs, double
shift with a 3x3 bulge chase for complex pairs); complex matrices use the
single Wilkinson shift throughout.

Behavioral reference: ArnoldiMethod.jl src/schurfact.jl:150-545.  The two
stabilizations `upper_triangular_2x2` (dlanv2-style scaling,
schurfact.jl:327-357) and `use_single_shift` (schurfact.jl:363-388) encode
hard-won regressions (test/schurfact.jl:123-158) and are carried over as
specifications.
"""

from __future__ import annotations

import numpy as np

from ..ops.dd import copysign_, hypot_, sign_, sqrt_
from .rotations import givens, lmul2, lmul3, rmul2, rmul3

__all__ = [
    "is_offdiagonal_small",
    "upper_triangular_2x2",
    "use_single_shift",
    "single_shift_qr",
    "double_shift_qr",
    "local_schur",
]


def is_offdiagonal_small(H, i, tol=None):
    """Deflation test for subdiagonal entry H[i+1, i] (schurfact.jl:7-11)."""
    if tol is None:
        tol = np.finfo(np.asarray(H).real.dtype).eps
    return abs(H[i + 1, i]) <= tol * (abs(H[i, i]) + abs(H[i + 1, i + 1]))


def upper_triangular_2x2(h11, h12, h21, h22):
    """Analyze the real 2x2 block [[h11, h12], [h21, h22]].

    Returns (is_real, c, s).  If the block has real eigenvalues, (c, s) is
    the most stable Givens rotation such that G @ H @ G.T is upper
    triangular.  Scaling follows LAPACK dlanv2 so that nearly-repeated
    eigenvalues do not lose the discriminant to cancellation
    (ref: schurfact.jl:327-357).
    """
    if h21 == 0 or (h11 == h22 and sign_(h12) != sign_(h21)):
        return False, 1.0, 0.0
    if h12 == 0:
        return True, 0.0, 1.0

    # Discriminant of the characteristic polynomial, computed scaled:
    # ((h11 - h22)/2)^2 + h12*h21 < 0  <=>  conjugate pair.
    p = (h11 - h22) / 2
    bcmax = max(abs(h12), abs(h21))
    bcmis = min(abs(h12), abs(h21)) * sign_(h12) * sign_(h21)
    scale = max(abs(p), bcmax)
    z = (p / scale) * p + (bcmax / scale) * bcmis
    if z < 0:
        return False, 1.0, 0.0

    # Perfect Wilkinson shift: pick the root that avoids cancellation.
    h11_minus_lam = p + copysign_(sqrt_(scale) * sqrt_(z), p)
    nrm = hypot_(h21, h11_minus_lam)
    return True, h11_minus_lam / nrm, h21 / nrm


def use_single_shift(h11, h12, h21, h22):
    """Decide single vs double shift from the trailing real 2x2 block.

    Returns (is_single, mu): is_single is True iff the block has real
    eigenvalues; then mu is the Wilkinson shift (eigenvalue closest to h22).
    The block is pre-scaled by its 1-norm so nearly-repeated eigenvalues
    keep their tiny discriminant (ref: schurfact.jl:363-388).
    """
    scale = abs(h11) + abs(h12) + abs(h21) + abs(h22)
    a11, a12 = h11 / scale, h12 / scale
    a21, a22 = h21 / scale, h22 / scale

    t = (a11 + a22) / 2
    d = (a11 - t) * (a22 - t) - a12 * a21
    if d > 0:
        return False, 0.0

    sqrt_discr = sqrt_(abs(d))
    lam1 = t + sqrt_discr
    lam2 = t - sqrt_discr
    lam = lam1 if abs(a22 - lam1) < abs(a22 - lam2) else lam2
    return True, lam * scale


def _rot3(p1, p2, p3):
    """Rotation mapping [p1, p2, p3] to a multiple of e1 (schurfact.jl:65-69)."""
    c1, s1, nrm1 = givens(p2, p3)
    c2, s2, nrm2 = givens(p1, nrm1)
    return c1, s1, c2, s2, nrm2


def single_shift_qr(H, frm, to, mu, Q=None):
    """One single-shift bulge chase on diagonal window frm..to (inclusive,
    0-based) of Hessenberg H, full-width coupling updates, Q accumulation.

    Ref: schurfact.jl:251-320.
    """
    m, n = H.shape

    c, s, _ = givens(H[frm, frm] - mu, H[frm + 1, frm])
    lmul2(c, s, H, frm, frm, n)
    rmul2(H, c, s, frm, 0, min(frm + 3, m))
    if Q is not None:
        rmul2(Q, c, s, frm, 0, Q.shape[0])

    for i in range(frm + 1, to):
        c, s, nrm = givens(H[i, i - 1], H[i + 1, i - 1])
        H[i, i - 1] = nrm
        H[i + 1, i - 1] = 0
        lmul2(c, s, H, i, i, n)
        rmul2(H, c, s, i, 0, min(i + 3, m))
        if Q is not None:
            rmul2(Q, c, s, i, 0, Q.shape[0])
    return H


def double_shift_qr(H, frm, to, trace, det, Q=None):
    """Francis double-shift bulge chase on window frm..to (inclusive,
    0-based): implicit shifts are the conjugate eigenvalue pair with the
    given trace and determinant.  Ref: schurfact.jl:150-249.
    """
    m, n = H.shape

    # First column of (H - mu+ I)(H - mu- I) e1 = (H^2 - tr*H + det*I) e1;
    # only three entries are nonzero thanks to the Hessenberg structure.
    h11 = H[frm, frm]
    h21 = H[frm + 1, frm]
    h12 = H[frm, frm + 1]
    h22 = H[frm + 1, frm + 1]
    h32 = H[frm + 2, frm + 1]
    p1 = h11 * h11 + h12 * h21 - trace * h11 + det
    p2 = h21 * (h11 + h22 - trace)
    p3 = h32 * h21

    c1, s1, c2, s2, _ = _rot3(p1, p2, p3)
    lmul3(c1, s1, c2, s2, H, frm, frm, n)
    rmul3(H, c1, s1, c2, s2, frm, 0, min(frm + 4, m))
    if Q is not None:
        rmul3(Q, c1, s1, c2, s2, frm, 0, Q.shape[0])

    # Chase the 3x3 bulge down the diagonal.
    for i in range(frm + 1, to - 1):
        c1, s1, c2, s2, nrm = _rot3(H[i, i - 1], H[i + 1, i - 1], H[i + 2, i - 1])
        H[i, i - 1] = nrm
        H[i + 1, i - 1] = 0
        H[i + 2, i - 1] = 0
        lmul3(c1, s1, c2, s2, H, i, i, n)
        rmul3(H, c1, s1, c2, s2, i, 0, min(i + 4, m))
        if Q is not None:
            rmul3(Q, c1, s1, c2, s2, i, 0, Q.shape[0])

    # Final 2-row bulge is a single rotation.
    c, s, nrm = givens(H[to - 1, to - 2], H[to, to - 2])
    H[to - 1, to - 2] = nrm
    H[to, to - 2] = 0
    lmul2(c, s, H, to - 1, to - 1, n)
    rmul2(H, c, s, to - 1, 0, min(to + 1, m))
    if Q is not None:
        rmul2(Q, c, s, to - 1, 0, Q.shape[0])
    return H


def local_schur(H, lo, hi, Q=None, tol=None, maxiter=None):
    """In-place (quasi-)Schur factorization of H[lo:hi, lo:hi].

    H is an upper Hessenberg numpy matrix (may be a square view of the
    (maxdim+1) x maxdim workspace array); rotations are applied across the
    full width/height so similarity of the enclosing matrix is preserved,
    and accumulated into Q (if given).  Indices are 0-based, the window is
    the half-open diagonal range [lo, hi).

    Real dtype: quasi-Schur form, conjugate pairs stay as 2x2 blocks
    (ref: schurfact.jl:393-487, raises on non-convergence).  Complex dtype:
    triangular Schur form by single Wilkinson shifts (schurfact.jl:492-538,
    returns False on non-convergence).
    """
    if tol is None:
        tol = np.finfo(np.asarray(H).real.dtype).eps
    if maxiter is None:
        maxiter = 100 * H.shape[0]

    if np.iscomplexobj(H):
        return _local_schur_complex(H, lo, hi, Q, tol, maxiter)
    return _local_schur_real(H, lo, hi, Q, tol, maxiter)


def _local_schur_real(H, lo, hi, Q, tol, maxiter):
    n = H.shape[1]
    to = hi - 1
    it = 0

    while to > lo:
        it += 1
        if it > maxiter:
            raise RuntimeError("QR algorithm did not converge")

        # Deflation scan: frm becomes the start of the trailing unreduced
        # block ending at `to`; small subdiagonals are flushed to zero.
        frm = to
        while frm > lo:
            if is_offdiagonal_small(H, frm - 1, tol):
                H[frm, frm - 1] = 0
                break
            frm -= 1

        if frm == to:
            # Bottom 1x1 block deflated.
            to -= 1
            continue

        c11, c12 = H[to - 1, to - 1], H[to - 1, to]
        c21, c22 = H[to, to - 1], H[to, to]

        if frm + 1 == to:
            # A trailing 2x2 block: real eigenvalues are triangularized with
            # the stabilized "perfect shift" rotation; conjugate pairs stay.
            is_real, c, s = upper_triangular_2x2(c11, c12, c21, c22)
            if is_real:
                lmul2(c, s, H, frm, frm, n)
                rmul2(H, c, s, frm, 0, to + 1)
                if Q is not None:
                    rmul2(Q, c, s, frm, 0, Q.shape[0])
                H[to, to - 1] = 0
            to -= 2
            continue

        is_single, mu = use_single_shift(c11, c12, c21, c22)
        if is_single:
            single_shift_qr(H, frm, to, mu, Q)
        else:
            double_shift_qr(H, frm, to, c11 + c22, c11 * c22 - c12 * c21, Q)

    return True


def _local_schur_complex(H, lo, hi, Q, tol, maxiter):
    to = hi - 1
    it = 0

    while True:
        it += 1
        if it > maxiter:
            return False

        frm = to
        while frm > lo and not is_offdiagonal_small(H, frm - 1, tol):
            frm -= 1

        if frm == to:
            if frm > 0:
                H[frm, frm - 1] = 0
            to -= 1
        else:
            # Wilkinson shift from the trailing 2x2 block.
            h11, h12 = H[to - 1, to - 1], H[to - 1, to]
            h21, h22 = H[to, to - 1], H[to, to]
            d = h11 * h22 - h21 * h12
            t = h11 + h22
            sq = np.sqrt(complex(t * t - 4 * d))
            lam1 = (t + sq) / 2
            lam2 = (t - sq) / 2
            lam = lam1 if abs(h22 - lam1) < abs(h22 - lam2) else lam2
            single_shift_qr(H, frm, to, lam, Q)

        if to <= lo:
            break

    return True
