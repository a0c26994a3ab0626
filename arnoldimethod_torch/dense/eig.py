"""Eigenvalues and eigenvectors of small (quasi-)upper-triangular matrices.

Eigenvalues are read off the 1x1/2x2 diagonal blocks; eigenvectors come
from shifted backward substitution that treats 2x2 blocks with direct 2x2
solves and an exactly-singular pivot by setting the component to zero
(exercised by the zero-matrix integration test).  This module is what lets
the driver judge convergence without touching the n-sized basis V, and what
makes `partial_eigen` LAPACK-free (unlike the reference, which calls
LAPACK's `eigen` there — eigvals.jl:92-95).

Behavioral reference: ArnoldiMethod.jl src/eigvals.jl and
src/eigenvector_uppertriangular.jl.
"""

from __future__ import annotations

import numpy as np

from .schur import is_offdiagonal_small

__all__ = [
    "copy_eigenvalues",
    "eigenvalue",
    "eigenvalues",
    "shifted_backward_sub",
    "collect_eigen",
]


def copy_eigenvalues(lams, R, lo=0, hi=None, tol=None):
    """Fill lams[lo:hi] with the eigenvalues of quasi-triangular R read off
    its diagonal blocks (ref: eigvals.jl:6-34).  lams is complex."""
    if hi is None:
        hi = R.shape[1]
    if tol is None:
        tol = np.finfo(np.asarray(R).real.dtype).eps

    i = lo
    while i < hi - 1:
        if is_offdiagonal_small(R, i, tol):
            lams[i] = R[i, i]
            i += 1
        else:
            d = R[i, i] * R[i + 1, i + 1] - R[i, i + 1] * R[i + 1, i]
            x = (R[i, i] + R[i + 1, i + 1]) / 2
            y = np.sqrt(complex(x * x - d))
            lams[i] = x + y
            lams[i + 1] = x - y
            i += 2
    if i == hi - 1:
        lams[i] = R[i, i]
    return lams


def eigenvalue(R, i):
    """Eigenvalue of the block starting at diagonal index i (0-based);
    for a 2x2 block the root with positive imaginary part is returned
    (ref: eigvals.jl:42-55)."""
    n = min(R.shape)
    if i == n - 1 or R[i + 1, i] == 0:
        return complex(R[i, i])
    d = R[i, i] * R[i + 1, i + 1] - R[i, i + 1] * R[i + 1, i]
    x = (R[i, i] + R[i + 1, i + 1]) / 2
    y = np.sqrt(complex(x * x - d))
    return complex(x + y)


def eigenvalues(R, tol=None):
    """All eigenvalues of quasi-triangular R, always complex-typed."""
    lams = np.empty(R.shape[1], dtype=complex)
    return copy_eigenvalues(lams, R, 0, R.shape[1], tol)


def shifted_backward_sub(x, R, lam, k):
    """Solve (R[:k, :k] - lam*I) y = x[:k] in place of x (0-based count k).

    For real R the quasi-triangular 2x2 blocks are solved directly; an
    exactly-zero pivot sets the component to zero instead of dividing
    (ref: eigenvector_uppertriangular.jl:6-68).
    """
    real_R = not np.iscomplexobj(R)
    while k > 0:
        if real_R and k > 1 and R[k - 1, k - 2] != 0:
            # 2x2 block spanning k-2, k-1.
            r11 = R[k - 2, k - 2] - lam
            r12 = R[k - 2, k - 1]
            r21 = R[k - 1, k - 2]
            r22 = R[k - 1, k - 1] - lam
            det = r11 * r22 - r21 * r12
            # det == 0 cannot happen for a genuine conjugate-pair block.
            a1 = (r22 * x[k - 2] - r12 * x[k - 1]) / det
            a2 = (-r21 * x[k - 2] + r11 * x[k - 1]) / det
            x[k - 2] = a1
            x[k - 1] = a2
            x[: k - 2] -= R[: k - 2, k - 2] * a1 + R[: k - 2, k - 1] * a2
            k -= 2
        else:
            sigma = R[k - 1, k - 1] - lam
            if sigma == 0:
                x[k - 1] = 0
            else:
                x[k - 1] /= sigma
                x[: k - 1] -= R[: k - 1, k - 1] * x[k - 1]
            k -= 1
    return x


def collect_eigen(x, R, j):
    """Store the unit-norm eigenvector of (quasi-)triangular R associated
    with the block containing diagonal index j into x[:k]; returns k, the
    number of valid leading entries (0-based: the vector spans rows 0..k-1,
    x[k:] is untouched).  x must be a complex buffer.

    For a real R with a conjugate 2x2 block at (j, j+1), j is bumped to the
    second column of the block and the eigenvector of the eigenvalue with
    positive imaginary part is produced (ref:
    eigenvector_uppertriangular.jl:76-154).
    """
    n = R.shape[1]
    real_R = not np.iscomplexobj(R)

    if real_R and j < n - 1 and R[j + 1, j] != 0:
        j += 1

    if real_R and j > 0 and R[j, j - 1] != 0:
        # Second column of a conjugate-pair block: complex eigenvalue.
        r11, r21 = R[j - 1, j - 1], R[j, j - 1]
        r12, r22 = R[j - 1, j], R[j, j]
        det = r11 * r22 - r21 * r12
        tr = r11 + r22
        lam = (tr + np.sqrt(complex(tr * tr - 4 * det))) / 2
        x[j - 1] = -r12 / (r11 - lam)
        x[j] = 1
        x[: j - 1] = -R[: j - 1, j - 1] * x[j - 1] - R[: j - 1, j]
        shifted_backward_sub(x, R, lam, j - 1)
    else:
        lam = R[j, j]
        x[j] = 1
        x[:j] = -R[:j, j]
        shifted_backward_sub(x, R, lam, j)

    k = j + 1
    nrm = np.sqrt(np.sum(np.abs(x[:k]) ** 2))
    x[:k] *= 1 / nrm
    return k
