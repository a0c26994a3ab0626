"""Tiny Sylvester solves for Schur reordering (host, f64).

Solves A @ X - X @ B = C for 1x1/2x2 diagonal blocks A, B of a
quasi-triangular matrix by recasting to a linear system of dimension <= 4,
solved by Gaussian elimination with complete pivoting.  An exactly-zero
pivot flags the system singular (eigenvalues of A and B indistinguishable),
in which case the caller skips the swap.

Behavioral reference: ArnoldiMethod.jl src/schursort.jl:61-202 (the
StaticArrays completely-pivoted LU and `sylv`).  Here the fixed-size system
is built with a Kronecker identity and solved with a direct elimination
loop — there is no LAPACK/BLAS involvement.
"""

from __future__ import annotations

import numpy as np

__all__ = ["solve_complete_pivot", "sylv"]


def solve_complete_pivot(M, b):
    """Solve M @ x = b (N <= 4) by complete-pivoting Gaussian elimination.

    Returns (x, singular).  `singular` is True iff an exactly-zero pivot is
    hit (ref: schursort.jl:113-119, 134-136); in that case x is garbage and
    must not be used.
    """
    M = np.array(M, copy=True)
    x = np.array(b, copy=True)
    N = M.shape[0]
    colperm = np.arange(N)
    singular = False

    for k in range(N - 1):
        # Locate the largest remaining entry.
        sub = np.abs(M[k:, k:])
        i, j = np.unravel_index(np.argmax(sub), sub.shape)
        i += k
        j += k

        # Bring it to the pivot position (row swap also permutes the rhs;
        # column swap is tracked to unpermute the solution).
        M[[k, i], k:] = M[[i, k], k:]
        x[k], x[i] = x[i], x[k]
        M[:, [k, j]] = M[:, [j, k]]
        colperm[k], colperm[j] = colperm[j], colperm[k]

        pivot = M[k, k]
        if pivot == 0:
            singular = True
            break

        M[k + 1 :, k] /= pivot
        M[k + 1 :, k + 1 :] -= np.outer(M[k + 1 :, k], M[k, k + 1 :])
        x[k + 1 :] -= M[k + 1 :, k] * x[k]

    if M[N - 1, N - 1] == 0:
        singular = True

    if not singular:
        # Back substitution, then undo the column permutation.
        for i in range(N - 1, -1, -1):
            x[i] -= M[i, i + 1 :] @ x[i + 1 :]
            x[i] /= M[i, i]
        out = np.empty_like(x)
        out[colperm] = x
        x = out

    return x, singular


def sylv(A, B, C):
    """Solve A @ X - X @ C-shaped B = C for X; A is (p,p), B is (q,q),
    C and X are (p,q) with p, q in {1, 2}.

    vec-column-stacking gives (I_q (x) A  -  B^T (x) I_p) vec(X) = vec(C)
    (ref: schursort.jl:170-202).  Returns (X, singular).
    """
    A = np.asarray(A)
    B = np.asarray(B)
    C = np.asarray(C)
    p = A.shape[0]
    q = B.shape[0]
    M = np.kron(np.eye(q, dtype=A.dtype), A) - np.kron(B.T, np.eye(p, dtype=A.dtype))
    x, singular = solve_complete_pivot(M, C.reshape(p * q, order="F"))
    return x.reshape((p, q), order="F"), singular
