"""Givens rotation micro-primitives for the replicated small-dense layer.

This is the L1 layer of the solver: numerically robust 2x2 plane rotations
and their ranged application to rows/columns of small (maxdim-sized) host
matrices.  Everything here runs on host in float64/complex128 — these
matrices are (maxdim+1) x maxdim with maxdim ~ 2*nev, so the cost is
irrelevant next to the device-side n-sized work, while float64 is exactly
what the shift computations need.

Behavioral reference: ArnoldiMethod.jl src/schurfact.jl:19-148 (Rotation2 /
Rotation3 and ranged lmul!/rmul!) and LinearAlgebra.givensAlgorithm (a pure
port of LAPACK dlartg).  This is a re-implementation from the mathematical
spec, vectorized over numpy slices.
"""

from __future__ import annotations

import numpy as np

from ..ops.dd import sqrt_

__all__ = [
    "givens",
    "lmul2",
    "rmul2",
    "lmul3",
    "rmul3",
    "rot2_matrix",
    "rot3_matrix",
]


def givens(f, g):
    """Compute a plane rotation (c, s, r) with c real such that

        [ c         s ] [ f ]   [ r ]
        [ -conj(s)  c ] [ g ] = [ 0 ]

    and c^2 + |s|^2 = 1.  Scaled to avoid overflow, works for real and
    complex inputs (ref: LAPACK dlartg / clartg semantics; used the same way
    as givensAlgorithm in schurfact.jl:57-69).
    """
    if g == 0:
        return 1.0, 0 * g, f
    if f == 0:
        ga = abs(g)
        return 0.0, np.conj(g) / ga, ga
    fa = abs(f)
    ga = abs(g)
    scale = max(fa, ga)
    fs = f / scale
    gs = g / scale
    d = sqrt_(abs(fs) ** 2 + abs(gs) ** 2)
    sgn_f = f / fa
    c = abs(fs) / d
    s = sgn_f * np.conj(gs) / d
    r = sgn_f * d * scale
    return c, s, r


# --- Ranged application helpers -------------------------------------------
#
# A Rotation2 (c, s) acts on rows (or columns) i, i+1.  A Rotation3
# (c1, s1, c2, s2) is the composition G2 * G1 where G1 acts on rows
# i+1, i+2 and G2 on rows i, i+1 — together they map a 3-vector to a
# multiple of e1 (ref: schurfact.jl:29-35, 65-69).
#
# All ranges are half-open 0-based column/row slices [j0, j1).


def lmul2(c, s, A, i, j0, j1):
    """A[i:i+2, j0:j1] = G @ A[i:i+2, j0:j1]."""
    if j0 >= j1:
        return
    a1 = A[i, j0:j1].copy()
    a2 = A[i + 1, j0:j1]
    A[i, j0:j1] = c * a1 + s * a2
    A[i + 1, j0:j1] = -np.conj(s) * a1 + c * a2


def rmul2(A, c, s, i, r0, r1):
    """A[r0:r1, i:i+2] = A[r0:r1, i:i+2] @ G^H."""
    if r0 >= r1:
        return
    a1 = A[r0:r1, i].copy()
    a2 = A[r0:r1, i + 1]
    A[r0:r1, i] = a1 * c + a2 * np.conj(s)
    A[r0:r1, i + 1] = -a1 * s + a2 * c


def lmul3(c1, s1, c2, s2, A, i, j0, j1):
    """Apply the 3-row rotation to rows i..i+2, columns [j0, j1)."""
    if j0 >= j1:
        return
    a1 = A[i, j0:j1].copy()
    a2 = A[i + 1, j0:j1].copy()
    a3 = A[i + 2, j0:j1]
    b2 = c1 * a2 + s1 * a3
    b3 = -np.conj(s1) * a2 + c1 * a3
    A[i, j0:j1] = c2 * a1 + s2 * b2
    A[i + 1, j0:j1] = -np.conj(s2) * a1 + c2 * b2
    A[i + 2, j0:j1] = b3


def rmul3(A, c1, s1, c2, s2, i, r0, r1):
    """Apply the 3-col rotation (adjoint) to columns i..i+2, rows [r0, r1)."""
    if r0 >= r1:
        return
    a1 = A[r0:r1, i].copy()
    a2 = A[r0:r1, i + 1].copy()
    a3 = A[r0:r1, i + 2]
    b2 = a2 * c1 + a3 * np.conj(s1)
    b3 = -a2 * s1 + a3 * c1
    A[r0:r1, i] = a1 * c2 + b2 * np.conj(s2)
    A[r0:r1, i + 1] = -a1 * s2 + b2 * c2
    A[r0:r1, i + 2] = b3


def rot2_matrix(c, s, i, n, dtype=None):
    """Materialize the Rotation2 as an n x n matrix (test oracle helper)."""
    if dtype is None:
        dtype = np.result_type(type(c), type(s), np.float64)
    G = np.eye(n, dtype=dtype)
    G[i, i] = c
    G[i, i + 1] = s
    G[i + 1, i] = -np.conj(s)
    G[i + 1, i + 1] = c
    return G


def rot3_matrix(c1, s1, c2, s2, i, n, dtype=None):
    """Materialize the Rotation3 (G2 @ G1) as an n x n matrix."""
    G1 = rot2_matrix(c1, s1, i + 1, n, dtype)
    G2 = rot2_matrix(c2, s2, i, n, dtype)
    return G2 @ G1
