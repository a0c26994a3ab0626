"""Direct swapping of adjacent diagonal blocks of a (quasi-)Schur form.

Bai–Demmel style: to exchange adjacent 1x1/2x2 blocks A (at i) and B, solve
the tiny Sylvester equation A X - X B = C and build Givens rotations that
upper-triangularize [-X; I]; applying them as a similarity exchanges the
blocks.  A singular Sylvester system (indistinguishable eigenvalues) makes
the swap a silent no-op.

Behavioral reference: ArnoldiMethod.jl src/schursort.jl:205-506.
All indices 0-based; R may be a square view of the workspace H and the
rotations are applied full-width so similarity of the enclosing matrix and
the accumulated Q are maintained.
"""

from __future__ import annotations

import numpy as np

from .rotations import givens, lmul2, lmul3, rmul2, rmul3
from .sylvester import sylv

__all__ = [
    "is_start_of_11_block",
    "is_end_of_11_block",
    "swap11",
    "swap12",
    "swap21",
    "swap22",
    "swap",
    "rotate_right",
    "rotate_left",
]


def is_start_of_11_block(R, i):
    """True iff diagonal index i starts a 1x1 block (schursort.jl:505)."""
    return i == R.shape[1] - 1 or R[i + 1, i] == 0


def is_end_of_11_block(R, i):
    """True iff diagonal index i ends a 1x1 block (schursort.jl:506)."""
    return i == 0 or R[i, i - 1] == 0


def _one(R):
    return np.asarray(R).dtype.type(1)


def swap22(R, i, Q=None):
    """Exchange the 2x2 blocks at diagonal positions i and i+2
    (ref: schursort.jl:222-238, 307-346)."""
    m, n = R.shape
    A = R[i : i + 2, i : i + 2].copy()
    B = R[i + 2 : i + 4, i + 2 : i + 4].copy()
    C = R[i : i + 2, i + 2 : i + 4].copy()

    X, singular = sylv(A, B, C)
    if singular:
        return R

    one = _one(R)
    # Two 3-row rotations triangularizing [-X; I] (4 x 2).
    c1, s1, n1 = givens(-X[1, 0], one)
    c2, s2, _ = givens(-X[0, 0], n1)
    x22 = c1 * -X[1, 1]
    x32 = -np.conj(s1) * -X[1, 1]
    x22 = -np.conj(s2) * -X[0, 1] + c2 * x22
    c3, s3, n3 = givens(x32, one)
    c4, s4, _ = givens(x22, n3)

    lmul3(c1, s1, c2, s2, R, i, i, n)
    rmul3(R, c1, s1, c2, s2, i, 0, i + 4)
    lmul3(c3, s3, c4, s4, R, i + 1, i, n)
    rmul3(R, c3, s3, c4, s4, i + 1, 0, i + 4)

    R[i + 2, i] = 0
    R[i + 3, i] = 0
    R[i + 2, i + 1] = 0
    R[i + 3, i + 1] = 0

    if Q is not None:
        rmul3(Q, c1, s1, c2, s2, i, 0, Q.shape[0])
        rmul3(Q, c3, s3, c4, s4, i + 1, 0, Q.shape[0])
    return R


def swap21(R, i, Q=None):
    """Exchange the 2x2 block at i with the 1x1 block at i+2
    (ref: schursort.jl:287-291, 361-394)."""
    m, n = R.shape
    A = R[i : i + 2, i : i + 2].copy()
    B = R[i + 2 : i + 3, i + 2 : i + 3].copy()
    C = R[i : i + 2, i + 2 : i + 3].copy()

    X, singular = sylv(A, B, C)
    if singular:
        return R

    one = _one(R)
    c1, s1, n1 = givens(-X[1, 0], one)
    c2, s2, _ = givens(-X[0, 0], n1)

    lmul3(c1, s1, c2, s2, R, i, i, n)
    rmul3(R, c1, s1, c2, s2, i, 0, i + 3)

    R[i + 1, i] = 0
    R[i + 2, i] = 0

    if Q is not None:
        rmul3(Q, c1, s1, c2, s2, i, 0, Q.shape[0])
    return R


def swap12(R, i, Q=None):
    """Exchange the 1x1 block at i with the 2x2 block at i+1
    (ref: schursort.jl:256-268, 412-449)."""
    m, n = R.shape
    A = R[i : i + 1, i : i + 1].copy()
    B = R[i + 1 : i + 3, i + 1 : i + 3].copy()
    C = R[i : i + 1, i + 1 : i + 3].copy()

    X, singular = sylv(A, B, C)
    if singular:
        return R

    one = _one(R)
    c1, s1, _ = givens(-X[0, 0], one)
    x22 = -np.conj(s1) * -X[0, 1]
    c2, s2, _ = givens(x22, one)

    lmul2(c1, s1, R, i, i, n)
    rmul2(R, c1, s1, i, 0, i + 3)
    lmul2(c2, s2, R, i + 1, i, n)
    rmul2(R, c2, s2, i + 1, 0, i + 3)

    R[i + 2, i] = 0
    R[i + 2, i + 1] = 0

    if Q is not None:
        rmul2(Q, c1, s1, i, 0, Q.shape[0])
        rmul2(Q, c2, s2, i + 1, 0, Q.shape[0])
    return R


def swap11(R, i, Q=None):
    """Exchange adjacent 1x1 blocks at i and i+1; the Sylvester solution
    collapses to a single closed-form rotation (ref: schursort.jl:460-482)."""
    m, n = R.shape
    r11 = R[i, i]
    r12 = R[i, i + 1]
    r22 = R[i + 1, i + 1]

    c, s, _ = givens(r12, r22 - r11)

    # The 2x2 window itself maps to diag(r22, r11) exactly, so skip it.
    lmul2(c, s, R, i, i + 2, n)
    rmul2(R, c, s, i, 0, i)
    R[i, i] = r22
    R[i + 1, i + 1] = r11

    if Q is not None:
        rmul2(Q, c, s, i, 0, Q.shape[0])
    return R


def swap(R, i, curr_is_11, next_is_11, Q=None):
    """Swap the two consecutive blocks starting at index i
    (ref: schursort.jl:489-503)."""
    if curr_is_11:
        if next_is_11:
            swap11(R, i, Q)
        else:
            swap12(R, i, Q)
    else:
        if next_is_11:
            swap21(R, i, Q)
        else:
            swap22(R, i, Q)


def rotate_right(R, frm, to, Q=None):
    """Cyclic shift: eigenvalue block at `to` moves to `frm`, blocks in
    between shift one position down.  `frm`/`to` must point at block starts
    (ref: schursort.jl:19-32)."""
    i = to
    while i > frm:
        curr_11 = is_start_of_11_block(R, i)
        prev_11 = is_end_of_11_block(R, i - 1)
        j = i - 1 if prev_11 else i - 2
        swap(R, j, prev_11, curr_11, Q)
        i = j


def rotate_left(R, frm, to, Q=None):
    """Cyclic shift the other way: block at `frm` moves to `to`
    (ref: schursort.jl:44-59)."""
    i = frm
    while True:
        curr_11 = is_start_of_11_block(R, i)
        j = i + 1 if curr_11 else i + 2
        if j > to:
            break
        next_11 = is_start_of_11_block(R, j)
        swap(R, i, curr_11, next_11, Q)
        i = i + 1 if next_11 else i + 2
