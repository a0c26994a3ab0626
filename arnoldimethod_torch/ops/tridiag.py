"""Tridiagonal solver: pivoted LU on the host, log-depth solves in torch.

Shift-invert Arnoldi needs x = (A - sigma*I)^{-1} v once per Krylov step.
For tridiagonal A the factorization is O(n) host work done once (LAPACK
dgttrf-style partial pivoting), and each solve is two banded-triangular
substitutions.  Both substitutions are first-/second-order affine
recurrences, evaluated here by recursive doubling over the composition of
the affine maps: log2(n) rounds of elementwise tensor ops, never an
n-step loop.  The 2x2 compositions of the backward recurrence are written
as elementwise products and sums, so no matmul (and no TF32) touches them.

Behavioral reference: arnoldimethod_tpu/ops/tridiag.py.  `factor_tridiagonal`
and `TridiagFactorization` are its host code, unchanged; `tridiag_lu_solve`
computes what its `lax.associative_scan` version computes (the sums are
combined in another tree, so results agree to rounding).  The recurrences:

    t_{i+1} = a_i * t_i + c_i,   a_i = swap_i ? 1 : -l_i,
                                 c_i = swap_i ? -l_i*b_{i+1} : b_{i+1},
    y_i     = swap_i ? b_{i+1} : t_i

    x_i = (y_i - u1_i*x_{i+1} - u2_i*x_{i+2}) / d_i
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["factor_tridiagonal", "tridiag_lu_solve", "TridiagFactorization"]


class TridiagFactorization:
    """Host-computed P(A) = L U factors, padded to fixed length n:
    l (n: L subdiagonal, entry n-1 unused), swap (n bool, entry n-1 False),
    d0 (n: U diagonal), du1 (n: first superdiagonal, last entry 0),
    du2 (n: second superdiagonal, last two entries 0)."""

    def __init__(self, l, swap, d0, du1, du2):
        self.l = l
        self.swap = swap
        self.d0 = d0
        self.du1 = du1
        self.du2 = du2

    def astype(self, dtype):
        return TridiagFactorization(
            self.l.astype(dtype),
            self.swap,
            self.d0.astype(dtype),
            self.du1.astype(dtype),
            self.du2.astype(dtype),
        )

    def arrays(self):
        return self.l, self.swap, self.d0, self.du1, self.du2


def factor_tridiagonal(dl, d, du):
    """LU with partial pivoting of the tridiagonal (dl, d, du) — LAPACK
    dgttrf recurrence.  dl/du have length n-1, d length n.  Host numpy,
    float64/complex128 regardless of input dtype (the one-time O(n) cost
    is irrelevant; full-precision factors are then cast to the solve
    dtype).  Raises on an exactly singular pivot (sigma hit an
    eigenvalue)."""
    d = np.asarray(d)
    work = np.promote_types(d.dtype, np.float64)
    n = d.shape[0]
    if np.asarray(dl).shape[0] != n - 1 or np.asarray(du).shape[0] != n - 1:
        raise ValueError("dl/du must have length n-1")
    d0 = d.astype(work).copy()
    l = np.zeros(n, dtype=work)
    du1 = np.zeros(n, dtype=work)
    du1[: n - 1] = du
    du2 = np.zeros(n, dtype=work)
    sub = np.asarray(dl, dtype=work).copy()
    swap = np.zeros(n, dtype=bool)

    for i in range(n - 1):
        if abs(d0[i]) >= abs(sub[i]):
            if d0[i] == 0:
                raise np.linalg.LinAlgError(
                    f"exactly singular pivot at row {i}: the shift is an "
                    "eigenvalue of A (or A is singular)"
                )
            fact = sub[i] / d0[i]
            l[i] = fact
            d0[i + 1] = d0[i + 1] - fact * du1[i]
        else:
            swap[i] = True
            fact = d0[i] / sub[i]
            l[i] = fact
            d0[i] = sub[i]
            temp = du1[i]
            du1[i] = d0[i + 1]
            d0[i + 1] = temp - fact * d0[i + 1]
            if i < n - 2:
                du2[i] = du1[i + 1]
                du1[i + 1] = -fact * du1[i + 1]
    if d0[n - 1] == 0:
        raise np.linalg.LinAlgError(
            "exactly singular pivot at the last row: the shift is an "
            "eigenvalue of A (or A is singular)"
        )
    return TridiagFactorization(l, swap, d0, du1, du2)


def _prefix_affine1(a, c):
    """Inclusive prefix composition of the maps t -> a_i t + c_i (map 0
    applied first): returns (A_i, C_i) with t_{i+1} = A_i t_0 + C_i.
    Recursive doubling: round d composes each map with the prefix ending
    d places before it."""
    d = 1
    while d < a.shape[0]:
        c = torch.cat([c[:d], a[d:] * c[:-d] + c[d:]])
        a = torch.cat([a[:d], a[d:] * a[:-d]])
        d *= 2
    return a, c


def _mm2(A, B):
    """Batched 2x2 products A_i @ B_i as elementwise sums, (m, 2, 2)."""
    return (A[:, :, :, None] * B[:, None, :, :]).sum(dim=2)


def _mv2(A, g):
    """Batched 2x2 matrix-vector products A_i @ g_i, (m, 2)."""
    return (A * g[:, None, :]).sum(dim=2)


def _suffix_affine2(M, g):
    """Suffix composition of the maps v -> M_i v + g_i (the highest index
    applied first): returns (S_i, h_i), the map from v_{m} to v_i.
    Recursive doubling from the high end."""
    d = 1
    m = M.shape[0]
    while d < m:
        g = torch.cat([_mv2(M[:-d], g[d:]) + g[:-d], g[m - d:]])
        M = torch.cat([_mm2(M[:-d], M[d:]), M[m - d:]])
        d *= 2
    return M, g


def tridiag_lu_solve(l, swap, d0, du1, du2, b):
    """x = U^{-1} L^{-1} P b, both substitutions in log2(n) rounds."""
    n = b.shape[0]
    if n == 1:  # 1x1 system: no recurrences at all
        return b / d0

    # Forward: t_{i+1} = a_i t_i + c_i for i in [0, n-1), t_0 = b_0.
    bsh = torch.cat([b[1:], b[-1:]])  # b_{i+1}; last entry unused
    one = torch.ones((), dtype=b.dtype, device=b.device)
    a = torch.where(swap[:-1], one, -l[:-1])
    c = torch.where(swap[:-1], -l[:-1] * bsh[:-1], bsh[:-1])
    A, C = _prefix_affine1(a, c)
    t = torch.cat([b[:1], A * b[0] + C])
    y = torch.where(swap, bsh, t)

    # Backward: x_i = (y_i - du1_i x_{i+1} - du2_i x_{i+2}) / d0_i.
    # Base pair v_{n-2} = (x_{n-2}, x_{n-1}); elements i in [0, n-2) map
    # v_{i+1} -> v_i; the suffix compositions map the base to every v_i.
    yd = y / d0
    xn1 = yd[n - 1]
    xn2 = yd[n - 2] - (du1[n - 2] / d0[n - 2]) * xn1
    base = torch.stack([xn2, xn1])
    if n == 2:  # the base pair is the whole solution
        return base

    m = n - 2
    r1 = -du1[:m] / d0[:m]
    r2 = -du2[:m] / d0[:m]
    zero = torch.zeros_like(r1)
    M = torch.stack(
        [torch.stack([r1, r2], dim=-1),
         torch.stack([torch.ones_like(r1), zero], dim=-1)],
        dim=-2,
    )  # (m, 2, 2)
    g = torch.stack([yd[:m], zero], dim=-1)  # (m, 2)
    S, h = _suffix_affine2(M, g)
    head = (S * base[None, None, :]).sum(dim=2) + h  # v_i, i in [0, n-2)
    return torch.cat([head[:, 0], base])
