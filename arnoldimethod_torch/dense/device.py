"""The dense restart of `method="device"` in the working dtype: the plain
version of every step, and the CUDA kernels that run the whole restart on
the card.

Counterpart of the JAX package's `arnoldimethod_tpu/dense/device.py` (its
`*_jax` functions, named here without the suffix) and of the dense phase of
its fused restart loop (`arnoldimethod_tpu/fused.py:109-202` and
`_fused_finish`, :221-232).  Unlike the host dense layer (float64 numpy or
the C++ core), everything here runs in the working dtype, float32 or
float64, with JAX's fixed shapes: H is (m+1, m) and Q is (m, m).  Real
dtypes only: conjugate pairs are split into (re, +im) and (re, -im),
written from one computation.

The plain version is Python control flow where JAX has `lax.while_loop`,
`cond` and `switch`, on CPU tensors, updated in place (each function also
returns what it updated).  Row and column updates are torch operations;
the scalar decisions (rotations, shifts, deflation, Sylvester solves) are
made on numpy scalars of the working dtype read through the tensors' CPU
view: the same IEEE operations as torch's, without the cost of a torch
call per scalar.  Two choices make the kernel's arithmetic repeat the
plain version's exactly:
- every sum is the fixed pairwise tree of `tree_sum` (zero-padded to a
  power of two, then x[:h] + x[h:] until one entry is left);
- hypot is JAX's formula, hi * sqrt(1 + (lo / hi)^2) with hi = max(|x|,
  |y|), in `_hypot` and `_hypot_t` and in the kernel;
- square roots are correctly rounded (numpy's, `_sqrt_t`, where a tensor
  needs one: torch.sqrt's CPU vector path is not in every build).
JAX's order of operations is kept wherever a decision depends on it: the
deflation test sub <= eps * (|d_i| + |d_i+1|), the shift choice and the
masked sums of `restore_arnoldi`'s Householder pass.

`restart_plain` and `finish_plain` are the two dense phases of the fused
loop as whole functions.  `restart` and `finish` dispatch them: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel of
`csrc/dense_restart.cu` (built with nvcc at first use) or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._build import PACKAGE_DIR, build_shared, nvcc_command

__all__ = [
    "KERNEL",
    "ORDER_CODES",
    "PLAIN_OPS",
    "STATE",
    "block_starts",
    "eigenvalues",
    "finish",
    "finish_plain",
    "givens",
    "local_schur",
    "new_state",
    "order_key",
    "partition_three_way",
    "residuals",
    "restart",
    "restart_plain",
    "restore_arnoldi",
    "rotate_right",
    "sort_schur",
    "swap",
    "tree_sum",
]

# Codes of the targets, shared with the kernel.
ORDER_CODES = {"LM": 0, "LR": 1, "SR": 2, "LI": 3, "SI": 4}

# Slots of the int32 loop state that the restart kernel reads and writes
# (fused.py's loop-carried scalars, plus the truncation size and the
# rollback row).
STATE = dict(active=0, prods=1, it=2, purges=3, done=4, qr_ok=5, k=6,
             rollback=7)
STATE_LEN = 8


class _OpCount:
    """Lane operations of the plain version's row and column updates: 6 an
    element of a two-row rotation, 12 of a three-row one, and the passes of
    each Householder reflector of `restore_arnoldi`.  The scalar decisions
    and the residuals' substitutions are not counted, so the count is a
    lower bound of the restart's arithmetic; `chip_smoke.py` divides it by
    the card's issue rate for the kernels' operations bound.  Set `n` to 0
    to count one call."""

    def __init__(self):
        self.n = 0


PLAIN_OPS = _OpCount()


def _sdtype(t):
    return np.float32 if t.dtype == torch.float32 else np.float64


def _eps(t):
    return _sdtype(t)(torch.finfo(t.dtype).eps)


def tree_sum(x, dim=-1):
    """Sum along `dim` by a fixed pairwise tree: zero-pad the length to a
    power of two P, then x[:P/2] + x[P/2:] until one entry is left.  The
    kernel sums in the same order."""
    n = x.shape[dim]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        shape = list(x.shape)
        shape[dim] = p - n
        x = torch.cat((x, x.new_zeros(shape)), dim)
    while p > 1:
        p //= 2
        x = x.narrow(dim, 0, p) + x.narrow(dim, p, p)
    return x.squeeze(dim)


def _hypot(x, y):
    """hypot of two numpy scalars by JAX's formula (jnp.hypot)."""
    a, b = abs(x), abs(y)
    hi, lo = max(a, b), min(a, b)
    if hi == 0:
        return hi
    q = lo / hi
    return hi * np.sqrt(1 + q * q)


def _sqrt_t(x):
    """Square root of a CPU tensor, correctly rounded: numpy's, not
    torch.sqrt, whose vector path on the CPU is not correctly rounded in
    every build (the kernel's sqrtf and sqrt are)."""
    return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))


def _hypot_t(x, y):
    """hypot of two tensors, elementwise, by the same formula."""
    a, b = x.abs(), y.abs()
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    q = lo / torch.where(hi == 0, 1, hi)
    return torch.where(hi == 0, hi, hi * _sqrt_t(1 + q * q))


# --- Givens rotations, applied over a row or column range -------------------


def givens(f, g):
    """Real plane rotation (c, s, r) with [c s; -s c] @ [f; g] = [r; 0]
    (dlartg semantics), on numpy scalars of the working dtype."""
    t = type(f)
    if g == 0:
        return t(1), t(0), f
    if f == 0:
        return t(0), t(-1) if g < 0 else t(1), abs(g)
    scale = max(abs(f), abs(g))
    fs = f / scale
    gs = g / scale
    d = np.sqrt(fs * fs + gs * gs)
    sgn = t(-1) if f < 0 else t(1)
    return abs(fs) / d, sgn * gs / d, sgn * d * scale


def _lmul2(c, s, A, i, j0, j1):
    """A[i:i+2, j0:j1] = G @ A[i:i+2, j0:j1], G = [c s; -s c]."""
    if j1 <= j0:
        return
    PLAIN_OPS.n += 6 * (j1 - j0)
    c, s = float(c), float(s)
    a1, a2 = A[i, j0:j1], A[i + 1, j0:j1]
    r1 = c * a1 + s * a2
    r2 = -s * a1 + c * a2
    A[i, j0:j1] = r1
    A[i + 1, j0:j1] = r2


def _rmul2(A, c, s, i, r0, r1):
    """A[r0:r1, i:i+2] = A[r0:r1, i:i+2] @ G^T."""
    if r1 <= r0:
        return
    PLAIN_OPS.n += 6 * (r1 - r0)
    c, s = float(c), float(s)
    a1, a2 = A[r0:r1, i], A[r0:r1, i + 1]
    n1 = a1 * c + a2 * s
    n2 = -a1 * s + a2 * c
    A[r0:r1, i] = n1
    A[r0:r1, i + 1] = n2


def _lmul3(c1, s1, c2, s2, A, i, j0, j1):
    """Rows i..i+2 times G2 @ G1 (G1 on rows i+1, i+2; G2 on i, i+1)."""
    if j1 <= j0:
        return
    PLAIN_OPS.n += 12 * (j1 - j0)
    c1, s1, c2, s2 = float(c1), float(s1), float(c2), float(s2)
    a1, a2, a3 = A[i, j0:j1], A[i + 1, j0:j1], A[i + 2, j0:j1]
    b2 = c1 * a2 + s1 * a3
    b3 = -s1 * a2 + c1 * a3
    n1 = c2 * a1 + s2 * b2
    n2 = -s2 * a1 + c2 * b2
    A[i, j0:j1] = n1
    A[i + 1, j0:j1] = n2
    A[i + 2, j0:j1] = b3


def _rmul3(A, c1, s1, c2, s2, i, r0, r1):
    if r1 <= r0:
        return
    PLAIN_OPS.n += 12 * (r1 - r0)
    c1, s1, c2, s2 = float(c1), float(s1), float(c2), float(s2)
    a1, a2, a3 = A[r0:r1, i], A[r0:r1, i + 1], A[r0:r1, i + 2]
    b2 = a2 * c1 + a3 * s1
    b3 = -a2 * s1 + a3 * c1
    n1 = a1 * c2 + b2 * s2
    n2 = -a1 * s2 + b2 * c2
    A[r0:r1, i] = n1
    A[r0:r1, i + 1] = n2
    A[r0:r1, i + 2] = b3


# --- Francis QR (real quasi-Schur) ------------------------------------------


def _upper_triangular_2x2(h11, h12, h21, h22):
    """(is_real, c, s) for the trailing real 2x2 block: dlanv2's scaled
    discriminant and the perfect-shift rotation."""
    t = type(h11)
    trivially_pair = h21 == 0 or (h11 == h22 and np.sign(h12) != np.sign(h21))
    if trivially_pair:
        return False, t(1), t(0)
    if h12 == 0:
        return True, t(0), t(1)
    p = (h11 - h22) / 2
    bcmax = max(abs(h12), abs(h21))
    bcmis = min(abs(h12), abs(h21)) * np.sign(h12) * np.sign(h21)
    scale = max(abs(p), bcmax)
    scale_s = t(1) if scale == 0 else scale
    z = (p / scale_s) * p + (bcmax / scale_s) * bcmis
    if z < 0:
        return False, t(1), t(0)
    h11ml = p + np.copysign(np.sqrt(scale) * np.sqrt(max(z, t(0))), p)
    nrm = _hypot(h21, h11ml)
    nrm_s = t(1) if nrm == 0 else nrm
    return True, h11ml / nrm_s, h21 / nrm_s


def _use_single_shift(h11, h12, h21, h22):
    """(is_single, mu): a single Wilkinson shift iff the trailing block has
    real eigenvalues, pre-scaled by the block's 1-norm."""
    t = type(h11)
    scale = abs(h11) + abs(h12) + abs(h21) + abs(h22)
    scale_s = t(1) if scale == 0 else scale
    a11, a12 = h11 / scale_s, h12 / scale_s
    a21, a22 = h21 / scale_s, h22 / scale_s
    tr = (a11 + a22) / 2
    d = (a11 - tr) * (a22 - tr) - a12 * a21
    sq = np.sqrt(abs(d))
    lam1 = tr + sq
    lam2 = tr - sq
    lam = lam1 if abs(a22 - lam1) < abs(a22 - lam2) else lam2
    return bool(d <= 0), lam * scale


def _rot3(p1, p2, p3):
    c1, s1, n1 = givens(p2, p3)
    c2, s2, n2 = givens(p1, n1)
    return c1, s1, c2, s2, n2


def _single_shift_sweep(H, Hn, Q, frm, to, mu):
    m = H.shape[1]
    c, s, _ = givens(Hn[frm, frm] - mu, Hn[frm + 1, frm])
    _lmul2(c, s, H, frm, frm, m)
    _rmul2(H, c, s, frm, 0, min(frm + 3, m))
    _rmul2(Q, c, s, frm, 0, m)
    for i in range(frm + 1, to):
        c, s, nrm = givens(Hn[i, i - 1], Hn[i + 1, i - 1])
        Hn[i, i - 1] = nrm
        Hn[i + 1, i - 1] = 0
        _lmul2(c, s, H, i, i, m)
        _rmul2(H, c, s, i, 0, min(i + 3, m))
        _rmul2(Q, c, s, i, 0, m)


def _double_shift_sweep(H, Hn, Q, frm, to, trace, det):
    m = H.shape[1]
    h11, h21 = Hn[frm, frm], Hn[frm + 1, frm]
    h12, h22 = Hn[frm, frm + 1], Hn[frm + 1, frm + 1]
    h32 = Hn[frm + 2, frm + 1]
    p1 = h11 * h11 + h12 * h21 - trace * h11 + det
    p2 = h21 * (h11 + h22 - trace)
    p3 = h32 * h21
    c1, s1, c2, s2, _ = _rot3(p1, p2, p3)
    _lmul3(c1, s1, c2, s2, H, frm, frm, m)
    _rmul3(H, c1, s1, c2, s2, frm, 0, min(frm + 4, m))
    _rmul3(Q, c1, s1, c2, s2, frm, 0, m)
    for i in range(frm + 1, to - 1):
        c1, s1, c2, s2, nrm = _rot3(Hn[i, i - 1], Hn[i + 1, i - 1],
                                    Hn[i + 2, i - 1])
        Hn[i, i - 1] = nrm
        Hn[i + 1, i - 1] = 0
        Hn[i + 2, i - 1] = 0
        _lmul3(c1, s1, c2, s2, H, i, i, m)
        _rmul3(H, c1, s1, c2, s2, i, 0, min(i + 4, m))
        _rmul3(Q, c1, s1, c2, s2, i, 0, m)
    c, s, nrm = givens(Hn[to - 1, to - 2], Hn[to, to - 2])
    Hn[to - 1, to - 2] = nrm
    Hn[to, to - 2] = 0
    _lmul2(c, s, H, to - 1, to - 1, m)
    _rmul2(H, c, s, to - 1, 0, min(to + 1, m))
    _rmul2(Q, c, s, to - 1, 0, m)


def local_schur(H, Q, lo, hi, eps=None, maxiter=None):
    """Real quasi-Schur factorization of the diagonal window [lo, hi) of
    the Hessenberg H ((m+1, m) or (m, m); rotations never touch rows >= m),
    accumulated into Q ((m, m)), in place.  Returns (H, Q, ok): ok is False
    when `maxiter` (100 m) QR iterations did not finish the window."""
    m = H.shape[1]
    Hn = H.numpy()
    eps = _eps(H) if eps is None else _sdtype(H)(eps)
    if maxiter is None:
        maxiter = 100 * m
    to = hi - 1
    it = 0
    while to > lo and it < maxiter:
        absd = torch.diagonal(H[:m, :m]).abs()
        sub = torch.diagonal(H[:m, :m], -1).abs()
        small = (sub <= float(eps) * (absd[:-1] + absd[1:]))[lo:to].tolist()
        frm = lo
        for j in range(len(small) - 1, -1, -1):
            if small[j]:
                frm = lo + j + 1
                Hn[frm, frm - 1] = 0
                break
        if frm == to:
            to -= 1
        elif frm + 1 == to:
            c11, c12 = Hn[to - 1, to - 1], Hn[to - 1, to]
            c21, c22 = Hn[to, to - 1], Hn[to, to]
            is_real, c, s = _upper_triangular_2x2(c11, c12, c21, c22)
            if is_real:
                _lmul2(c, s, H, frm, frm, m)
                _rmul2(H, c, s, frm, 0, to + 1)
                _rmul2(Q, c, s, frm, 0, m)
                Hn[to, to - 1] = 0
            to -= 2
        else:
            c11, c12 = Hn[to - 1, to - 1], Hn[to - 1, to]
            c21, c22 = Hn[to, to - 1], Hn[to, to]
            is_single, mu = _use_single_shift(c11, c12, c21, c22)
            if is_single:
                _single_shift_sweep(H, Hn, Q, frm, to, mu)
            else:
                _double_shift_sweep(H, Hn, Q, frm, to, c11 + c22,
                                    c11 * c22 - c12 * c21)
        it += 1
    return H, Q, to <= lo


# --- Eigenvalues of the quasi-triangular form (split-complex) ---------------


def _coupled(H, eps):
    m = H.shape[1]
    absd = torch.diagonal(H[:m, :m]).abs()
    sub = torch.diagonal(H[:m, :m], -1)
    return (sub.abs() > float(eps) * (absd[:-1] + absd[1:])).tolist() + [False]


def _starts(coupled):
    starts, in_pair = [], False
    for c in coupled:
        starts.append(not in_pair)
        in_pair = c and not in_pair
    return starts


def block_starts(H, lo=0, hi=None, eps=None):
    """Boolean (m,) tensor: True where a diagonal block starts (1x1, or the
    first of a 2x2 block with a non-negligible subdiagonal); a pair's
    members do not chain."""
    eps = _eps(H) if eps is None else eps
    return torch.tensor(_starts(_coupled(H, eps)))


def eigenvalues(H, eps=None):
    """(lam_re, lam_im, starts): the eigenvalues of the quasi-triangular
    m x m part of H from its diagonal blocks.  A 2x2 block at (i, i+1)
    gives lam[i] = x + iy and lam[i+1] = x - iy from one computation; a
    block whose discriminant is non-negative gives x +- sqrt(disc)."""
    m = H.shape[1]
    eps = _eps(H) if eps is None else eps
    coupled = _coupled(H, eps)
    starts = _starts(coupled)
    pstart = torch.tensor([s and c for s, c in zip(starts, coupled)])
    psecond = torch.cat((torch.zeros(1, dtype=torch.bool), pstart[:-1]))
    z = H.new_zeros(1)
    d = torch.diagonal(H[:m, :m])
    sup = torch.cat((torch.diagonal(H[:m, :m], 1), z))
    sub = torch.cat((torch.diagonal(H[:m, :m], -1), z))
    d_next = torch.cat((d[1:], z))
    x = (d + d_next) / 2
    det = d * d_next - sup * sub
    disc = x * x - det
    y = _sqrt_t(torch.clamp(-disc, min=0))
    rr = _sqrt_t(torch.clamp(disc, min=0))
    x_prev = torch.cat((z, x[:-1]))
    y_prev = torch.cat((z, y[:-1]))
    rr_prev = torch.cat((z, rr[:-1]))
    lam_re = torch.where(pstart, x + rr,
                         torch.where(psecond, x_prev - rr_prev, d))
    lam_im = torch.where(pstart, y, torch.where(psecond, -y_prev, 0))
    return lam_re, lam_im, torch.tensor(starts)


# --- Ritz residuals by split-complex backward substitution ------------------


def _cdiv(ar, ai, br, bi):
    """Split-complex a / b by Smith's algorithm (numpy scalars)."""
    t = type(ar)
    if abs(br) >= abs(bi):
        r = bi / (t(1) if br == 0 else br)
        den = br + bi * r
        den = t(1) if den == 0 else den
        return (ar + ai * r) / den, (ai - ar * r) / den
    r = br / (t(1) if bi == 0 else bi)
    den = bi + br * r
    den = t(1) if den == 0 else den
    return (ar * r + ai) / den, (ai * r - ar) / den


def _residual(H, Hn, qrow, i):
    """|Q[m-1, :] y| for the unit eigenvector y of the block holding
    diagonal index i (the positive-imaginary root for a pair)."""
    m = H.shape[1]
    t = type(Hn[0, 0])
    zero = t(0)
    j = i + 1 if i < m - 1 and Hn[i + 1, i] != 0 else i
    jm1 = max(j - 1, 0)
    pair = j > 0 and Hn[j, jm1] != 0
    b11, b12 = Hn[jm1, jm1], Hn[jm1, j]
    b21, b22 = Hn[j, jm1], Hn[j, j]
    if pair:
        tr2 = (b11 + b22) / 2
        disc = tr2 * tr2 - (b11 * b22 - b21 * b12)
        lr = tr2 + np.sqrt(max(disc, zero))
        li = np.sqrt(max(-disc, zero))
    else:
        lr, li = b22, zero
    x_re = torch.zeros(m, dtype=H.dtype)
    x_im = torch.zeros(m, dtype=H.dtype)
    if pair:
        xr, xi = _cdiv(-b12, zero, b11 - lr, -li)
        x_re[:j - 1] = -H[:j - 1, jm1] * float(xr) - H[:j - 1, j]
        x_im[:j - 1] = -H[:j - 1, jm1] * float(xi)
        x_re[j - 1], x_im[j - 1] = float(xr), float(xi)
        k = j - 1
    else:
        x_re[:j] = -H[:j, j]
        k = j
    x_re[j] = 1
    xrn, xin = x_re.numpy(), x_im.numpy()
    while k > 0:
        if k > 1 and abs(Hn[k - 1, k - 2]) > 0:
            i2 = k - 2
            r11 = Hn[i2, i2] - lr
            r12 = Hn[i2, k - 1]
            r21 = Hn[k - 1, i2]
            r22 = Hn[k - 1, k - 1] - lr
            det_re = r11 * r22 - li * li - r21 * r12
            det_im = -li * (r11 + r22)
            b1r, b1i = xrn[i2], xin[i2]
            b2r, b2i = xrn[k - 1], xin[k - 1]
            n1r = r22 * b1r + li * b1i - r12 * b2r
            n1i = r22 * b1i - li * b1r - r12 * b2i
            n2r = -r21 * b1r + r11 * b2r + li * b2i
            n2i = -r21 * b1i + r11 * b2i - li * b2r
            a1r, a1i = _cdiv(n1r, n1i, det_re, det_im)
            a2r, a2i = _cdiv(n2r, n2i, det_re, det_im)
            col_a, col_b = H[:i2, i2], H[:i2, k - 1]
            x_re[:i2] = x_re[:i2] - (col_a * float(a1r) + col_b * float(a2r))
            x_im[:i2] = x_im[:i2] - (col_a * float(a1i) + col_b * float(a2i))
            xrn[i2], xin[i2] = a1r, a1i
            xrn[k - 1], xin[k - 1] = a2r, a2i
            k -= 2
        else:
            sr = Hn[k - 1, k - 1] - lr
            si = -li
            if sr == 0 and si == 0:
                vr = vi = zero
            else:
                vr, vi = _cdiv(xrn[k - 1], xin[k - 1], sr, si)
            col_a = H[:k - 1, k - 1]
            x_re[:k - 1] = x_re[:k - 1] - col_a * float(vr)
            x_im[:k - 1] = x_im[:k - 1] - col_a * float(vi)
            xrn[k - 1], xin[k - 1] = vr, vi
            k -= 1
    nrm = np.sqrt(tree_sum(x_re * x_re + x_im * x_im).numpy()[()])
    nrm = t(1) if nrm == 0 else nrm
    tr = tree_sum(qrow * x_re).numpy()[()] / nrm
    ti = tree_sum(qrow * x_im).numpy()[()] / nrm
    return np.sqrt(tr * tr + ti * ti)


def residuals(H, Q, h_last, lo, hi, eps=None):
    """rs[i] = |Q[m-1, :] y_i| |h_last| for the Ritz positions i in
    [lo, hi), 0 elsewhere: y_i the unit eigenvector of the quasi-triangular
    block holding i, by shifted backward substitution in split-complex
    arithmetic."""
    m = H.shape[1]
    Hn = H.numpy()
    hl = abs(_sdtype(H)(float(h_last)))
    qrow = Q[m - 1, :]
    rs = torch.zeros(m, dtype=H.dtype)
    rn = rs.numpy()
    for i in range(lo, hi):
        rn[i] = _residual(H, Hn, qrow, i) * hl
    return rs


# --- Sylvester swaps and Schur reordering -----------------------------------


def _solve_complete_pivot(M, b):
    """Gaussian elimination with complete pivoting of an N x N numpy system
    (N = 1, 2, 4), in JAX's order.  Returns (x, singular); x is garbage
    when singular."""
    N = M.shape[0]
    t = M.dtype.type
    M, x = M.copy(), b.copy()
    colperm = list(range(N))
    singular = False
    for k in range(N - 1):
        best, bi, bj = t(-1), k, k
        for i in range(k, N):
            for j in range(k, N):
                if abs(M[i, j]) > best:
                    best, bi, bj = abs(M[i, j]), i, j
        M[[k, bi]] = M[[bi, k]]
        x[[k, bi]] = x[[bi, k]]
        M[:, [k, bj]] = M[:, [bj, k]]
        colperm[k], colperm[bj] = colperm[bj], colperm[k]
        pivot = M[k, k]
        singular = singular or pivot == 0
        piv_s = t(1) if pivot == 0 else pivot
        for r in range(k + 1, N):
            fac = M[r, k] / piv_s
            for c in range(k + 1, N):
                M[r, c] = M[r, c] - fac * M[k, c]
            M[r, k] = fac
            x[r] = x[r] - fac * x[k]
    singular = singular or M[N - 1, N - 1] == 0
    for i in range(N - 1, -1, -1):
        terms = torch.from_numpy(np.where(np.arange(N) > i, M[i] * x, t(0)))
        s = tree_sum(terms).numpy()[()]
        piv = M[i, i]
        x[i] = (x[i] - s) / (t(1) if piv == 0 else piv)
    out = np.zeros_like(x)
    out[colperm] = x
    return out, singular


def _sylv(A, B, C):
    """Solve A X - X B = C for blocks of size p, q in {1, 2}: the Kronecker
    system (I_q (x) A - B^T (x) I_p) vec(X) = vec(C), column-major."""
    p, q = C.shape
    t = A.dtype.type
    N = p * q
    M = np.zeros((N, N), dtype=A.dtype)
    for a in range(q):
        for c in range(p):
            for b in range(q):
                for d in range(p):
                    va = A[c, d] if a == b else t(0)
                    vb = B[b, a] if c == d else t(0)
                    M[a * p + c, b * p + d] = va - vb
    x, singular = _solve_complete_pivot(M, C.T.reshape(N).copy())
    return x.reshape(q, p).T, singular


def _swap11(H, Hn, Q, i):
    m = H.shape[1]
    r11, r12, r22 = Hn[i, i], Hn[i, i + 1], Hn[i + 1, i + 1]
    c, s, _ = givens(r12, r22 - r11)
    _lmul2(c, s, H, i, i + 2, m)
    _rmul2(H, c, s, i, 0, i)
    Hn[i, i] = r22
    Hn[i + 1, i + 1] = r11
    _rmul2(Q, c, s, i, 0, m)


def _swap12(H, Hn, Q, i):
    m = H.shape[1]
    X, singular = _sylv(Hn[i:i + 1, i:i + 1], Hn[i + 1:i + 3, i + 1:i + 3],
                        Hn[i:i + 1, i + 1:i + 3])
    if singular:
        return
    one = X.dtype.type(1)
    c1, s1, _ = givens(-X[0, 0], one)
    x22 = -s1 * -X[0, 1]
    c2, s2, _ = givens(x22, one)
    _lmul2(c1, s1, H, i, i, m)
    _rmul2(H, c1, s1, i, 0, i + 3)
    _lmul2(c2, s2, H, i + 1, i, m)
    _rmul2(H, c2, s2, i + 1, 0, i + 3)
    Hn[i + 2, i] = 0
    Hn[i + 2, i + 1] = 0
    _rmul2(Q, c1, s1, i, 0, m)
    _rmul2(Q, c2, s2, i + 1, 0, m)


def _swap21(H, Hn, Q, i):
    m = H.shape[1]
    X, singular = _sylv(Hn[i:i + 2, i:i + 2], Hn[i + 2:i + 3, i + 2:i + 3],
                        Hn[i:i + 2, i + 2:i + 3])
    if singular:
        return
    one = X.dtype.type(1)
    c1, s1, n1 = givens(-X[1, 0], one)
    c2, s2, _ = givens(-X[0, 0], n1)
    _lmul3(c1, s1, c2, s2, H, i, i, m)
    _rmul3(H, c1, s1, c2, s2, i, 0, i + 3)
    Hn[i + 1, i] = 0
    Hn[i + 2, i] = 0
    _rmul3(Q, c1, s1, c2, s2, i, 0, m)


def _swap22(H, Hn, Q, i):
    m = H.shape[1]
    X, singular = _sylv(Hn[i:i + 2, i:i + 2], Hn[i + 2:i + 4, i + 2:i + 4],
                        Hn[i:i + 2, i + 2:i + 4])
    if singular:
        return
    one = X.dtype.type(1)
    c1, s1, n1 = givens(-X[1, 0], one)
    c2, s2, _ = givens(-X[0, 0], n1)
    x22 = c1 * -X[1, 1]
    x32 = -s1 * -X[1, 1]
    x22 = -s2 * -X[0, 1] + c2 * x22
    c3, s3, n3 = givens(x32, one)
    c4, s4, _ = givens(x22, n3)
    _lmul3(c1, s1, c2, s2, H, i, i, m)
    _rmul3(H, c1, s1, c2, s2, i, 0, i + 4)
    _lmul3(c3, s3, c4, s4, H, i + 1, i, m)
    _rmul3(H, c3, s3, c4, s4, i + 1, 0, i + 4)
    Hn[i + 2, i] = 0
    Hn[i + 3, i] = 0
    Hn[i + 2, i + 1] = 0
    Hn[i + 3, i + 1] = 0
    _rmul3(Q, c1, s1, c2, s2, i, 0, m)
    _rmul3(Q, c3, s3, c4, s4, i + 1, 0, m)


_SWAPS = (_swap11, _swap12, _swap21, _swap22)


def _is_start_11(Hn, i, m):
    return i == m - 1 or Hn[min(i + 1, m - 1), i] == 0


def _is_end_11(Hn, i):
    return i == 0 or Hn[i, max(i - 1, 0)] == 0


def swap(H, Q, i, curr_is_11, next_is_11):
    """Swap the two consecutive diagonal blocks starting at i, in place."""
    _SWAPS[(0 if curr_is_11 else 2) + (0 if next_is_11 else 1)](
        H, H.numpy(), Q, i)
    return H, Q


def rotate_right(H, Q, frm, to):
    """Move the block at `to` in front of `frm` by successive swaps."""
    m = H.shape[1]
    Hn = H.numpy()
    i = to
    while i > frm:
        curr_11 = _is_start_11(Hn, i, m)
        prev_11 = _is_end_11(Hn, i - 1)
        j = i - 1 if prev_11 else i - 2
        swap(H, Q, j, prev_11, curr_11)
        i = j
    return H, Q


def partition_three_way(H, Q, groups):
    """Partition the Schur blocks into [locked | retained | purged] by
    rotating group-1 and group-2 blocks forward; `groups` (1, 2 or 3) is
    indexed by original diagonal position."""
    m = H.shape[1]
    Hn = H.numpy()
    groups = [int(g) for g in groups]
    hi = mi = lo = 0
    while hi < m:
        group = groups[min(hi, m - 1)]
        bs = 1 if _is_start_11(Hn, hi, m) else 2
        if group <= 1:
            rotate_right(H, Q, lo, hi)
            lo += bs
            mi += bs
        elif group == 2:
            rotate_right(H, Q, mi, hi)
            mi += bs
        hi += bs
    return H, Q


def order_key(which, lam_re, lam_im):
    """The sort key of a target for split-complex eigenvalues (smaller
    sorts first): tensors, or numpy scalars."""
    if which == "LM":
        if isinstance(lam_re, torch.Tensor):
            return -_hypot_t(lam_re, lam_im)
        return -_hypot(lam_re, lam_im)
    if which == "LR":
        return -lam_re
    if which == "SR":
        return lam_re
    if which == "LI":
        return -lam_im
    if which == "SI":
        return lam_im
    raise ValueError(f"unknown target {which!r}")


def _block_eig_key(Hn, i, m, which):
    """The order key of the block starting at i (the +imag root of a
    pair)."""
    t = type(Hn[0, 0])
    if _is_start_11(Hn, i, m):
        return order_key(which, Hn[i, i], t(0))
    i1 = min(i + 1, m - 1)
    b11, b12 = Hn[i, i], Hn[i, i1]
    b21, b22 = Hn[i1, i], Hn[i1, i1]
    x = (b11 + b22) / 2
    disc = x * x - (b11 * b22 - b12 * b21)
    return order_key(which, x + np.sqrt(max(disc, t(0))),
                     np.sqrt(max(-disc, t(0))))


def sort_schur(H, Q, count, which):
    """Insertion sort of the leading `count` Schur blocks into the target
    order by direct swaps, in place."""
    m = H.shape[1]
    Hn = H.numpy()
    nxt = 0
    while nxt < count:
        curr = nxt
        curr_size0 = 1 if _is_start_11(Hn, curr, m) else 2
        key_curr = _block_eig_key(Hn, curr, m, which)
        while curr > 0:
            prev_size = 1 if _is_end_11(Hn, curr - 1) else 2
            prev = curr - prev_size
            if not key_curr < _block_eig_key(Hn, max(prev, 0), m, which):
                break
            curr_size = 1 if _is_start_11(Hn, curr, m) else 2
            swap(H, Q, prev, prev_size == 1, curr_size == 1)
            curr = prev
        nxt += curr_size0
    return H, Q


# --- Hessenberg restoration after truncation --------------------------------


def restore_arnoldi(H, Q, lo, hi):
    """Zero Q's last row over [lo, hi-1) with Givens rotations, move the
    residual coupling into H[hi, hi-1], then restore the Hessenberg form of
    the window with a backward Householder sweep, in place.  A no-op when
    the window has at most one column.  The Householder pass keeps JAX's
    masked full-width sums (in `tree_sum`'s order)."""
    m = H.shape[1]
    last = Q.shape[0] - 1
    if lo >= hi - 1:
        return H, Q
    Hn, Qn = H.numpy(), Q.numpy()
    t = _sdtype(H)
    nrm = Qn[last, lo]
    for i in range(lo, hi - 1):
        c, s, nrm2 = givens(Qn[last, i + 1], nrm)
        _rmul2(H, c, -s, i, 0, min(i + 3, hi))
        _lmul2(c, -s, H, i, 0, hi)
        _rmul2(Q, c, -s, i, 0, Q.shape[0])
        nrm = nrm2
    Hn[hi, hi - 1] = Qn[last, hi - 1] * Hn[m, m - 1]

    cols = torch.arange(m)
    rows_h = torch.arange(H.shape[0])
    colsel = (cols >= lo) & (cols < hi)
    for tt in range(max(hi - 1 - lo - 1, 0)):
        length = (hi - 1 - lo) - tt
        row = lo + length
        lastc = row - 1
        vmask = (cols >= lo) & (cols < lastc)
        alpha = Hn[row, lastc]
        hrow = H[row].clone()
        xnrm2 = tree_sum(torch.where(vmask, hrow * hrow, 0)).numpy()[()]
        beta = -np.copysign(_hypot(abs(alpha), np.sqrt(xnrm2)), alpha)
        beta_s = t(1) if beta == 0 else beta
        tau = t(0) if xnrm2 == 0 else (beta - alpha) / beta_s
        denom = alpha - beta
        denom = t(1) if denom == 0 else denom
        v = torch.where(vmask, hrow / float(denom), 0)
        vaug = v + (cols == lastc).to(H.dtype)
        vaug_rows = torch.cat((vaug, vaug.new_zeros(H.shape[0] - m)))
        d = torch.where(rows_h < row, float(tau) * tree_sum(H * vaug), 0)
        H -= d[:, None] * vaug[None, :]
        beta_w = alpha if xnrm2 == 0 else beta
        H[row] = torch.where(vmask, 0, torch.where(cols == lastc,
                                                   float(beta_w), H[row]))
        d2 = torch.where(colsel,
                         float(tau) * tree_sum(vaug_rows[:, None] * H, 0), 0)
        H -= vaug_rows[:, None] * d2[None, :]
        dq = float(tau) * tree_sum(Q * vaug)
        Q -= dq[:, None] * vaug[None, :]
        # The squares and their sum, v, and four rank-1 passes with their
        # products and sums (two over H, one over Q).
        PLAIN_OPS.n += 3 * m + 8 * (m + 1) * m + 4 * m * m
    return H, Q


# --- The dense phases of the fused restart loop -----------------------------


def new_state(active0, m, restarts, device=None):
    """The int32 loop state before the first restart (fused.py's
    `_fused_init`): prods m - active0, done when restarts <= 0."""
    s = [0] * STATE_LEN
    s[STATE["active"]] = active0
    s[STATE["prods"]] = m - active0
    s[STATE["done"]] = int(restarts <= 0)
    s[STATE["qr_ok"]] = 1
    s[STATE["k"]] = active0
    s[STATE["rollback"]] = -1
    return torch.tensor(s, dtype=torch.int32, device=device)


def restart_plain(H, Qbig, state, flags, nev, mindim, tol, restarts, which,
                  maxiter=None, info=None):
    """The plain version of one restart's dense phase (fused.py:109-202
    from `local_schur` through `Qbig`), in place on the CPU tensors H
    ((m+1, m)), Qbig ((m+1, m+1)) and the int32 `state` (`STATE`).

    First the breakdown flags of the last expansion range: if step j broke
    down (flags[j] != 0, the lowest such j), state's rollback slot becomes
    j and nothing else changes.  Otherwise the rollback slot is -1 and the
    restart runs: Francis QR over [active, m) (maxiter = 100 m), Ritz
    values and residuals with the Schur-coupling floor and the pair max,
    the stable sort by the target's key, the locking count and the group
    walk, the purge index, the three-way partition, the Hessenberg
    restore, and Qbig, the basis change V <- Qbig^T V.  The state's
    counters advance as the JAX loop's do.  Returns the Q of the restart;
    `info` (int32, 4 + 2m), when given, receives nlock, k, purge,
    effective_nev, the sorted order and the groups."""
    m = H.shape[1]
    S = state.numpy()
    broke = np.flatnonzero(flags.numpy()[:m])
    if broke.size:
        S[STATE["rollback"]] = broke[0]
        return None
    S[STATE["rollback"]] = -1
    t = _sdtype(H)
    eps = _eps(H)
    active = int(S[STATE["active"]])
    if maxiter is None:
        maxiter = 100 * m
    idxv = torch.arange(m)

    Q = torch.eye(m, dtype=H.dtype)
    _, _, ok = local_schur(H, Q, active, m, eps, maxiter)
    lam_re, lam_im, _ = eigenvalues(H, eps)
    rs = residuals(H, Q, H[m, m - 1], active, m, eps)
    coupling = H[m, m - 1].abs() * Q[m - 1, :].abs()
    rs = torch.maximum(rs, coupling)
    z = H.new_zeros(1)
    sub = torch.cat((torch.diagonal(H[:m, :m], -1), z))
    first = (sub != 0) & (idxv < m - 1)
    second = torch.cat((torch.zeros(1, dtype=torch.bool), first[:-1]))
    rs = torch.where(first, torch.maximum(rs, torch.cat((rs[1:], z))), rs)
    rs = torch.where(second, torch.maximum(rs, torch.cat((z, rs[:-1]))), rs)
    hfrob = _sqrt_t(tree_sum((H * H).reshape(-1)))

    keys = order_key(which, lam_re, lam_im)
    ord_ = torch.argsort(keys, stable=True)
    lre_s, lim_s = lam_re[ord_], lam_im[ord_]
    floor = torch.maximum(float(eps) * hfrob,
                          float(t(tol)) * _hypot_t(lre_s, lim_s))
    conv_s = (rs[ord_] <= floor).tolist()
    lre_n = torch.cat((lre_s[1:], z))
    lim_n = torch.cat((lim_s[1:], z))
    pair_at = ((lim_s != 0) & (lre_s == lre_n) & (lim_s == -lim_n)
               & (idxv < m - 1)).tolist()
    effective_nev = nev + int(pair_at[max(nev - 1, 0)])
    nlock = sum(1 for p in range(min(effective_nev, m)) if conv_s[p])
    ideal = min(nlock + mindim, (mindim + m) // 2)

    k, skip, grp = effective_nev, False, 0
    grp_sorted = []
    for pos in range(m):
        in_tail = pos >= effective_nev
        lead = 2 if k < ideal and not conv_s[pos] else 3
        grp = grp if skip else lead
        if in_tail and not skip and grp == 2:
            k += 2 if pair_at[pos] else 1
        grp_sorted.append(grp if in_tail else (1 if conv_s[pos] else 2))
        skip = in_tail and not skip and pair_at[pos]
    order = ord_.tolist()
    groups = [0] * m
    for p, g in zip(order, grp_sorted):
        groups[p] = g
    purge = next((i for i in range(active) if groups[i] != 1), active)

    partition_three_way(H, Q, groups)
    restore_arnoldi(H, Q, nlock, k)

    Qbig.zero_()
    Qbig.diagonal().fill_(1)
    if purge < k:
        Qbig[:, purge:k] = 0
        Qbig[purge:m, purge:k] = Q[purge:m, purge:k]
    if k < m:
        Qbig[:, k] = 0
        Qbig[m, k] = 1

    it = int(S[STATE["it"]]) + 1
    done = nlock >= nev or it >= restarts
    S[STATE["active"]] = nlock
    S[STATE["it"]] = it
    S[STATE["purges"]] += int(purge < active)
    S[STATE["done"]] = int(done)
    S[STATE["qr_ok"]] &= int(ok)
    S[STATE["k"]] = k
    S[STATE["prods"]] += 0 if done else m - k
    if info is not None:
        info[:4] = torch.tensor([nlock, k, purge, effective_nev])
        info[4:4 + m] = torch.tensor(order)
        info[4 + m:4 + 2 * m] = torch.tensor(groups)
    return Q


def finish_plain(H, Qbig, lam, count, which):
    """The plain version of the final dense phase (fused.py's
    `_fused_finish`): sort the leading `count` Schur blocks into the
    target order, write the basis change (identity with Q in its leading
    m x m block) to Qbig and the eigenvalues to lam ((2, m): re, im).
    Returns Q."""
    m = H.shape[1]
    Q = torch.eye(m, dtype=H.dtype)
    sort_schur(H, Q, count, which)
    Qbig.zero_()
    Qbig.diagonal().fill_(1)
    Qbig[:m, :m] = Q
    lam_re, lam_im, _ = eigenvalues(H)
    lam[0], lam[1] = lam_re, lam_im
    return Q


# --- the CUDA kernels --------------------------------------------------------

_SOURCE = PACKAGE_DIR / "csrc" / "dense_restart.cu"
# Threads of the one CTA a call runs on.
THREADS = 256


class _DenseRestartKernel:
    """The built library of `csrc/dense_restart.cu` and the counts of its
    launches: `launches` for the restart kernel, `finish_launches` for the
    final sort."""

    def __init__(self):
        self.launches = 0
        self.finish_launches = 0
        self.build_log = ""
        self._lib = None

    def load(self):
        """Build (once per source hash) and load the library."""
        if self._lib is None:
            path, self.build_log = build_shared(
                "dense_restart", [_SOURCE],
                [*nvcc_command("dense restart"), "--fmad=false"])
            self._lib = bind(ctypes.CDLL(str(path)))
        return self._lib

    def _scratch(self, lib, H):
        m = H.shape[1]
        work = torch.empty(lib.dense_restart_work_len(m), dtype=H.dtype,
                           device=H.device)
        iwork = torch.empty(lib.dense_restart_iwork_len(m), dtype=torch.int32,
                            device=H.device)
        return work, iwork

    def restart(self, H, Qbig, state, flags, nev, mindim, tol, restarts,
                which, maxiter=None, info=None):
        """One launch of the restart kernel on H's device and current
        stream; returns Q.  Raises on a launch error."""
        _check(H, Qbig, state, flags)
        m = H.shape[1]
        lib = self.load()
        work, iwork = self._scratch(lib, H)
        Q = torch.empty((m, m), dtype=H.dtype, device=H.device)
        if info is None:
            info = torch.empty(4 + 2 * m, dtype=torch.int32, device=H.device)
        fn = lib.dense_restart_f32 if H.dtype == torch.float32 else lib.dense_restart_f64
        with torch.cuda.device(H.device):
            stream = torch.cuda.current_stream(H.device).cuda_stream
            err = fn(H.data_ptr(), Q.data_ptr(), Qbig.data_ptr(),
                     state.data_ptr(), flags.data_ptr(), info.data_ptr(),
                     work.data_ptr(), iwork.data_ptr(), m, nev, mindim,
                     float(tol), restarts, ORDER_CODES[which],
                     100 * m if maxiter is None else maxiter, THREADS, stream)
        if err != 0:
            raise RuntimeError(f"dense_restart kernel launch failed: CUDA error {err}")
        self.launches += 1
        return Q

    def finish(self, H, Qbig, lam, state, which):
        """One launch of the finish kernel; returns Q."""
        _check(H, Qbig, state, lam)
        m = H.shape[1]
        lib = self.load()
        work, iwork = self._scratch(lib, H)
        Q = torch.empty((m, m), dtype=H.dtype, device=H.device)
        fn = lib.dense_finish_f32 if H.dtype == torch.float32 else lib.dense_finish_f64
        with torch.cuda.device(H.device):
            stream = torch.cuda.current_stream(H.device).cuda_stream
            err = fn(H.data_ptr(), Q.data_ptr(), Qbig.data_ptr(), lam.data_ptr(),
                     state.data_ptr(), work.data_ptr(), iwork.data_ptr(), m,
                     ORDER_CODES[which], THREADS, stream)
        if err != 0:
            raise RuntimeError(f"dense_finish kernel launch failed: CUDA error {err}")
        self.finish_launches += 1
        return Q


def bind(lib):
    """Set the argument types of the library's C entries (the CUDA build,
    or a host build of the same source); returns lib."""
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("dense_restart_work_len", "dense_restart_iwork_len"):
        getattr(lib, name).argtypes = [i]
        getattr(lib, name).restype = ctypes.c_longlong
    for word in ("_f32", "_f64"):
        f = getattr(lib, "dense_restart" + word)
        f.argtypes = [p] * 8 + [i, i, i, d, i, i, i, i, p]
        f.restype = i
        f = getattr(lib, "dense_finish" + word)
        f.argtypes = [p] * 7 + [i, i, i, p]
        f.restype = i
    return lib


def _check(H, Qbig, state, vec):
    m = H.shape[1]
    if H.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the dense restart takes float32 or float64, got {H.dtype}")
    if tuple(H.shape) != (m + 1, m) or m < 2:
        raise ValueError(f"H must be (m+1, m) with m >= 2, got {tuple(H.shape)}")
    if tuple(Qbig.shape) != (m + 1, m + 1):
        raise ValueError("Qbig must be (m+1, m+1)")
    if state.dtype != torch.int32 or state.numel() != STATE_LEN:
        raise ValueError(f"state must be {STATE_LEN} int32")
    for t in (H, Qbig, state, vec):
        if not t.is_contiguous() or t.device != H.device:
            raise ValueError("the dense restart takes contiguous tensors on "
                             "one device")
    if vec.dtype != H.dtype:
        raise ValueError("flags and lam must have H's dtype")


KERNEL = _DenseRestartKernel()


def restart(H, Qbig, state, flags, *, nev, mindim, tol, restarts, which,
            maxiter=None, info=None):
    """One restart's dense phase, in place (see `restart_plain`): a CPU
    tensor takes the plain version, a CUDA tensor launches the restart
    kernel or raises.  Returns the restart's Q (None after a rollback on
    the CPU)."""
    if H.device.type == "cpu":
        return restart_plain(H, Qbig, state, flags, nev, mindim, tol,
                             restarts, which, maxiter, info)
    if H.device.type != "cuda":
        raise ValueError(f"the dense restart runs on cpu or cuda tensors, got {H.device}")
    return KERNEL.restart(H, Qbig, state, flags, nev, mindim, tol, restarts,
                          which, maxiter, info)


def finish(H, Qbig, lam, state, which):
    """The final dense phase, in place (see `finish_plain`), for the
    `state`'s active count; the plain version on a CPU tensor, the finish
    kernel on a CUDA tensor.  Returns Q."""
    if H.device.type == "cpu":
        return finish_plain(H, Qbig, lam, int(state[STATE["active"]]), which)
    if H.device.type != "cuda":
        raise ValueError(f"the dense restart runs on cpu or cuda tensors, got {H.device}")
    return KERNEL.finish(H, Qbig, lam, state, which)
