"""Double-word arithmetic: a value is the unevaluated sum hi + lo of two
words of one floating type, float32 ("df32", about 2^-48 relative) or
float64 (about 2^-106).  These are the plain PyTorch versions; the CUDA
kernels of `ops/df.py` compute the same functions in one pass each and are
held bitwise to them.

Error-free transforms (Dekker 1971; Knuth):

  * two_sum (branch-free, 6 operations): s + e == a + b exactly;
  * two_prod (Dekker's split, no FMA): p + e == a * b exactly.  The split
    constant is 2^12 + 1 for float32 words and 2^27 + 1 for float64 words
    (half the significand, rounded up).  The JAX package uses 2^12 + 1 for
    both, which leaves its float64-word products only about f64-accurate;
    the port follows the contract above instead.

On top of these, df_add / df_mul / df_sum / df_dot and the Gram-Schmidt
helpers.  Names and operation order are those of arnoldimethod_tpu's
ops/df32.py, so with float32 words every result here is bitwise equal to
the JAX package's on the CPU.

Why there is no `_pin` here: the JAX package clamps every intermediate
(`_pin`, its df32.py:63-78) because inside one jitted program XLA:CPU
contracts a product and a sum into an FMA, which skips the product's
rounding and breaks the transforms.  Eager PyTorch runs every operator
below as its own kernel and rounds its result to the word type, so no
product is ever contracted into a following sum.  That holds only as long
as every step stays its own operator: `addcmul`, `addcdiv`, `lerp`, the
`alpha=` argument of add/sub, `baddbmm`, `torch.compile` and `torch.jit`
may fuse or contract and must not be used here.

MAGNITUDE LIMIT: the split multiplies by the constant, which overflows for
|a| above about max / 2^12 (float32) or max / 2^27 (float64); keep operands
far below that (the normalized Krylov bases and O(||A||) Hessenberg entries
this serves are).

The scalar functions (two_sum, two_prod, df_add, df_mul, df_scale, df_inv,
df_sqrt) also take numpy scalars of the word type: the extended solve
finishes its norms and reciprocals on the host that way, with the same
IEEE operations at a fraction of the cost of 0-dim tensors.  Constants are
made in the operands' type, so no numpy promotion rule can widen them.

`PLAIN_ON_CARD` counts calls of the public functions made on CUDA tensors:
on the card the extended solve runs its n-sized work in the kernels and its
scalar work on the host, so a solve there should leave it at 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "PLAIN_ON_CARD",
    "two_sum",
    "split",
    "two_prod",
    "df_add",
    "df_sub",
    "df_mul",
    "df_scale",
    "df_sum",
    "df_dot",
    "df_project_coeffs",
    "df_project_coeffs_df",
    "df_axpy_update",
    "df_axpy_update_df",
    "df_inv",
    "df_norm",
    "df_sqrt",
    "split_constant",
]

PLAIN_ON_CARD = 0


def _counted(fn):
    """Count the calls of `fn` whose first argument lies on a CUDA card."""

    @functools.wraps(fn)
    def wrapper(x, *args, **kwargs):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            global PLAIN_ON_CARD
            PLAIN_ON_CARD += 1
        return fn(x, *args, **kwargs)

    return wrapper


def split_constant(dtype):
    """Dekker's split constant for words of `dtype` (torch or numpy):
    2^12 + 1 for float32, 2^27 + 1 for float64."""
    if dtype in (torch.float32, np.float32):
        return 4097.0
    if dtype in (torch.float64, np.float64):
        return 134217729.0
    raise TypeError(f"double-word arithmetic takes float32 or float64, got {dtype}")


def _const(x, v):
    """v in x's word type: a Python float beside a tensor (a weak scalar,
    taken in the tensor's type), a numpy scalar beside a numpy scalar."""
    return v if isinstance(x, torch.Tensor) else x.dtype.type(v)


def _full_like(x, v):
    return torch.full_like(x, v) if isinstance(x, torch.Tensor) else x.dtype.type(v)


@_counted
def two_sum(a, b):
    """Error-free sum: (s, e) with s = fl(a+b) and s + e == a + b."""
    s = a + b
    bp = s - a
    t1 = s - bp
    e = (a - t1) + (b - bp)
    return s, e


def _quick_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (3 operations)."""
    s = a + b
    t = s - a
    e = b - t
    return s, e


@_counted
def split(a):
    """Dekker's split: (hi, lo) with hi + lo == a, each about half of the
    significand (4 operations)."""
    ac = _const(a, split_constant(a.dtype)) * a
    ta = ac - a
    hi = ac - ta
    return hi, a - hi


@_counted
def two_prod(a, b, a_split=None, b_split=None):
    """Error-free product: (p, e) with p = fl(a*b) and p + e == a * b.
    `a_split` / `b_split`, an operand's split(...) made beforehand, give the
    same bits: a kernel splits an operand once for all its products."""
    p = a * b
    ahi, alo = split(a) if a_split is None else a_split
    bhi, blo = split(b) if b_split is None else b_split
    e1 = ahi * bhi - p
    e2 = e1 + ahi * blo
    e3 = e2 + alo * bhi
    e = e3 + alo * blo
    return p, e


@_counted
def df_add(xh, xl, yh, yl):
    """(xh, xl) + (yh, yl), accurate double-word add (Knuth add2)."""
    sh, se = two_sum(xh, yh)
    te = xl + yl + se
    return _quick_two_sum(sh, te)


@_counted
def df_sub(xh, xl, yh, yl):
    return df_add(xh, xl, -yh, -yl)


@_counted
def df_mul(xh, xl, yh, yl):
    """(xh, xl) * (yh, yl) to double-word accuracy."""
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return _quick_two_sum(ph, pe)


@_counted
def df_scale(xh, xl, c, x_split=None, c_split=None):
    """(xh, xl) * c for a single-word scalar or tensor c; `x_split` and
    `c_split` as in two_prod."""
    ph, pe = two_prod(xh, c, x_split, c_split)
    pe = pe + xl * c
    return _quick_two_sum(ph, pe)


@_counted
def df_sum(xh, xl, axis=-1):
    """Double-word sum along `axis` by a pairwise tree of df_add: pad to a
    power of two with zeros, then combine the lower half (left operand)
    with the upper half until one element is left."""
    xh = torch.movedim(xh, axis, -1)
    xl = torch.movedim(xl, axis, -1)
    n = xh.shape[-1]
    pow2 = 1 << max(0, n - 1).bit_length()
    if pow2 != n:
        xh = torch.nn.functional.pad(xh, (0, pow2 - n))
        xl = torch.nn.functional.pad(xl, (0, pow2 - n))
    while xh.shape[-1] > 1:
        half = xh.shape[-1] // 2
        xh, xl = df_add(
            xh[..., :half], xl[..., :half], xh[..., half:], xl[..., half:]
        )
    return xh[..., 0], xl[..., 0]


@_counted
def df_dot(x, y, axis=-1):
    """Compensated dot of single-word tensors along `axis`: exact products
    (two_prod), then the double-word tree sum."""
    p, e = two_prod(x, y)
    return df_sum(p, e, axis=axis)


@_counted
def df_project_coeffs(V, wh, wl):
    """h = V @ w for a double-word w against a single-word basis V (m, n):
    exact products against both words, one tree sum per row."""
    ph, pe = two_prod(V, wh[None, :])
    pe = pe + V * wl[None, :]
    return df_sum(ph, pe, axis=-1)


@_counted
def df_axpy_update(wh, wl, hh, hl, V):
    """w <- w - sum_j h_j V[j] in double word, j in order; V single-word."""
    for j in range(V.shape[0]):
        th, tl = df_scale(hh[j].expand_as(V[j]), hl[j].expand_as(V[j]), V[j])
        wh, wl = df_sub(wh, wl, th, tl)
    return wh, wl


@_counted
def df_project_coeffs_df(Vh, Vl, wh, wl):
    """h = V @ w with both the basis V (m, n) and w double-word."""
    ph, pe = df_mul(Vh, Vl, wh[None, :], wl[None, :])
    return df_sum(ph, pe, axis=-1)


@_counted
def df_axpy_update_df(wh, wl, hh, hl, Vh, Vl):
    """w <- w - sum_j h_j V[j] with a double-word basis, j in order."""
    for j in range(Vh.shape[0]):
        th, tl = df_mul(hh[j].expand_as(Vh[j]), hl[j].expand_as(Vh[j]),
                        Vh[j], Vl[j])
        wh, wl = df_sub(wh, wl, th, tl)
    return wh, wl


@_counted
def df_inv(xh, xl):
    """Double-word reciprocal 1 / (xh, xl): a single-word seed and one
    Newton step r <- r + r * (1 - x * r) carried in double word."""
    r = _const(xh, 1.0) / xh
    zero = _full_like(r, 0.0)
    ph, pe = df_mul(xh, xl, r, zero)
    dh, dl = df_add(_full_like(r, 1.0), zero, -ph, -pe)
    ch, ce = df_scale(dh, dl, r)
    return df_add(r, zero, ch, ce)


@_counted
def df_sqrt(sh, sl):
    """Double-word square root of a non-negative double-word (sh, sl): the
    single-word root and one Newton step r' = r + (s - r^2) / (2r).  Zero
    gives (0, 0), not NaN."""
    tensor = isinstance(sh, torch.Tensor)
    r = torch.sqrt(sh) if tensor else np.sqrt(sh)
    r2h, r2e = two_prod(r, r)
    dh, dl = df_add(sh, sl, -r2h, -r2e)
    two = _const(r, 2.0)
    if tensor:
        corr = torch.where(r > 0, (dh + dl) / (two * torch.where(r > 0, r, 1.0)),
                           0.0)
    else:
        corr = (dh + dl) / (two * r) if r > 0 else _const(r, 0.0)
    return _quick_two_sum(r, corr)


@_counted
def df_norm(xh, xl):
    """Double-word 2-norm of a double-word vector: the square root of its
    double-word sum of squares.  An exactly zero vector gives (0, 0), so a
    breakdown test downstream sees a true zero."""
    ph, pe = df_mul(xh, xl, xh, xl)
    sh, sl = df_sum(ph, pe)
    return df_sqrt(sh, sl)
