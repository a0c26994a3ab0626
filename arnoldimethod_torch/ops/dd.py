"""Host double-double (DD) arithmetic for the dense restart layer.

The extended=True device path carries the Krylov basis as an unevaluated
hi+lo pair (ops/df_expansion.py).  With float32 words the combined value
fits a float64 exactly, so the host dense layer's f64 arithmetic sits
below the device noise floor and nothing more is needed.  With FLOAT64
words (CPU meshes) the pair is a 106-bit number: collapsing it to f64 for
the restart kernels floors the whole solve at ~1e-16 — the reference's
Double64 workflow (readme.md:81-105: tol=1e-28, 442 matvecs) needs the
dense layer itself to run past f64.

This module supplies that: a `DD` scalar type (a classical double-double
— value = hi + lo with |lo| <= ulp(hi)/2, eps ~ 4.9e-32, built on the
error-free transforms TwoSum / Fast2Sum / TwoProdFMA in host Python
floats, which CPython guarantees are IEEE doubles), numpy-object-array
pack/unpack helpers, and the few scalar functions (sqrt, hypot, copysign,
sign) the dense kernels need, dispatching between DD and plain floats.

The dense kernels (dense/schur.py, swaps.py, sylvester.py, restore.py,
rotations.py) are dtype-generic Python/numpy code; run on object arrays
of DD they produce a truncation matrix Q orthogonal to ~1e-32 — exactly
what the Krylov relation needs to certify residuals at 1e-28
(docs/precision.md; driver wiring in driver.py::_partial_schur).

Algorithms: standard double-double operation set (Dekker 1971; Hida,
Li & Bailey's QD library semantics for +, -, *, /, sqrt).  Host-only,
pure Python — never traced by JAX (the device twin is ops/df32.py).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "DD",
    "DD_EPS",
    "dd_pack",
    "dd_hi",
    "dd_lo",
    "dd_collapse",
    "dd_eye",
    "sqrt_",
    "hypot_",
    "copysign_",
    "sign_",
]

# Effective machine epsilon of the double-double format: 2^-104.
DD_EPS = 2.0 ** -104


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _fast_two_sum(a, b):
    # requires |a| >= |b|
    s = a + b
    err = b - (s - a)
    return s, err


_SPLIT = 134217729.0  # 2^27 + 1 (Dekker/Veltkamp splitting constant)


def _two_prod(a, b):
    # Dekker's error-free product (math.fma needs Python >= 3.13).
    # The Veltkamp split overflows only for |a| > ~1e300 — far outside
    # the O(1)-scaled dense matrices this layer sees.
    p = a * b
    c = _SPLIT * a
    ah = c - (c - a)
    al = a - ah
    c = _SPLIT * b
    bh = c - (c - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


class DD:
    """Double-double scalar: value = hi + lo, non-overlapping words.

    Closed under +, -, *, /, sqrt with ~eps^2 relative accuracy; mixing
    with int/float stays DD (floats are exact DDs); mixing with complex
    downcasts to complex (used only by the f64 estimate paths — the
    criterion evaluation, never the similarity transforms)."""

    __slots__ = ("hi", "lo")

    def __init__(self, hi, lo=0.0):
        self.hi = float(hi)
        self.lo = float(lo)

    # -- conversions ----------------------------------------------------
    def __float__(self):
        return self.hi + self.lo

    def __complex__(self):
        return complex(self.hi + self.lo)

    def __repr__(self):
        return f"DD({self.hi!r}, {self.lo!r})"

    def __bool__(self):
        return bool(self.hi != 0.0 or self.lo != 0.0)

    # numpy calls .conjugate()/.real/.imag on object-array elements.
    def conjugate(self):
        return self

    @property
    def real(self):
        return self

    @property
    def imag(self):
        return 0.0

    # -- arithmetic -----------------------------------------------------
    @staticmethod
    def _coerce(x):
        if isinstance(x, DD):
            return x
        if isinstance(x, (int, float, np.floating, np.integer)):
            return DD(float(x))
        return None

    def __add__(self, other):
        o = self._coerce(other)
        if o is None:
            if isinstance(other, (complex, np.complexfloating)):
                return complex(self) + complex(other)
            return NotImplemented
        # Accurate (QD ieee_add-style) sum: keeps relative accuracy
        # through cancellation, unlike the sloppy one-two_sum variant.
        s, e = _two_sum(self.hi, o.hi)
        t, f = _two_sum(self.lo, o.lo)
        e += t
        s, e = _fast_two_sum(s, e)
        e += f
        s, e = _fast_two_sum(s, e)
        return DD(s, e)

    __radd__ = __add__

    def __neg__(self):
        return DD(-self.hi, -self.lo)

    def __pos__(self):
        return self

    def __sub__(self, other):
        o = self._coerce(other)
        if o is None:
            if isinstance(other, (complex, np.complexfloating)):
                return complex(self) - complex(other)
            return NotImplemented
        return self.__add__(DD(-o.hi, -o.lo))

    def __rsub__(self, other):
        return (-self).__add__(other)

    def __mul__(self, other):
        o = self._coerce(other)
        if o is None:
            if isinstance(other, (complex, np.complexfloating)):
                return complex(self) * complex(other)
            return NotImplemented
        p, e = _two_prod(self.hi, o.hi)
        e += self.hi * o.lo + self.lo * o.hi
        p, e = _fast_two_sum(p, e)
        return DD(p, e)

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = self._coerce(other)
        if o is None:
            if isinstance(other, (complex, np.complexfloating)):
                return complex(self) / complex(other)
            return NotImplemented
        # Long division with one Newton correction (QD div semantics).
        q1 = self.hi / o.hi
        r = self.__sub__(o.__mul__(q1))
        q2 = (r.hi + r.lo) / o.hi
        q, e = _fast_two_sum(q1, q2)
        return DD(q, e)

    def __rtruediv__(self, other):
        o = self._coerce(other)
        if o is None:
            if isinstance(other, (complex, np.complexfloating)):
                return complex(other) / complex(self)
            return NotImplemented
        return o.__truediv__(self)

    def __pow__(self, k):
        if not isinstance(k, (int, np.integer)):
            return NotImplemented
        if k < 0:
            return DD(1.0).__truediv__(self.__pow__(-k))
        out = DD(1.0)
        base = self
        kk = int(k)
        while kk:
            if kk & 1:
                out = out * base
            base = base * base
            kk >>= 1
        return out

    def __abs__(self):
        return DD(-self.hi, -self.lo) if self.hi < 0 or (
            self.hi == 0 and self.lo < 0
        ) else self

    def sqrt(self):
        """Karp's dd sqrt: f64 seed + one Newton step in dd."""
        if self.hi == 0.0 and self.lo == 0.0:
            return DD(0.0)
        if self.hi < 0:
            raise ValueError("DD.sqrt of a negative value")
        x = 1.0 / math.sqrt(self.hi)
        ax = self.hi * x
        # ax + (self - ax^2) * x / 2
        p, e = _two_prod(ax, ax)
        d = self.__sub__(DD(p, e))
        return DD(ax).__add__(DD((d.hi + d.lo) * (x * 0.5)))

    # -- comparisons (total order on the exact value) --------------------
    def _cmp(self, other):
        o = self._coerce(other)
        if o is None:
            return NotImplemented
        if self.hi != o.hi:
            return -1 if self.hi < o.hi else 1
        if self.lo != o.lo:
            return -1 if self.lo < o.lo else 1
        return 0

    def __eq__(self, other):
        c = self._cmp(other)
        return NotImplemented if c is NotImplemented else c == 0

    def __ne__(self, other):
        c = self._cmp(other)
        return NotImplemented if c is NotImplemented else c != 0

    def __lt__(self, other):
        c = self._cmp(other)
        return NotImplemented if c is NotImplemented else c < 0

    def __le__(self, other):
        c = self._cmp(other)
        return NotImplemented if c is NotImplemented else c <= 0

    def __gt__(self, other):
        c = self._cmp(other)
        return NotImplemented if c is NotImplemented else c > 0

    def __ge__(self, other):
        c = self._cmp(other)
        return NotImplemented if c is NotImplemented else c >= 0

    def __hash__(self):
        return hash((self.hi, self.lo))


# -- array helpers -------------------------------------------------------


def dd_pack(hi, lo=None):
    """(hi, lo) float64 arrays -> object array of DD (elementwise)."""
    hi = np.asarray(hi, dtype=np.float64)
    lo = (
        np.zeros_like(hi)
        if lo is None
        else np.asarray(lo, dtype=np.float64)
    )
    out = np.empty(hi.shape, dtype=object)
    flat_h, flat_l, flat_o = hi.ravel(), lo.ravel(), out.ravel()
    for i in range(flat_h.size):
        flat_o[i] = DD(flat_h[i], flat_l[i])
    return out


def _word(x, which):
    if isinstance(x, DD):
        return x.hi if which == 0 else x.lo
    return float(x) if which == 0 else 0.0


def dd_hi(A):
    """Object DD array -> float64 array of hi words."""
    return np.vectorize(lambda x: _word(x, 0), otypes=[np.float64])(A)


def dd_lo(A):
    """Object DD array -> float64 array of lo words."""
    return np.vectorize(lambda x: _word(x, 1), otypes=[np.float64])(A)


def dd_collapse(A):
    """Object DD array -> float64 array of rounded values (hi + lo)."""
    return dd_hi(A) + dd_lo(A)


def dd_eye(n, m=None):
    """Identity as an object DD array."""
    return dd_pack(np.eye(n, m if m is not None else n))


# -- scalar compat functions (dense-kernel call sites) -------------------


def sqrt_(x):
    return x.sqrt() if isinstance(x, DD) else np.sqrt(x)


def hypot_(a, b):
    if isinstance(a, DD) or isinstance(b, DD):
        # |H| entries are O(1) in this solver: no overflow scaling needed.
        a = a if isinstance(a, DD) else DD(float(a))
        b = b if isinstance(b, DD) else DD(float(b))
        return (a * a + b * b).sqrt()
    return np.hypot(a, b)


def copysign_(a, b):
    if isinstance(a, DD) or isinstance(b, DD):
        neg = (b < 0) if not isinstance(b, DD) else b._cmp(0.0) < 0
        a = a if isinstance(a, DD) else DD(float(a))
        return -abs(a) if neg else abs(a)
    return np.copysign(a, b)


def sign_(x):
    if isinstance(x, DD):
        c = x._cmp(0.0)
        return float(c)
    return np.sign(x)
