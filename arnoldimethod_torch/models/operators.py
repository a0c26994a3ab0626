"""Linear operator protocol and the concrete operators: dense, the sparse
formats (DIA, CSR, padded ELL, bucketed ELL "SELL", block-sparse BSR), the
constant-coefficient 5-point stencil, and callables.

An operator exposes `shape`, `dtype` (a torch dtype), `device` and
`matvec(x)` on tensors, mirroring the reference's matrix-free
`mul!`/`eltype`/`size` protocol (run.jl:21-23).  Each operator holds its
tensors on one `device`: the one named, else a tensor input's own, else the
card (`_device.resolve`); the solver allocates its workspace there.
scipy.sparse input goes through `as_operator`, which repacks it into the
layout `pick_sparse_format` chooses (or the one `sparse_format=` names).

The shift-invert operators (dense LU, tridiagonal) sit here as in the JAX
package; the other spectral transforms are in `transforms.py`.

The split-complex operators (`SplitComplexOperator`,
`SplitComplexDenseOperator`) keep the JAX package's API: a complex matrix
held as real parts, with `matvec_sc(xr, xi) -> (yr, yi)`.  The card has
complex arithmetic, so the solver takes their complex `matvec`, which runs
the parts' own real matvecs (the stencil and BSR kernels among them).
Other complex matrices are native complex operators here.

`ShardedCsrOperator` and the other `RowShardedOperator`s (made by
`parallel.shard_operator`) take and return one rank's rows of a
row-sharded vector (`partial_schur(..., sharding=...)`).

Behavioral reference: arnoldimethod_tpu/models/operators.py.
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import torch
import torch.nn.functional as F

from .. import _device as _dev
from ..ops import bsr, df, df32, stencil
from ..workspace import as_torch_dtype

_LOG = logging.getLogger("arnoldimethod_torch")

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "DiaOperator",
    "EllOperator",
    "CsrOperator",
    "SellOperator",
    "BsrOperator",
    "RowShardedOperator",
    "ShardedCsrOperator",
    "Stencil5Operator",
    "FunctionOperator",
    "SplitComplexDenseOperator",
    "SplitComplexOperator",
    "ShiftInvertDenseOperator",
    "TridiagonalShiftInvertOperator",
    "as_operator",
    "csr_to_dia",
    "csr_to_ell",
    "dense_to_bsr",
    "dia_from_diagonals",
    "pick_sparse_format",
    "sell_from_csr",
]


def _device(device):
    """`device`, else the port's default, the card (`_device.resolve`)."""
    return _dev.resolve(device)


def _pick_device(device, a):
    """`device`, else the device of tensor `a`, else the card."""
    return _dev.resolve(device, like=a)


def _tensor(a, device, dtype=None):
    """A tensor on `device` (and of torch `dtype`, if given) from a tensor,
    or from a copy of anything numpy reads (an operator never shares
    memory with the caller's arrays)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device=device, dtype=dtype)


def _float_matrix(A, device):
    """A dense matrix as a floating (or complex) tensor on `device`, else
    on A's own device; integer input becomes float64."""
    A = _tensor(A, _pick_device(device, A))
    if not (A.is_floating_point() or A.is_complex()):
        A = A.to(torch.float64)
    return A


def _numpy(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _numpy_dtype(dtype):
    """The numpy dtype of a torch dtype, numpy dtype or dtype name."""
    return torch.empty(0, dtype=as_torch_dtype(dtype)).numpy().dtype


def _promote_with_shift(dtype, sigma):
    """The torch dtype of `dtype` combined with the shift `sigma` as the
    JAX package combines them: a Python scalar is weak (a float32 matrix
    with sigma=0.5 stays float32, a complex sigma makes it complex of the
    same width); a numpy or torch scalar or array keeps its own dtype."""
    # np.float64 subclasses float, yet it is strong: test numpy first.
    if (isinstance(sigma, (bool, int, float, complex))
            and not isinstance(sigma, np.generic)):
        return torch.result_type(torch.empty(0, dtype=dtype), sigma)
    if not isinstance(sigma, torch.Tensor):
        sigma = torch.from_numpy(np.asarray(sigma))
    return torch.promote_types(dtype, sigma.dtype)


def _solve_rhs(solve, x):
    """Apply a torch.linalg solve that needs a 2-D right-hand side to a
    vector or a matrix of columns."""
    if x.dim() == 1:
        return solve(x[:, None])[:, 0]
    return solve(x)


def _segment_sum(v, lengths):
    """Row sums of the CSR products `v` (nnz, ...) over consecutive segments
    of `lengths`: deterministic, in the order of the entries (no atomics)."""
    if v.is_complex():
        return torch.view_as_complex(torch.segment_reduce(
            torch.view_as_real(v), "sum", lengths=lengths, axis=0,
            unsafe=True))
    return torch.segment_reduce(v, "sum", lengths=lengths, axis=0, unsafe=True)


class LinearOperator:
    """Protocol base class.  Subclasses define `shape`, `dtype`, `device`
    and `matvec(x) -> y`."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device

    def matvec(self, x):
        raise NotImplementedError

    def matmat(self, X):
        """Block matvec A @ X for X of shape (n, K): K matvecs by default."""
        return torch.stack([self.matvec(X[:, k]) for k in range(X.shape[1])],
                           dim=1)

    def __matmul__(self, x):
        return self.matvec(x)


class DenseOperator(LinearOperator):
    """Dense matrix operator; the matvec is one GEMV."""

    def __init__(self, A, device=None):
        self.A = _tensor(A, _pick_device(device, A))
        self.shape = tuple(self.A.shape)
        self.dtype = self.A.dtype
        self.device = self.A.device

    def matvec(self, x):
        return torch.mv(self.A, x)


class DiaOperator(LinearOperator):
    """Sparse matrix in DIA (diagonal) format: `offsets` is a tuple of
    diagonal offsets, `diags` is (ndiag, n) with
    diags[d, i] = A[i, i + offsets[d]] (zero where out of range).  The
    matvec is ndiag multiply-adds on shifted views of a zero-padded x, the
    counterpart of the JAX package's XLA shifted FMAs."""

    def __init__(self, diags, offsets, shape, device=None):
        self.diags = _tensor(diags, _pick_device(device, diags))
        self.offsets = tuple(int(o) for o in offsets)
        self.shape = tuple(shape)
        self.dtype = self.diags.dtype
        self.device = self.diags.device

    @property
    def nnz(self):
        return int(self.diags.numel())

    def matvec(self, x):
        n = self.shape[0]
        lo = max(0, -min(self.offsets))
        hi = max(0, max(self.offsets))
        xp = F.pad(x, (lo, hi))
        y = self.diags[0] * xp[lo + self.offsets[0]: lo + self.offsets[0] + n]
        for d in range(1, len(self.offsets)):
            off = self.offsets[d]
            y = y + self.diags[d] * xp[lo + off: lo + off + n]
        return y

    def matvec_df(self, xh, xl):
        """Double-word matvec (yh, yl) = A (xh, xl): the same shifted
        products in double-word arithmetic (ops/df32.py), in plain torch
        ops as the JAX package runs them in XLA; the extended=True path's
        operator hook."""
        lo = max(0, -min(self.offsets))
        hi = max(0, max(self.offsets))
        return dia_matvec_df(self.diags, self.offsets, F.pad(xh, (lo, hi)),
                             F.pad(xl, (lo, hi)), lo)


def dia_matvec_df(diags, offsets, xph, xpl, lo):
    """DiaOperator.matvec_df's sum on a padded double-word x, `lo`
    entries before the rows' own (a sharded operator's halo or the
    global zero pad): df_scale of each diagonal's shifted read, df_add in
    the order of `offsets`; one output a row of `diags`."""
    n = diags.shape[1]
    yh = yl = None
    for d, off in enumerate(offsets):
        sl = slice(lo + off, lo + off + n)
        th, tl = df32.df_scale(xph[sl], xpl[sl], diags[d])
        yh, yl = (th, tl) if yh is None else df32.df_add(yh, yl, th, tl)
    return yh, yl


def _periodic_shifts(g):
    """The west, east, north and south reads of grid g on a torus."""
    return (torch.roll(g, 1, dims=1), torch.roll(g, -1, dims=1),
            torch.roll(g, 1, dims=0), torch.roll(g, -1, dims=0))


class Stencil5Operator(LinearOperator):
    """Constant-coefficient 5-point stencil on an (ny, nx) grid, acting on
    flattened row-major vectors of length n = ny*nx.

    coeffs: (center, west, east, north, south) scalars, real or complex
    (complex coefficients make a complex operator).  boundary: "dirichlet"
    (zero halo) or "periodic" (the shifts wrap: a 2-D circulant).

    matvec: a real Dirichlet stencil goes through `ops.stencil`, which on a
    CUDA tensor launches the hand-written kernel and on a CPU tensor runs
    its plain version.  Periodic and complex-coefficient stencils run plain
    torch ops (the JAX package sends them to XLA, not to Pallas).
    `use_pallas=False` asks for the plain torch ops; None (auto) and True
    take the kernel wherever it applies.
    """

    def __init__(self, coeffs, grid, dtype=torch.float32, use_pallas=None,
                 boundary="dirichlet", device=None):
        if boundary not in ("dirichlet", "periodic"):
            raise ValueError("boundary must be 'dirichlet' or 'periodic'")
        if use_pallas and boundary != "dirichlet":
            # The kernel assumes zero halos; honoring the request would
            # compute wrong wrap-around rows.
            raise ValueError(
                "use_pallas requires boundary='dirichlet' (the stencil "
                "kernel assumes zero halos); use use_pallas=None or False "
                "for periodic boundaries"
            )
        self.boundary = boundary
        cs = tuple(complex(c) for c in coeffs)
        self._complex_coeffs = any(c.imag != 0.0 for c in cs)
        self.coeffs = cs if self._complex_coeffs else tuple(c.real for c in cs)
        self.grid = (int(grid[0]), int(grid[1]))  # (ny, nx)
        n = self.grid[0] * self.grid[1]
        self.shape = (n, n)
        dt = as_torch_dtype(dtype)
        if self._complex_coeffs and not dt.is_complex:
            dt = torch.complex64 if dt == torch.float32 else torch.complex128
        self.dtype = dt
        self.device = _device(device)
        self.use_pallas = use_pallas

    @property
    def nnz(self):
        ny, nx = self.grid
        n = ny * nx
        if self.boundary == "periodic":
            return 5 * n
        # center everywhere; west/east miss one column; north/south one row.
        return n + 2 * ny * (nx - 1) + 2 * (ny - 1) * nx

    def _takes_kernel(self, x):
        """True when a step on x goes through `ops.stencil` (the kernel on
        a CUDA tensor): real x, Dirichlet boundary, use_pallas not False.
        ChebyshevFilterOperator asks the same to pick its fused step."""
        return (
            self.boundary == "dirichlet"
            and not x.is_complex()
            and self.use_pallas is not False
        )

    def matvec(self, x):
        ny, nx = self.grid
        if self._takes_kernel(x):
            return stencil.stencil5_matvec_sliding(
                x, coeffs=self.coeffs, grid=self.grid
            )
        if self.boundary == "dirichlet":
            return stencil.stencil5_plain(x, self.coeffs, self.grid)
        c, w, e, no, so = self.coeffs
        g = x.reshape(ny, nx)
        vw, ve, vn, vs = _periodic_shifts(g)
        y = c * g + w * vw + e * ve + no * vn + so * vs
        return y.reshape(ny * nx)

    def matvec_df(self, xh, xl):
        """Double-word stencil (yh, yl) = A (xh, xl) for real coefficients
        (the extended=True path's operator hook): df_scale of the center,
        then df_add of each scaled neighbour (west, east, north, south).
        A real Dirichlet stencil goes through `ops.df.stencil5_df` (the
        kernel on a CUDA tensor, its plain version on the CPU); a periodic
        one, or use_pallas=False, runs the plain version."""
        if self._complex_coeffs:
            raise ValueError("matvec_df needs real stencil coefficients")
        if self._takes_kernel(xh):
            return df.stencil5_df(xh, xl, self.coeffs, self.grid)
        shifts = (df.dirichlet_shifts if self.boundary == "dirichlet"
                  else _periodic_shifts)
        return df.stencil5_df_plain(xh, xl, self.coeffs, self.grid, shifts)


class FunctionOperator(LinearOperator):
    """Wrap a callable y = f(x) on tensors as an operator."""

    def __init__(self, f, n, dtype, device=None):
        self.f = f
        self.shape = (n, n)
        self.dtype = as_torch_dtype(dtype)
        self.device = _device(device)

    def matvec(self, x):
        return self.f(x)


def _split_matvec(re, im, xr, xi):
    """(yr, yi) = (Re + i Im)(xr + i xi) from the real matvecs `re` and
    `im` of the parts (either may be None, a zero part), in the JAX
    package's order: yr = Re xr - Im xi, yi = Re xi + Im xr."""
    yr = yi = None
    if re is not None:
        yr, yi = re(xr), re(xi)
    if im is not None:
        tr, ti = im(xi), im(xr)
        yr = -tr if yr is None else yr - tr
        yi = ti if yi is None else yi + ti
    return yr, yi


class _SplitComplexBase(LinearOperator):
    """A complex operator made of real words: subclasses define
    `matvec_sc(xr, xi) -> (yr, yi)`, `word_dtype` and the complex
    `dtype`."""

    def matvec(self, x):
        """Complex y = A x through `matvec_sc` on x's real and imaginary
        words."""
        if not x.is_complex():
            x = x.to(self.dtype)
        yr, yi = self.matvec_sc(x.real.to(self.word_dtype).contiguous(),
                                x.imag.to(self.word_dtype).contiguous())
        return torch.complex(yr, yi)


def _complex_of(word):
    return torch.complex64 if word == torch.float32 else torch.complex128


class SplitComplexDenseOperator(_SplitComplexBase):
    """A complex dense matrix held as its real words (Ar, Ai) of
    `word_dtype`.  `matvec_sc(xr, xi)` is four real GEMVs:
    yr = Ar xr - Ai xi, yi = Ar xi + Ai xr."""

    def __init__(self, A, word_dtype=torch.float32, device=None):
        A = _tensor(A, _pick_device(device, A))
        word = as_torch_dtype(word_dtype)
        self.Ar = A.real.to(word).contiguous()
        self.Ai = (A.imag.to(word).contiguous() if A.is_complex()
                   else torch.zeros_like(self.Ar))
        self.shape = tuple(A.shape)
        self.word_dtype = word
        self.dtype = _complex_of(word)
        self.device = A.device

    def matvec_sc(self, xr, xi):
        return _split_matvec(lambda x: torch.mv(self.Ar, x),
                             lambda x: torch.mv(self.Ai, x), xr, xi)


class SplitComplexOperator(_SplitComplexBase):
    """A complex sparse or matrix-free operator held as two real
    operators, A = re + i im, of any format; either part may be None (a
    zero part).  `matvec_sc(xr, xi)` is four real matvecs of the parts,
    two when one part is None, so each part's own kernel runs."""

    def __init__(self, re_op=None, im_op=None):
        if re_op is None and im_op is None:
            raise ValueError("need at least one of re_op / im_op")
        if re_op is not None and im_op is not None:
            if tuple(re_op.shape) != tuple(im_op.shape):
                raise ValueError(
                    "re/im parts disagree in shape: "
                    f"{tuple(re_op.shape)} vs {tuple(im_op.shape)}"
                )
            if re_op.dtype != im_op.dtype:
                raise ValueError(
                    "re/im parts disagree in word dtype: "
                    f"{re_op.dtype} vs {im_op.dtype}"
                )
        self.re = re_op
        self.im = im_op
        some = re_op if re_op is not None else im_op
        if some.dtype.is_complex:
            raise ValueError("the re/im parts must be REAL operators")
        self.shape = tuple(some.shape)
        self.word_dtype = some.dtype
        self.dtype = _complex_of(some.dtype)
        self.device = some.device

    @property
    def nnz(self):
        return sum(int(o.nnz) for o in (self.re, self.im) if o is not None)

    def matvec_sc(self, xr, xi):
        """(yr, yi) = A (xr + i xi):
        yr = Re(A) xr - Im(A) xi,  yi = Re(A) xi + Im(A) xr."""
        return _split_matvec(*(None if p is None else p.matvec
                               for p in (self.re, self.im)), xr, xi)


class ShiftInvertDenseOperator(LinearOperator):
    """Shift-invert spectral transform x -> (A - sigma*I)^{-1} x for a
    dense A, via an LU factorization computed once (two triangular solves
    per matvec, `torch.linalg.lu_solve`).  Eigenvalues transform as
    theta = 1 / (lambda - sigma); use `which='LM'` and map back
    lambda = sigma + 1/theta (ref: docs/src/index.md:234-303 shift-invert
    recipe).

    `lu` and `piv` are what `torch.linalg.lu_factor` returns: LAPACK's
    1-based pivots, where the JAX package holds 0-based ones
    (`convert.operator_from_arrays` adds 1)."""

    def __init__(self, lu, piv, sigma, shape):
        self.lu = lu
        self.piv = piv
        self.sigma = sigma
        self.shape = tuple(shape)
        self.dtype = lu.dtype
        self.device = lu.device

    @classmethod
    def build(cls, A, sigma, device=None):
        A = _float_matrix(A, device)
        dtype = _promote_with_shift(A.dtype, sigma)
        n = A.shape[0]
        B = A.to(dtype) - sigma * torch.eye(n, dtype=dtype, device=A.device)
        lu, piv = torch.linalg.lu_factor(B)
        return cls(lu, piv, sigma, A.shape)

    def matvec(self, x):
        return _solve_rhs(
            lambda rhs: torch.linalg.lu_solve(self.lu, self.piv, rhs), x)


class TridiagonalShiftInvertOperator(LinearOperator):
    """Shift-invert transform x -> (A - sigma*I)^{-1} x for a *tridiagonal*
    A, via a host-computed pivoted LU whose two triangular solves run on
    the operator's device as log-depth recurrences (ops/tridiag.py): the
    sparse factorization + ldiv! shift-invert of the reference's docs
    (docs/src/index.md:234-303) and benchmark
    (bench/partial_schur.jl:37-52).

    Eigenvalues transform as theta = 1/(lambda - sigma): solve with
    which='LM', map back lambda = sigma + 1/theta.

    `refine=True` (default when the solve dtype is narrower than float64)
    wraps each solve in one step of iterative refinement: the residual is
    recomputed from the shifted bands held in the *solve* dtype, which
    recovers most of the accuracy a float32 factorization loses for about
    twice the solve cost."""

    def __init__(self, factors, bands, sigma, shape, dtype, refine):
        self.factors = factors  # (l, swap, d0, du1, du2) tensors
        self.bands = bands  # (dl, d, du) of A - sigma*I, length-n padded
        self.sigma = sigma
        self.shape = tuple(shape)
        self.dtype = as_torch_dtype(dtype)
        self.device = factors[0].device
        self.refine = bool(refine)

    @classmethod
    def build(cls, dl, d, du, sigma=0.0, dtype=None, refine=None,
              device=None):
        """Factorize A - sigma*I on the host (float64, once) from the
        tridiagonal bands dl (n-1), d (n), du (n-1); the factors go to
        `device`."""
        from ..ops.tridiag import factor_tridiagonal

        dl, d, du = _numpy(dl), _numpy(d), _numpy(du)
        n = d.shape[0]
        if dtype is None:
            # Promote across all bands AND the shift, as the JAX package
            # does (numpy's rule: a Python float shift is float64).
            dtype = np.result_type(d.dtype, dl.dtype, du.dtype, type(sigma),
                                   np.float32)
        dtype = _numpy_dtype(dtype)
        if refine is None:
            refine = np.finfo(dtype).eps > np.finfo(np.float64).eps
        ds = d.astype(np.promote_types(d.dtype, np.float64)) - sigma
        fac = factor_tridiagonal(dl, ds, du)
        dev = _device(device)
        factors = tuple(
            _tensor(a if a.dtype == bool else a.astype(dtype), dev)
            for a in fac.arrays()
        )
        pad = np.zeros(1, dtype=ds.dtype)
        bands = tuple(
            _tensor(a.astype(dtype), dev)
            for a in (
                np.concatenate([np.asarray(dl, ds.dtype), pad]),
                ds,
                np.concatenate([np.asarray(du, ds.dtype), pad]),
            )
        )
        return cls(factors, bands, sigma, (n, n), dtype, refine)

    @classmethod
    def from_operator(cls, op, sigma=0.0, dtype=None, refine=None):
        """Build from a DiaOperator whose offsets are within {-1, 0, 1},
        on the operator's device, or from a SplitComplexOperator over two
        such parts (recombined into complex bands, as the JAX package
        does).  A complex DiaOperator (what `dia_from_diagonals` returns
        for complex values) gives complex factors: complex64 from
        complex64 diagonals, else complex128; a split pair likewise from
        its word."""
        if isinstance(op, SplitComplexOperator):
            return cls._from_split(op, sigma, dtype, refine)
        if not isinstance(op, DiaOperator):
            raise TypeError("from_operator expects a DiaOperator")
        if not set(op.offsets) <= {-1, 0, 1}:
            raise ValueError("operator is not tridiagonal")
        if dtype is None and op.dtype.is_complex:
            dtype = (np.complex64 if op.dtype == torch.complex64
                     else np.complex128)
        n = op.shape[0]
        host = _numpy(op.diags)
        diags = {o: host[i] for i, o in enumerate(op.offsets)}
        zero = np.zeros(n, dtype=host.dtype)
        # diags[d, i] = A[i, i + offset]: entry j of offset -1 multiplies
        # x[j-1] on row j, so dl[j-1] = diags[-1][j].
        dl = diags.get(-1, zero)[1:]
        d = diags.get(0, zero)
        du = diags.get(1, zero)[:-1]
        return cls.build(dl, d, du, sigma=sigma, dtype=dtype, refine=refine,
                         device=op.device)

    @classmethod
    def _from_split(cls, op, sigma, dtype, refine):
        parts = [(p, unit) for p, unit in ((op.re, 1.0), (op.im, 1.0j))
                 if p is not None]
        if not all(isinstance(p, DiaOperator) for p, _ in parts):
            raise TypeError(
                "from_operator expects DiaOperator split-complex parts")
        if not {o for p, _ in parts for o in p.offsets} <= {-1, 0, 1}:
            raise ValueError("operator is not tridiagonal")
        n = op.shape[0]
        bands = {o: np.zeros(n, dtype=np.complex128) for o in (-1, 0, 1)}
        for part, unit in parts:
            host = _numpy(part.diags)
            for i, o in enumerate(part.offsets):
                bands[o] += unit * host[i]
        if dtype is None:
            dtype = (np.complex64 if op.word_dtype == torch.float32
                     else np.complex128)
        return cls.build(bands[-1][1:], bands[0], bands[1][:-1], sigma=sigma,
                         dtype=dtype, refine=refine, device=op.device)

    def _shifted_matvec(self, x):
        dl, d, du = self.bands
        lower = torch.cat([x[:1] * 0, dl[:-1] * x[:-1]])
        upper = torch.cat([du[:-1] * x[1:], x[:1] * 0])
        return d * x + lower + upper

    def matvec(self, b):
        from ..ops.tridiag import tridiag_lu_solve

        x = tridiag_lu_solve(*self.factors, b)
        if not self.refine:
            return x
        # One iterative-refinement step; the residual is 5 elementwise ops.
        r = b - self._shifted_matvec(x)
        return x + tridiag_lu_solve(*self.factors, r)


class EllOperator(LinearOperator):
    """Sparse matrix in padded ELL format: `data` (n, K) holds up to K
    nonzeros per row (zero-padded), `cols` (n, K) their column indices
    (pad entries point at column 0 with zero data).  The matvec is one
    gather of x and a sum along each row.  CSR input converts through
    `csr_to_ell`."""

    def __init__(self, data, cols, shape, device=None):
        dev = _pick_device(device, data)
        self.data = _tensor(data, dev)
        self.cols = _tensor(cols, dev, torch.int64)
        self.shape = tuple(shape)
        self.dtype = self.data.dtype
        self.device = dev

    @property
    def nnz(self):
        return int(self.data.numel())

    def matvec(self, x):
        return (self.data * x[self.cols]).sum(dim=1)


class CsrOperator(LinearOperator):
    """Sparse matrix kept in CSR.  The matvec gathers x at the column
    indices, multiplies by the data and sums each row's run of products
    over the precomputed row lengths: a segment sum taken in entry order,
    so it is deterministic on the card as on the CPU (no atomics).  This
    is the JAX package's gather + `segment_sum`.  `to_ell`, `to_sell` and
    `to_bsr` repack the matrix."""

    def __init__(self, indptr, indices, data, shape, device=None):
        dev = _pick_device(device, data)
        indptr = _numpy(indptr).astype(np.int64)
        self.indptr = _tensor(indptr, dev)
        self.indices = _tensor(indices, dev, torch.int64)
        self.data = _tensor(data, dev)
        self.lengths = _tensor(np.diff(indptr), dev)
        self.shape = tuple(shape)
        self.dtype = self.data.dtype
        self.device = dev

    @property
    def nnz(self):
        return int(self.data.numel())

    def matvec(self, x):
        return _segment_sum(self.data * x[self.indices], self.lengths)

    def matmat(self, X):
        """Block SpMM: one gather of a K-wide row of X per nonzero, then
        the same segment sum over the rows."""
        return _segment_sum(self.data[:, None] * X[self.indices], self.lengths)

    def _host(self):
        return (_numpy(self.indptr), _numpy(self.indices), _numpy(self.data))

    def to_ell(self):
        """The padded-ELL version of this matrix."""
        return csr_to_ell(*self._host(), self.shape, device=self.device)

    def to_sell(self):
        """The bucketed-ELL version (bounded padding for irregular row
        lengths; see SellOperator)."""
        return sell_from_csr(*self._host(), self.shape, device=self.device)

    def to_bsr(self, block_size=128, use_pallas=None):
        """Re-block this matrix into a BsrOperator: every (block_size x
        block_size) block holding at least one nonzero is stored densely.
        The operator reports its zero-fill as `fill_ratio` = stored / true
        nonzeros and keeps the true (n, n) shape (its matvec pads x when n
        is not a block multiple)."""
        indptr, indices, data = self._host()
        n = self.shape[0]
        B = block_size
        nb = -(-n // B)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        br, bc = rows // B, indices // B
        # Unique nonzero blocks, sorted by (block-row, block column): the
        # blocks of a block-row are consecutive, and a block's slot is its
        # rank among them.
        uniq, inv = np.unique(br * nb + bc, return_inverse=True)
        ubr, ubc = uniq // nb, uniq % nb
        KB = max(1, int(np.bincount(ubr, minlength=nb).max()))
        slot_of = np.arange(uniq.size) - np.searchsorted(ubr, ubr)
        block_cols = np.zeros((nb, KB), dtype=np.int32)
        block_cols[ubr, slot_of] = ubc
        block_data = np.zeros((nb, KB, B, B), dtype=data.dtype)
        np.add.at(block_data, (br, slot_of[inv], rows % B, indices % B), data)
        op = BsrOperator(block_cols, block_data, (n, n),
                         use_pallas=use_pallas, device=self.device)
        op.fill_ratio = op.nnz / max(1, data.size)
        return op


class SellOperator(LinearOperator):
    """Bucketed ELL ("SELL"): rows grouped by their nonzero count rounded
    up to a power of two, each bucket an exact little ELL block, so padding
    stays under 2x the nonzeros for any row-length distribution.  The
    matvec is one gather-and-row-sum per bucket and one inverse-permutation
    gather that puts the rows back in order.  Built from CSR with
    `CsrOperator.to_sell()` / `sell_from_csr`."""

    def __init__(self, buckets, inv_perm, shape, nnz_true, device=None):
        # buckets: (data (r_b, K_b), cols (r_b, K_b)) pairs.
        dev = _pick_device(device, buckets[0][0])
        self.buckets = tuple(
            (_tensor(d, dev), _tensor(c, dev, torch.int64)) for d, c in buckets
        )
        self.inv_perm = _tensor(inv_perm, dev, torch.int64)
        self.shape = tuple(shape)
        self.dtype = self.buckets[0][0].dtype
        self.device = dev
        self._nnz_true = int(nnz_true)

    @property
    def nnz(self):
        return self._nnz_true

    @property
    def nnz_stored(self):
        return int(sum(d.numel() for d, _ in self.buckets))

    def matvec(self, x):
        parts = [(d * x[c]).sum(dim=1) for d, c in self.buckets]
        return torch.cat(parts)[self.inv_perm]

    def matmat(self, X):
        """Block SpMM: one gather of a K-wide row of X per stored entry."""
        parts = [(d[:, :, None] * X[c]).sum(dim=1) for d, c in self.buckets]
        return torch.cat(parts)[self.inv_perm]


def sell_from_csr(indptr, indices, data, shape, dtype=None, device=None):
    """Build a SellOperator from host CSR arrays (one host pass)."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    data = np.asarray(data, dtype=dtype)
    n = shape[0]
    row_nnz = np.diff(indptr).astype(np.int64)
    # Bucket width: the row length rounded up to a power of two (empty rows
    # go to the width-1 bucket with zero data, so every row is kept).
    widths = np.maximum(row_nnz, 1)
    bucket_k = 1 << np.ceil(np.log2(widths)).astype(np.int64)
    order = np.argsort(bucket_k, kind="stable")
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[order] = np.arange(n)

    # The masked gathers below index data and indices even where the mask
    # is off, which needs one addressable entry when there are no nonzeros.
    data_ix = data if data.size else np.zeros(1, dtype=data.dtype)
    cols_ix = indices if indices.size else np.zeros(1, dtype=np.int64)

    buckets = []
    sorted_k = bucket_k[order]
    start = 0
    while start < n:
        K = int(sorted_k[start])
        stop = int(np.searchsorted(sorted_k, K, side="right"))
        rows = order[start:stop]
        slot = np.arange(K, dtype=np.int64)[None, :]
        valid = slot < row_nnz[rows][:, None]
        idx = np.where(valid, indptr[rows][:, None] + slot, 0)
        bdata = np.where(valid, data_ix[idx], 0).astype(data.dtype)
        bcols = np.where(valid, cols_ix[idx], 0).astype(np.int32)
        buckets.append((bdata, bcols))
        start = stop
    return SellOperator(buckets, inv_perm, shape, data.size, device=device)


class BsrOperator(LinearOperator):
    """Block-sparse rows (block-level ELL): dense (B, B) blocks, up to KB
    per block-row; the general-sparse format for clustered patterns.

    The operands are packed once, at construction (`ops.bsr.pack_bsr`: nbr
    padded to a multiple of 8, KB to a multiple of min(8, KB), each block
    transposed), the layout the JAX package's operator holds.  Block
    columns are checked against the shape here, once, not per matvec.  The
    matvec zero-pads x when n is not a block multiple and slices y back to
    n.  `use_pallas` None or True: a CUDA tensor launches the hand-written
    BSR kernel, a CPU tensor takes its plain version; False: the plain
    version everywhere.  The card has no counterpart of the TPU kernel's
    VMEM cap, so no size makes True raise.

    Complex blocks are held as packed real and imaginary words (the
    imaginary word is None when every imaginary part is zero).  Unless
    use_pallas=False, the matvec runs the real matvec on the words as the
    JAX package's `SplitComplexOperator.matvec_sc` does, in its order:
    yr = Ar xr - Ai xi, yi = Ar xi + Ai xr (two launches without Ai)."""

    def __init__(self, block_cols, block_data, shape, use_pallas=None,
                 device=None):
        cols, dataT = bsr.pack_bsr(_numpy(block_cols), _numpy(block_data))
        self._set_packed(cols, dataT, np.shape(block_data)[:2], shape,
                         use_pallas, _pick_device(device, block_data))

    @classmethod
    def from_packed(cls, block_cols, block_dataT, logical_blocks, shape,
                    use_pallas=None, device=None):
        """An operator over operands that `pack_bsr` already packed (the
        JAX BsrOperator's `block_cols` and `block_dataT`, for one)."""
        obj = object.__new__(cls)
        obj._set_packed(_numpy(block_cols), block_dataT, logical_blocks,
                        shape, use_pallas, _pick_device(device, block_dataT))
        return obj

    def _set_packed(self, cols, dataT, logical_blocks, shape, use_pallas,
                    device):
        B = int(dataT.shape[-1])
        nbc = -(-int(shape[0]) // B)
        if cols.size and (cols.min() < 0 or cols.max() >= nbc):
            raise ValueError(
                f"block columns must lie in [0, {nbc}) for shape "
                f"{tuple(shape)} and block size {B}"
            )
        self.block_cols = _tensor(cols, device, torch.int32)
        data = _tensor(dataT, device)
        if data.is_complex():
            im = data.imag.contiguous() if bool(data.imag.any()) else None
            self.words = (data.real.contiguous(), im)
        else:
            self.words = (data, None)
        self.logical_blocks = tuple(int(v) for v in logical_blocks)
        self.shape = tuple(shape)
        self.dtype = data.dtype
        self.device = device
        self.use_pallas = use_pallas

    @property
    def block_dataT(self):
        """The packed blocks: the stored tensor for real blocks, a complex
        tensor made from the two words for complex ones."""
        re, im = self.words
        if not self.dtype.is_complex:
            return re
        return torch.complex(re, torch.zeros_like(re) if im is None else im)

    @property
    def block_size(self):
        return int(self.words[0].shape[-1])

    @property
    def block_data(self):
        """Blocks in natural orientation (a transposed view of the packed
        storage, logical slots only)."""
        nbr, KB = self.logical_blocks
        return self.block_dataT[:nbr, :KB].transpose(2, 3)

    @property
    def nnz(self):
        nbr, KB = self.logical_blocks
        return int(nbr * KB * self.block_size ** 2)

    def matvec(self, x):
        B = self.block_size
        n = self.shape[0]
        nbc = -(-n // B)
        if x.shape[0] != nbc * B:  # n not a block multiple: zero-pad x
            x = F.pad(x, (0, nbc * B - x.shape[0]))
        x = x.contiguous()
        if self.use_pallas is False:
            y = bsr.bsr_plain(self.block_cols, self.block_dataT, x)
        elif self.dtype.is_complex:
            y = self._matvec_split(x.to(self.dtype))
        else:
            y = self._word_matvec(self.words[0], x)
        return y[:n]

    def _word_matvec(self, word, x):
        return bsr.bsr_matvec(self.block_cols, word, x, self.logical_blocks)

    def _matvec_split(self, x):
        """Complex y from the real matvec on the words (matvec_sc's order)."""
        re, im = (None if w is None else functools.partial(
            self._word_matvec, w) for w in self.words)
        return torch.complex(*_split_matvec(
            re, im, x.real.contiguous(), x.imag.contiguous()))


class RowShardedOperator(LinearOperator):
    """An operator over a row-sharded vector (`sharding=` solves): `matvec`
    takes this rank's n/P entries of x and returns this rank's rows of
    A x.  `comm` (a `parallel.comm.RowComm`) is the partition; `shape` is
    the global one.  `parallel.shard_operator` makes them."""

    comm = None


def _row_lengths(rows, n_local, device):
    """Segment lengths of sorted local row ids (padding included)."""
    return _tensor(np.bincount(rows, minlength=n_local), device)


class ShardedCsrOperator(RowShardedOperator):
    """Row-partitioned general-sparse operator over a 1-D `rows` mesh, the
    JAX package's layout for irregular row lengths (ref:
    arnoldimethod_tpu/models/operators.py::ShardedCsrOperator).

    Rows split into mesh-size contiguous, equal chunks; each chunk's
    nonzeros stored flat in CSR order and padded to the largest chunk's
    count, the padding zero data pointing at the chunk's last row.  Each
    rank holds its own chunk; `build` computes every rank's arrays as JAX
    does (`arrs` keeps this rank's row of each) and two gather strategies:

    * gather="footprint": the unique x entries each (dest, source) pair of
      ranks needs were found at build time (`send_idx`, this rank's table of
      what it sends each rank, `footprint_elems` a rank); the matvec sends
      them in one all_to_all_single, in flight while the sum over the
      columns this rank owns runs, then adds the remote columns' sum, in
      JAX's order y_local + y_remote.
    * gather="all": one all-gather of x, then the sum.

    gather="auto" (the default) takes footprint iff its padded receive
    volume is at most half of the all-gather's, (P - 1) F <= (n - n/P) // 2.
    The sums are the port's CSR segment sum (JAX's XLA segment_sum)."""

    def __init__(self, arrs, shape, mesh, mode="all", device=None):
        """arrs: JAX's arrays of every rank, numpy (P, ...): mode "all"
        (rows, cols, data); mode "footprint" (rows_l, cols_l, vals_l,
        rows_r, cols_r, vals_r, send_idx).  Keeps this rank's row of each
        on `device` (the mesh's device type by default).  Use `build`."""
        from ..parallel.comm import RowComm  # parallel/ imports this module

        if mode not in ("all", "footprint"):
            raise ValueError(f"mode must be 'all' or 'footprint', got {mode!r}")
        arrs = [np.asarray(a) for a in arrs]
        self.shape = tuple(int(s) for s in shape)
        self.comm = comm = RowComm(mesh, self.shape[0])
        self.mesh, self.mode = mesh, mode
        dev = torch.device(device if device is not None else mesh.device_type)
        self.device = dev
        # JAX's nnz: the stored (padded) entries over every rank.
        self.nnz = int(arrs[2].size + (arrs[5].size if mode == "footprint" else 0))
        mine = [a[comm.rank] for a in arrs]
        n_local, p, d = comm.n_local, comm.size, comm.rank

        def put(a):
            return _tensor(a, dev, torch.int64 if a.dtype.kind in "iu" else None)

        self.arrs = tuple(put(a) for a in mine)
        self.dtype = self.arrs[2].dtype
        self._lengths = _row_lengths(mine[0], n_local, dev)
        if mode == "all":
            return
        rr, cr, send = mine[3], mine[4].astype(np.int64), mine[6]
        F_ = send.shape[-1]
        # JAX's remote columns index the receive buffers in round order
        # (round r brings rank (d - r) mod P's entries); all_to_all_single
        # delivers them in rank order, skipping d.
        s = (d - (cr // F_ + 1)) % p
        self._cr = put(np.where(s < d, s, s - 1) * F_ + cr % F_)
        self._lengths_r = _row_lengths(rr, n_local, dev)
        self._send = torch.cat([self.arrs[6][t] for t in range(p) if t != d])
        self._splits = [0 if t == d else F_ for t in range(p)]

    @property
    def send_idx(self):
        """This rank's footprint table (P, F): the local x entries it sends
        each rank (its row of JAX's send_idx); None on the all-gather path."""
        return self.arrs[6] if self.mode == "footprint" else None

    @property
    def footprint_elems(self):
        """Per-rank per-source receive size (0 on the all-gather path)."""
        return 0 if self.send_idx is None else int(self.send_idx.shape[-1])

    @classmethod
    def build(cls, indptr, indices, data, shape, mesh, dtype=None,
              gather="auto", device=None):
        """Partition host CSR arrays over `mesh` (every rank builds the same
        arrays, host-side, JAX's pass for pass, and keeps its own).

        gather: "footprint" | "all" | "auto" (see the class docstring)."""
        from ..parallel.comm import RowComm  # parallel/ imports this module

        indptr = _numpy(indptr).astype(np.int64)
        indices = _numpy(indices).astype(np.int64)
        data = _numpy(data)
        data = data.astype(_numpy_dtype(dtype) if dtype is not None else data.dtype)
        n = int(shape[0])
        ndev = RowComm(mesh, n).size  # raises unless n divides evenly
        n_local = n // ndev
        row_nnz = np.diff(indptr)
        chunk_nnz = np.array([
            int(indptr[(r + 1) * n_local] - indptr[r * n_local])
            for r in range(ndev)
        ])
        nnz_pad = max(1, int(chunk_nnz.max()))
        rows = np.full((ndev, nnz_pad), n_local - 1, dtype=np.int32)
        cols = np.zeros((ndev, nnz_pad), dtype=np.int32)
        vals = np.zeros((ndev, nnz_pad), dtype=data.dtype)
        for r in range(ndev):
            lo, hi = indptr[r * n_local], indptr[(r + 1) * n_local]
            k = hi - lo
            rows[r, :k] = np.repeat(
                np.arange(n_local, dtype=np.int32),
                row_nnz[r * n_local:(r + 1) * n_local],
            )
            cols[r, :k] = indices[lo:hi]
            vals[r, :k] = data[lo:hi]

        mode = gather
        if mode not in ("auto", "all", "footprint"):
            raise ValueError(
                f"gather must be 'auto', 'all' or 'footprint', got {gather!r}")
        if mode == "footprint" and ndev == 1:
            # One rank has no remote shards: there is no footprint to
            # gather, and a silent "all" would make `mode` lie.
            raise ValueError(
                "gather='footprint' requires a mesh with >= 2 devices; "
                "use gather='auto' (or 'all') on a single-device mesh"
            )
        if mode != "all" and ndev > 1:
            # fps[d][s]: the sorted unique global columns of dest shard d
            # that live in source shard s.
            fps = [[None] * ndev for _ in range(ndev)]
            F_ = 1
            for d in range(ndev):
                lo, hi = indptr[d * n_local], indptr[(d + 1) * n_local]
                cu = np.unique(indices[lo:hi])
                src = cu // n_local
                for s in range(ndev):
                    if s != d:
                        fps[d][s] = cu[src == s]
                        F_ = max(F_, len(fps[d][s]))
            if mode == "auto":
                mode = ("footprint" if (ndev - 1) * F_ <= (n - n_local) // 2
                        else "all")
            if mode == "footprint":
                send_idx = np.zeros((ndev, ndev, F_), dtype=np.int32)
                for d in range(ndev):
                    for s in range(ndev):
                        if s != d:
                            f = fps[d][s]
                            send_idx[s, d, :len(f)] = f - s * n_local
                # Local part (columns in the own shard) and remote part
                # (columns re-based into the receive buffers in JAX's round
                # order: round r delivers source (d - r) mod ndev).
                parts = {"l": [], "r": []}
                for d in range(ndev):
                    lo, hi = indptr[d * n_local], indptr[(d + 1) * n_local]
                    cg = indices[lo:hi]
                    rg = np.repeat(np.arange(n_local, dtype=np.int32),
                                   row_nnz[d * n_local:(d + 1) * n_local])
                    vg = data[lo:hi]
                    src = cg // n_local
                    is_loc = src == d
                    out = np.zeros(len(cg), dtype=np.int64)
                    out[is_loc] = cg[is_loc] - d * n_local
                    for s in range(ndev):
                        sel = src == s
                        if s == d or not sel.any():
                            continue
                        off = (((d - s) % ndev) - 1) * F_
                        out[sel] = off + np.searchsorted(fps[d][s], cg[sel])
                    parts["l"].append((rg[is_loc], out[is_loc], vg[is_loc]))
                    parts["r"].append((rg[~is_loc], out[~is_loc], vg[~is_loc]))

                def pad_part(triples):
                    kmax = max(1, max(len(t[0]) for t in triples))
                    pr = np.full((ndev, kmax), n_local - 1, dtype=np.int32)
                    pc = np.zeros((ndev, kmax), dtype=np.int32)
                    pv = np.zeros((ndev, kmax), dtype=data.dtype)
                    for d, (r_, c_, v_) in enumerate(triples):
                        pr[d, :len(r_)] = r_
                        pc[d, :len(c_)] = c_
                        pv[d, :len(v_)] = v_
                    return pr, pc, pv

                arrs = (*pad_part(parts["l"]), *pad_part(parts["r"]), send_idx)
                return cls(arrs, shape, mesh, mode="footprint", device=device)
        return cls((rows, cols, vals), shape, mesh, mode="all", device=device)

    def matvec(self, x):
        comm = self.comm
        if self.mode == "all":
            rows, cols, vals = self.arrs
            return _segment_sum(vals * comm.gather_rows(x)[cols], self._lengths)
        _, cl, vl, _, _, vr, _ = self.arrs
        # The exchange first; the local sum needs none of it and runs while
        # it is in flight.
        recv, work = comm.exchange(x[self._send], self._splits, self._splits)
        y = _segment_sum(vl * x[cl], self._lengths)
        work.wait()
        return y + _segment_sum(vr * recv[self._cr], self._lengths_r)


def dense_to_bsr(A, block_size=128, use_pallas=None, device=None):
    """Convert a dense matrix to a BsrOperator keeping only its nonzero
    blocks (host-side; n must be a multiple of block_size)."""
    A = _numpy(A)
    n = A.shape[0]
    B = block_size
    if n % B:
        raise ValueError(f"n ({n}) must be a multiple of block_size ({B})")
    nb = n // B
    blocks = A.reshape(nb, B, nb, B).transpose(0, 2, 1, 3)
    nz = np.abs(blocks).sum(axis=(2, 3)) != 0
    KB = max(1, int(nz.sum(axis=1).max()))
    block_cols = np.zeros((nb, KB), dtype=np.int32)
    block_data = np.zeros((nb, KB, B, B), dtype=A.dtype)
    for i in range(nb):
        cols = np.nonzero(nz[i])[0]
        block_cols[i, : len(cols)] = cols
        block_data[i, : len(cols)] = blocks[i, cols]
    return BsrOperator(block_cols, block_data, A.shape, use_pallas=use_pallas,
                       device=device)


def csr_to_ell(indptr, indices, data, shape, dtype=None, device=None):
    """Convert CSR arrays to the padded ELL layout (host-side)."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    data = np.asarray(data)
    n = shape[0]
    row_nnz = np.diff(indptr)
    K = max(1, int(row_nnz.max()))
    ell_data = np.zeros((n, K), dtype=dtype or data.dtype)
    ell_cols = np.zeros((n, K), dtype=np.int32)
    rows = np.repeat(np.arange(n), row_nnz)
    entry = np.arange(indptr[0], indptr[-1])
    slot = entry - indptr[rows]
    ell_data[rows, slot] = data[entry]
    ell_cols[rows, slot] = indices[entry]
    return EllOperator(ell_data, ell_cols, shape, device=device)


def csr_to_dia(indptr, indices, data, shape, device=None):
    """Exact DIA repack of a canonical CSR triple (unique, sorted column
    indices per row, as scipy's tocsr() gives)."""
    n = int(shape[0])
    indptr = np.asarray(indptr)
    indices = np.asarray(indices, dtype=np.int64)
    data = np.asarray(data)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    offs, inv = np.unique(indices - rows, return_inverse=True)
    diags = np.zeros((offs.size, n), dtype=data.dtype)
    diags[inv, rows] = data
    return DiaOperator(diags, [int(o) for o in offs], shape, device=device)


def dia_from_diagonals(diagonals, shape, dtype=None, device=None):
    """Build a DiaOperator from {offset: values}: values may be a scalar
    (constant diagonal) or an array of length n; entry i of the diagonal at
    `offset` multiplies x[i + offset] in row i.  Out-of-range positions are
    zeroed.

    Complex values (or a complex `dtype`) give a native complex operator:
    complex64 for a complex64 or float32 request (the float32 words of the
    JAX package's split-complex operator), complex128 otherwise."""
    offsets = sorted(diagonals)
    n = shape[0]
    values_complex = any(
        np.iscomplexobj(np.asarray(v)) for v in diagonals.values()
    )
    if dtype is None:
        dtype = np.complex128 if values_complex else np.float64
    dtype = _numpy_dtype(dtype)
    if values_complex or dtype.kind == "c":
        dtype = np.dtype(
            np.complex64
            if dtype in (np.dtype("complex64"), np.dtype("float32"))
            else np.complex128
        )
    diags = np.zeros((len(offsets), n), dtype=dtype)
    for d, off in enumerate(offsets):
        diags[d, :] = diagonals[off]
        if off > 0:
            diags[d, n - off :] = 0
        elif off < 0:
            diags[d, :-off] = 0
    return DiaOperator(diags, offsets, shape, device=device)


def pick_sparse_format(indptr, indices, shape, block_size=128):
    """Choose a layout for a CSR sparsity pattern: the JAX package's rule,
    unchanged, so both packages pick the same format.

      dia   banded: <= 32 distinct diagonals covering the pattern with
            <= 4x storage fill;
      bsr   clustered: block_size-square blocking fills <= 16x and the
            block data stays under ~2 GB;
      sell  everything else.

    The thresholds encode the TPU's measured costs (the JAX package's
    docs/sparse.md); deciding them again from H100 measurements is queued
    work.  Returns (format_name, info_dict).  Host-side numpy over the
    index arrays only (no matrix data touched).
    """
    n = int(shape[0])
    indptr = np.asarray(indptr)
    indices = np.asarray(indices, dtype=np.int64)
    nnz = int(indices.size)
    if nnz == 0:
        return "sell", {"reason": "empty"}
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    ndiag = int(np.unique(indices - rows).size)
    if ndiag <= 32 and ndiag * n <= 4 * nnz:
        return "dia", {"ndiag": ndiag}
    B = int(block_size)
    nb = -(-n // B)
    nblocks = int(np.unique((rows // B) * nb + indices // B).size)
    fill = nblocks * B * B / nnz
    if fill <= 16 and nblocks * B * B * 8 <= (2 << 30):
        return "bsr", {"fill": round(float(fill), 2)}
    return "sell", {"bsr_fill": round(float(fill), 2)}


SPARSE_FORMATS = ("auto", "csr", "dia", "bsr", "sell", "ell")


def _format_csr(indptr, indices, data, shape, sparse_format, block_size=128,
                device=None):
    """The operator of the requested (or auto-selected) layout for a host
    CSR triple."""
    fmt = sparse_format
    if fmt in (None, "auto"):
        fmt, info = pick_sparse_format(indptr, indices, shape, block_size)
        _LOG.info(
            "as_operator: sparse format auto-selected -> %s %s "
            "(override with sparse_format=)", fmt, info,
        )
    if fmt not in SPARSE_FORMATS[1:]:
        raise ValueError(
            f"unknown sparse_format {fmt!r}: expected one of "
            + ", ".join(repr(f) for f in SPARSE_FORMATS)
        )
    if fmt == "dia":
        return csr_to_dia(indptr, indices, data, shape, device=device)
    csr = CsrOperator(indptr, indices, data, shape, device=device)
    if fmt == "bsr":
        return csr.to_bsr(block_size)
    if fmt == "sell":
        return csr.to_sell()
    if fmt == "ell":
        return csr.to_ell()
    return csr


def as_operator(A, n=None, dtype=None, device=None, sparse_format="auto"):
    """Coerce A (operator, 2-D array or tensor, scipy.sparse matrix, or
    callable) to a LinearOperator on `device`.

    scipy.sparse input is repacked into the layout `pick_sparse_format`
    chooses for its pattern (DIA for banded, BSR for clustered, SELL
    otherwise); `sparse_format` overrides it: 'csr' keeps the CSR gather +
    segment-sum path, or name a layout ('dia', 'bsr', 'sell', 'ell').
    Duplicate entries are summed first.  Integer/bool matrices, dense or
    sparse, solve in float64 (vtype promotion, run.jl:9-12); complex ones
    stay native complex."""
    if isinstance(A, LinearOperator):
        return A
    # scipy.sparse duck typing: anything with .tocsr() and a shape.
    if hasattr(A, "tocsr") and hasattr(A, "shape"):
        if A.shape[0] != A.shape[1]:
            raise ValueError(
                f"matrix is not square: dimensions are {tuple(A.shape)}"
            )
        csr = A.tocsr()
        if not getattr(csr, "has_canonical_format", True):
            # Duplicate (row, col) entries: the CSR, ELL, SELL and BSR
            # layouts sum them but csr_to_dia's scatter would keep one, so
            # make the triple canonical (on a copy: sum_duplicates mutates).
            csr = csr.copy()
            csr.sum_duplicates()
        data = np.asarray(csr.data)
        if np.issubdtype(data.dtype, np.integer) or np.issubdtype(
            data.dtype, np.bool_
        ):
            data = data.astype(np.float64)
        return _format_csr(csr.indptr, csr.indices, data, csr.shape,
                           sparse_format, device=device)
    if callable(A) and not hasattr(A, "ndim"):
        if n is None or dtype is None:
            raise ValueError(
                "wrapping a callable requires the n= and dtype= keywords"
            )
        return FunctionOperator(A, n, dtype, device=device)
    arr = A if isinstance(A, torch.Tensor) else np.asarray(A)
    if arr.ndim != 2:
        raise ValueError("A must be a square 2-D array, operator, or callable")
    if arr.shape[0] != arr.shape[1]:
        raise ValueError(
            f"matrix is not square: dimensions are {tuple(arr.shape)}"
        )
    if isinstance(arr, np.ndarray) and (
        np.issubdtype(arr.dtype, np.integer) or np.issubdtype(arr.dtype, np.bool_)
    ):
        arr = arr.astype(np.float64)
    elif isinstance(arr, torch.Tensor) and not (
        arr.is_floating_point() or arr.is_complex()
    ):
        arr = arr.to(torch.float64)
    return DenseOperator(arr, device=device)
