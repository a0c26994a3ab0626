"""Linear operator protocol and the concrete operators of the port's first
slice: dense, DIA (diagonal) and the constant-coefficient 5-point stencil,
plus callables.

An operator exposes `shape`, `dtype` (a torch dtype), `device` and
`matvec(x)` on tensors, mirroring the reference's matrix-free
`mul!`/`eltype`/`size` protocol (run.jl:21-23).  Each operator holds its
tensors on an explicit `device`; the solver allocates its workspace there.

Behavioral reference: arnoldimethod_tpu/models/operators.py.  The general
sparse formats, the shift-invert operators and the split-complex wrappers
are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import stencil
from ..workspace import as_torch_dtype

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "DiaOperator",
    "Stencil5Operator",
    "FunctionOperator",
    "as_operator",
]


def _device(device):
    return torch.device("cpu" if device is None else device)


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
        if device is None and isinstance(A, torch.Tensor):
            device = A.device
        if not isinstance(A, torch.Tensor):
            A = torch.from_numpy(np.array(A))
        self.A = torch.as_tensor(A, device=_device(device))
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
        if device is None and isinstance(diags, torch.Tensor):
            device = diags.device
        if not isinstance(diags, torch.Tensor):
            diags = torch.from_numpy(np.array(diags))
        self.diags = torch.as_tensor(diags, device=_device(device))
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

    def matvec(self, x):
        ny, nx = self.grid
        if (
            self.boundary == "dirichlet"
            and not x.is_complex()
            and self.use_pallas is not False
        ):
            return stencil.stencil5_matvec_sliding(
                x, coeffs=self.coeffs, grid=self.grid
            )
        if self.boundary == "dirichlet":
            return stencil.stencil5_plain(x, self.coeffs, self.grid)
        c, w, e, no, so = self.coeffs
        g = x.reshape(ny, nx)
        y = (
            c * g
            + w * torch.roll(g, 1, dims=1)
            + e * torch.roll(g, -1, dims=1)
            + no * torch.roll(g, 1, dims=0)
            + so * torch.roll(g, -1, dims=0)
        )
        return y.reshape(ny * nx)


class FunctionOperator(LinearOperator):
    """Wrap a callable y = f(x) on tensors as an operator."""

    def __init__(self, f, n, dtype, device=None):
        self.f = f
        self.shape = (n, n)
        self.dtype = as_torch_dtype(dtype)
        self.device = _device(device)

    def matvec(self, x):
        return self.f(x)


def as_operator(A, n=None, dtype=None, device=None):
    """Coerce A (operator, 2-D array or tensor, or callable) to a
    LinearOperator.  Integer/bool matrices solve in float64 (vtype
    promotion, run.jl:9-12).  scipy.sparse input is not ported yet."""
    if isinstance(A, LinearOperator):
        return A
    if hasattr(A, "tocsr") and hasattr(A, "shape"):
        raise NotImplementedError(
            "scipy.sparse input needs the general-sparse operators, not "
            "ported yet (ROADMAP.md queue 1, item 9)"
        )
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
