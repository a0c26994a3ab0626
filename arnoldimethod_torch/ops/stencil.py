"""The constant-coefficient 5-point stencil matvec: a CUDA kernel and its
plain PyTorch version.

    y[i,j] = c*x[i,j] + w*x[i,j-1] + e*x[i,j+1] + n*x[i-1,j] + s*x[i+1,j]

on an (ny, nx) row-major grid with a zero Dirichlet boundary; x and y are
flat length-(ny*nx) vectors.

The kernel (`csrc/stencil5.cu`) replaces both Pallas kernels of
`arnoldimethod_tpu/ops/stencil_pallas.py`, `stencil5_matvec_sliding` and
`stencil5_matvec`: the two compute the same function by two TPU DMA
strategies, so both names here route to the one kernel, with `tile_rows`
kept as its block-height knob.  It is memory-bound (about 8 bytes a point
in float32: read x, write y); the source says how its design meets that.
It writes out of place into a fresh output, since blocks run in parallel
and an in-place update would race with the neighbours' halo reads.

The same kernel with an epilogue is one degree step of the Chebyshev
filter, `stencil5_cheb_step`: y = p * ((A x - c x) * inv_e) - q * z in one
pass (read x and z, write y), where XLA fuses the JAX package's recurrence
(arnoldimethod_tpu/transforms.py:199-231).  Its plain version is
`stencil5_cheb_plain`.  `y` may be `z`'s buffer, never `x`'s.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel, which is built with nvcc at first use, or raises.
Nothing falls back from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .._build import PACKAGE_DIR, build_shared, nvcc_command

__all__ = [
    "KERNEL",
    "stencil5_matvec",
    "stencil5_cheb_plain",
    "stencil5_cheb_step",
    "stencil5_matvec_sliding",
    "stencil5_plain",
]

_SOURCE = PACKAGE_DIR / "csrc" / "stencil5.cu"
# Rows each thread walks down (the block height).  Simple default; the
# kernel takes any positive value.
DEFAULT_TILE_ROWS = 8


def stencil5_plain(x, coeffs, grid):
    """The plain version: one zero-padded halo plus five shifted reads
    (the formulation of Stencil5Operator.matvec in the JAX package)."""
    c, w, e, no, so = coeffs
    ny, nx = grid
    g = x.reshape(ny, nx)
    gp = F.pad(g, (1, 1, 1, 1))
    y = (
        c * g
        + w * gp[1:-1, :-2]
        + e * gp[1:-1, 2:]
        + no * gp[:-2, 1:-1]
        + so * gp[2:, 1:-1]
    )
    return y.reshape(ny * nx)


def stencil5_cheb_plain(x, z, coeffs, grid, c, inv_e, p, q, out=None):
    """The plain version of one Chebyshev step, in the JAX package's order:
    L = (A x - c x) * inv_e, then y = p * L - q * z (y = p * L when z is
    None).  The result goes to `out` when given (it may be z)."""
    lv = (stencil5_plain(x, coeffs, grid) - c * x) * inv_e
    y = p * lv if z is None else p * lv - q * z
    if out is None:
        return y
    return out.copy_(y)


def _check_vector(x, grid, what):
    ny, nx = grid
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"the stencil kernel takes float32 or float64, got {x.dtype}"
        )
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"the stencil kernel takes a contiguous 1-D {what}")
    if x.numel() != ny * nx:
        raise ValueError(
            f"{what} has {x.numel()} elements, grid {grid} needs {ny * nx}"
        )


def _overlaps(a, b):
    """True when the memory of tensors a and b overlaps."""
    if a.device != b.device:
        return False
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def _same(a, b):
    return a.data_ptr() == b.data_ptr() and a.numel() == b.numel()


def _tile_rows(tile_rows):
    tile_rows = int(tile_rows or DEFAULT_TILE_ROWS)
    if tile_rows < 1:
        raise ValueError("tile_rows must be positive")
    return tile_rows


class _Stencil5Kernel:
    """The built CUDA library and the counts of its launches: `launches`
    for the matvec, `cheb_launches` for the Chebyshev step."""

    def __init__(self):
        self.launches = 0
        self.cheb_launches = 0
        self.build_log = ""
        self._lib = None

    def load(self):
        """Build (once per source hash) and load the library."""
        if self._lib is None:
            path, self.build_log = build_shared(
                "stencil5", [_SOURCE], nvcc_command("stencil")
            )
            lib = ctypes.CDLL(str(path))
            grid = [ctypes.c_int64, ctypes.c_int64] + [ctypes.c_double] * 5
            tail = [ctypes.c_int64, ctypes.c_void_p]
            for fn in (lib.stencil5_f32, lib.stencil5_f64):
                fn.argtypes = [ctypes.c_void_p] * 2 + grid + tail
                fn.restype = ctypes.c_int
            for fn in (lib.stencil5_cheb_f32, lib.stencil5_cheb_f64):
                fn.argtypes = ([ctypes.c_void_p] * 3 + grid
                               + [ctypes.c_double] * 4 + tail)
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def _launch(self, entry, counter, x, ptrs, grid, scalars, tile_rows):
        """Launch the C entry `entry` (its _f32 or _f64 form, by x's dtype)
        on x's device and current stream, raise on a CUDA error, and add
        one to the count named `counter`."""
        ny, nx = grid
        lib = self.load()
        suffix = "_f32" if x.dtype == torch.float32 else "_f64"
        fn = getattr(lib, entry + suffix)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(*ptrs, ny, nx, *(float(v) for v in scalars), tile_rows,
                     stream)
        if err != 0:
            raise RuntimeError(
                f"{entry} kernel launch failed: CUDA error {err}"
            )
        setattr(self, counter, getattr(self, counter) + 1)

    def __call__(self, x, coeffs, grid, tile_rows=None):
        _check_vector(x, grid, "x")
        tile_rows = _tile_rows(tile_rows)
        y = torch.empty_like(x)
        self._launch("stencil5", "launches", x, (x.data_ptr(), y.data_ptr()),
                     grid, coeffs, tile_rows)
        return y

    def cheb(self, x, z, coeffs, grid, c, inv_e, p, q, out=None):
        """One Chebyshev step on the card; see `stencil5_cheb_step`."""
        _check_vector(x, grid, "x")
        if z is not None:
            _check_vector(z, grid, "z")
            if z.dtype != x.dtype or z.device != x.device:
                raise ValueError("z must match x in dtype and device")
        if out is None:
            out = torch.empty_like(x)
        else:
            _check_vector(out, grid, "out")
            if out.dtype != x.dtype or out.device != x.device:
                raise ValueError("out must match x in dtype and device")
        ptrs = (x.data_ptr(), None if z is None else z.data_ptr(),
                out.data_ptr())
        self._launch("stencil5_cheb", "cheb_launches", x, ptrs, grid,
                     (*coeffs, c, inv_e, p, q), DEFAULT_TILE_ROWS)
        return out


KERNEL = _Stencil5Kernel()


def _dispatch(x, coeffs, grid, tile_rows):
    if x.device.type == "cpu":
        return stencil5_plain(x, coeffs, grid)
    if x.device.type != "cuda":
        raise ValueError(
            f"the stencil matvec runs on cpu or cuda tensors, got {x.device}"
        )
    return KERNEL(x, coeffs, grid, tile_rows)


def stencil5_matvec(x, *, coeffs, grid, tile_rows=None):
    """y = A @ x for the 5-point stencil (center, west, east, north, south)
    on an (ny, nx) grid.  Counterpart of the halo-DMA TPU kernel; on the
    card it is the same kernel as `stencil5_matvec_sliding`."""
    return _dispatch(x, coeffs, grid, tile_rows)


def stencil5_matvec_sliding(x, *, coeffs, grid, tile_rows=None):
    """y = A @ x for the 5-point stencil; counterpart of the sliding-window
    TPU kernel (the one Stencil5Operator takes)."""
    return _dispatch(x, coeffs, grid, tile_rows)


def stencil5_cheb_step(x, z, *, coeffs, grid, c, inv_e, p, q, out=None):
    """One degree step of the Chebyshev filter over the Dirichlet stencil:

        y = p * ((A x - c x) * inv_e) - q * z

    z=None (then q must be 0) is the first step, y = p * L(x).  The result
    goes to `out` if given, else to a fresh tensor.  `out` may be z (the
    recurrence's y_{k+1} overwrites y_{k-1}) but never x, whose halo the
    step reads; x, z and out must be contiguous.  A CPU tensor takes
    `stencil5_cheb_plain`; a CUDA tensor launches the kernel or raises."""
    if out is not None:
        if _overlaps(out, x):
            raise ValueError("out must not be x: the step reads x's halo")
        if z is not None and _overlaps(out, z) and not _same(out, z):
            raise ValueError("out may be z itself, not a shifted view of it")
    if z is None and q != 0:
        raise ValueError("a step without z needs q == 0")
    for name, t in (("x", x), ("z", z), ("out", out)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"the Chebyshev step takes a contiguous {name}")
    if x.device.type == "cpu":
        return stencil5_cheb_plain(x, z, coeffs, grid, c, inv_e, p, q, out)
    if x.device.type != "cuda":
        raise ValueError(
            f"the Chebyshev step runs on cpu or cuda tensors, got {x.device}"
        )
    return KERNEL.cheb(x, z, coeffs, grid, c, inv_e, p, q, out)
