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

Dispatch: a tensor on the CPU takes `stencil5_plain`; a CUDA tensor
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


class _Stencil5Kernel:
    """The built CUDA library and the count of kernel launches."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def load(self):
        """Build (once per source hash) and load the library."""
        if self._lib is None:
            path, self.build_log = build_shared(
                "stencil5", [_SOURCE], nvcc_command("stencil")
            )
            lib = ctypes.CDLL(str(path))
            args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_int64] + [ctypes.c_double] * 5 + [
                        ctypes.c_int64, ctypes.c_void_p]
            for fn in (lib.stencil5_f32, lib.stencil5_f64):
                fn.argtypes = args
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, x, coeffs, grid, tile_rows=None):
        ny, nx = grid
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(
                f"the stencil kernel takes float32 or float64, got {x.dtype}"
            )
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError("the stencil kernel takes a contiguous 1-D x")
        if x.numel() != ny * nx:
            raise ValueError(
                f"x has {x.numel()} elements, grid {grid} needs {ny * nx}"
            )
        tile_rows = int(tile_rows or DEFAULT_TILE_ROWS)
        if tile_rows < 1:
            raise ValueError("tile_rows must be positive")
        lib = self.load()
        fn = lib.stencil5_f32 if x.dtype == torch.float32 else lib.stencil5_f64
        y = torch.empty_like(x)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), y.data_ptr(), ny, nx,
                     *(float(v) for v in coeffs), tile_rows, stream)
        if err != 0:
            raise RuntimeError(
                f"stencil5 kernel launch failed: CUDA error {err}"
            )
        self.launches += 1
        return y


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
