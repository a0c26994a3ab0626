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

The filter itself, `stencil5_cheb_filter`, runs up to `cheb_depth` degree
steps a launch (`stencil5_cheb_steps`, a second kernel of the same source
that keeps the levels between on chip), bit for bit the chain of one-step
launches; its plain version is `stencil5_cheb_steps_plain`.  The depth
follows the dtype, the rows a block (`cheb_plan`) the grid and the card.

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
    "cheb_depth",
    "cheb_plan",
    "stencil5_matvec",
    "stencil5_cheb_filter",
    "stencil5_cheb_plain",
    "stencil5_cheb_step",
    "stencil5_cheb_steps",
    "stencil5_cheb_steps_plain",
    "stencil5_matvec_sliding",
    "stencil5_plain",
]

_SOURCE = PACKAGE_DIR / "csrc" / "stencil5.cu"
# Rows each thread walks down (the block height).  Simple default; the
# kernel takes any positive value.
DEFAULT_TILE_ROWS = 8
# The fused Chebyshev run (csrc/stencil5.cu, RunShape; `bind` checks that
# they agree), by dtype: the columns a block covers and the most degree
# steps a launch.  A run of L steps writes CHEB_COLUMNS - 2 L columns a
# block.
CHEB_COLUMNS = {torch.float32: 512, torch.float64: 256}
CHEB_DEPTH = {torch.float32: 16, torch.float64: 8}


def cheb_depth(dtype):
    """Degree steps a launch of the fused run: the kernel's most for the
    dtype (float64 holds half as many levels in the same shared memory and
    registers).  A deeper run moves fewer bytes a step (~16 / L a point)
    for a halo of L columns and 2 L warm-up rows a block."""
    if dtype not in CHEB_DEPTH:
        raise TypeError(
            f"the fused Chebyshev run takes float32 or float64, got {dtype}"
        )
    return CHEB_DEPTH[dtype]


def cheb_plan(grid, dtype, levels, slots):
    """Rows a block of a run of `levels` steps: as many blocks as the card
    holds at once (`slots`, SMs times resident blocks an SM) in one wave,
    each as tall as that allows.  A block recomputes ~2 L rows beside its
    own, so the tallest blocks that still fill the card waste the least; a
    second, partial wave would leave SMs idle."""
    ny, nx = grid
    col_blocks = -(-nx // (CHEB_COLUMNS[dtype] - 2 * levels))
    row_blocks = max(1, slots // col_blocks)
    return -(-ny // row_blocks)


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


def stencil5_cheb_steps_plain(x, z, coeffs, grid, c, inv_e, pq, lo=None,
                              hi=None):
    """The plain version of a fused run: len(pq) steps of
    `stencil5_cheb_plain` from x = y_t and z = y_{t-1} (None: the first
    step has no z).  Returns (y_{t+L-1}, y_{t+L}), copied into `lo` and
    `hi` when given."""
    prev, y = z, x
    for p, q in pq:
        prev, y = y, stencil5_cheb_plain(y, prev, coeffs, grid, c, inv_e, p,
                                         0.0 if prev is None else q)
    if lo is not None:
        prev = lo.copy_(prev)
    if hi is not None:
        y = hi.copy_(y)
    return prev, y


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
    for the matvec, `cheb_launches` for the Chebyshev step and the fused
    run, and `cheb_steps` for the degree steps those launches did
    (`cheb_steps / cheb_launches` is the mean fused depth)."""

    def __init__(self):
        self.launches = 0
        self.cheb_launches = 0
        self.cheb_steps = 0
        self.build_log = ""
        self._lib = None
        self._slots = {}

    def load(self):
        """Build (once per source hash) and load the library."""
        if self._lib is None:
            path, self.build_log = build_shared(
                "stencil5", [_SOURCE], nvcc_command("stencil")
            )
            self._lib = bind(ctypes.CDLL(str(path)))
        return self._lib

    def _launch(self, entry, x, ptrs, grid, scalars, tail):
        """Launch the C entry `entry` (its _f32 or _f64 form, by x's dtype)
        on x's device and current stream, with `tail` after the scalars,
        and raise on a CUDA error."""
        ny, nx = grid
        lib = self.load()
        fn = getattr(lib, entry + _suffix(x.dtype))
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(*ptrs, ny, nx, *(float(v) for v in scalars), *tail,
                     stream)
        if err != 0:
            raise RuntimeError(
                f"{entry} kernel launch failed: CUDA error {err}"
            )

    def __call__(self, x, coeffs, grid, tile_rows=None):
        _check_vector(x, grid, "x")
        tile_rows = _tile_rows(tile_rows)
        y = torch.empty_like(x)
        self._launch("stencil5", x, (x.data_ptr(), y.data_ptr()), grid,
                     coeffs, (tile_rows,))
        self.launches += 1
        return y

    def cheb_slots(self, x):
        """Blocks of the fused run the card of x holds at once: its SMs
        times the run kernel's resident blocks an SM (once a device and
        dtype)."""
        key = (x.device, x.dtype)
        if key not in self._slots:
            fn = getattr(self.load(),
                         "stencil5_cheb_run_blocks_per_sm" + _suffix(x.dtype))
            blocks = ctypes.c_int(0)
            with torch.cuda.device(x.device):
                err = fn(ctypes.byref(blocks))
                sms = torch.cuda.get_device_properties(
                    x.device).multi_processor_count
            if err != 0 or blocks.value < 1:
                raise RuntimeError(
                    f"the fused Chebyshev run fits no block on an SM: CUDA "
                    f"error {err}, {blocks.value} blocks"
                )
            self._slots[key] = sms * blocks.value
        return self._slots[key]

    def cheb_run(self, x, z, lo, hi, coeffs, grid, c, inv_e, pq,
                 tile_rows=None):
        """len(pq) Chebyshev steps in one launch on the card; see
        `stencil5_cheb_steps`.  tile_rows None: `cheb_plan`'s."""
        for name, t in (("x", x), ("z", z), ("lo", lo), ("hi", hi)):
            if t is None:
                continue
            _check_vector(t, grid, name)
            if t.dtype != x.dtype or t.device != x.device:
                raise ValueError(f"{name} must match x in dtype and device")
        levels = len(pq)
        if tile_rows is None:
            tile_rows = cheb_plan(grid, x.dtype, levels,
                                  self.cheb_slots(x))
        p = (ctypes.c_double * levels)(*(float(v) for v, _ in pq))
        q = (ctypes.c_double * levels)(*(float(v) for _, v in pq))
        ptrs = tuple(None if t is None else t.data_ptr()
                     for t in (x, z, lo, hi))
        self._launch("stencil5_cheb_run", x, ptrs, grid, (*coeffs, c, inv_e),
                     (p, q, levels, _tile_rows(tile_rows)))
        self.cheb_launches += 1
        self.cheb_steps += levels

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
        self._launch("stencil5_cheb", x, ptrs, grid,
                     (*coeffs, c, inv_e, p, q), (DEFAULT_TILE_ROWS,))
        self.cheb_launches += 1
        self.cheb_steps += 1
        return out


def _suffix(dtype):
    return "_f32" if dtype == torch.float32 else "_f64"


def bind(lib):
    """Declare the C entries of a loaded stencil5 library (a ctypes.CDLL)
    and check that its run kernel has this module's columns and depths;
    returns lib."""
    grid = [ctypes.c_int64, ctypes.c_int64] + [ctypes.c_double] * 5
    tail = [ctypes.c_int64, ctypes.c_void_p]
    dp = ctypes.POINTER(ctypes.c_double)
    for fn in (lib.stencil5_f32, lib.stencil5_f64):
        fn.argtypes = [ctypes.c_void_p] * 2 + grid + tail
        fn.restype = ctypes.c_int
    for fn in (lib.stencil5_cheb_f32, lib.stencil5_cheb_f64):
        fn.argtypes = ([ctypes.c_void_p] * 3 + grid + [ctypes.c_double] * 4
                       + tail)
        fn.restype = ctypes.c_int
    for fn in (lib.stencil5_cheb_run_f32, lib.stencil5_cheb_run_f64):
        fn.argtypes = ([ctypes.c_void_p] * 4 + grid + [ctypes.c_double] * 2
                       + [dp, dp, ctypes.c_int64] + tail)
        fn.restype = ctypes.c_int
    for fn in (lib.stencil5_cheb_run_blocks_per_sm_f32,
               lib.stencil5_cheb_run_blocks_per_sm_f64):
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    shape = lib.stencil5_cheb_run_shape
    shape.argtypes = [ctypes.POINTER(ctypes.c_int64)] * 4
    shape.restype = None
    got = [ctypes.c_int64(0) for _ in range(4)]
    shape(*(ctypes.byref(v) for v in got))
    got = tuple(v.value for v in got)
    want = tuple(table[dt] for dt in (torch.float32, torch.float64)
                 for table in (CHEB_COLUMNS, CHEB_DEPTH))
    if got != want:
        raise RuntimeError(
            f"csrc/stencil5.cu's run has columns and depths {got}, "
            f"ops/stencil.py {want}"
        )
    return lib


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


def stencil5_cheb_steps(x, z, *, coeffs, grid, c, inv_e, pq, hi, lo=None):
    """len(pq) degree steps of the Chebyshev filter over the Dirichlet
    stencil in one pass: from x = y_t and z = y_{t-1}, step k computes
    y_{t+k} = p_k ((A y_{t+k-1} - c y_{t+k-1}) * inv_e) - q_k y_{t+k-2},
    with (p_k, q_k) = pq[k - 1]; z=None makes the first step the filter's
    first, without z (its q unused).  Writes y_{t+L} into `hi` and, when
    `lo` is given, y_{t+L-1} into `lo`; returns (lo, hi).  The outputs
    must overlap neither input nor each other (neighbouring blocks read
    both inputs); 1 <= len(pq) <= cheb_depth(x.dtype).  A CPU tensor takes
    `stencil5_cheb_steps_plain`; a CUDA tensor launches the kernel or
    raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"the Chebyshev step runs on cpu or cuda tensors, got {x.device}"
        )
    if not 1 <= len(pq) <= cheb_depth(x.dtype):
        raise ValueError(
            f"a fused run takes 1 to {cheb_depth(x.dtype)} steps, got "
            f"{len(pq)}"
        )
    if hi is None:
        raise ValueError("a fused run needs hi")
    outs = [t for t in (lo, hi) if t is not None]
    for t in (x, z, *outs):
        if t is not None and not t.is_contiguous():
            raise ValueError("the fused run takes contiguous vectors")
    for t in outs:
        if any(u is not None and _overlaps(t, u) for u in (x, z)):
            raise ValueError("a fused run's outputs must not overlap x or z")
    if lo is not None and _overlaps(lo, hi):
        raise ValueError("lo and hi must not overlap")
    if x.device.type == "cpu":
        return stencil5_cheb_steps_plain(x, z, coeffs, grid, c, inv_e, pq,
                                         lo, hi)
    KERNEL.cheb_run(x, z, lo, hi, coeffs, grid, c, inv_e, pq)
    return lo, hi


def stencil5_cheb_filter(x, *, coeffs, grid, c, inv_e, first, steps):
    """p(A) x by the Chebyshev three-term recurrence over the Dirichlet
    stencil: the first step p_0 L(x), then y_{k+1} = p_k L(y_k) - q_k
    y_{k-1} for each (p_k, q_k) in `steps`, L(v) = (A v - c v) * inv_e.
    `cheb_depth(x.dtype)` steps a call of `stencil5_cheb_steps`, the
    remainder last; each call writes the pair of buffers that the one
    before last wrote (two pairs rotate), the last only its y.  x, a row
    of the caller's basis, is never written."""
    pq = [(first, 0.0), *steps]
    depth = cheb_depth(x.dtype)
    pairs = [[None, None], [None, None]]
    y, z = x, None
    for k, at in enumerate(range(0, len(pq), depth)):
        last = at + depth >= len(pq)
        pair = pairs[k % 2]
        for i in ((1,) if last else (0, 1)):
            if pair[i] is None:
                pair[i] = torch.empty_like(x)
        z, y = stencil5_cheb_steps(y, z, coeffs=coeffs, grid=grid, c=c,
                                   inv_e=inv_e, pq=pq[at:at + depth],
                                   lo=None if last else pair[0], hi=pair[1])
    return y
