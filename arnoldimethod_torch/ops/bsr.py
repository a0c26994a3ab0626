"""The block-sparse row (BSR, block-level ELL) matvec: a CUDA kernel and
its plain PyTorch version.

A matrix is held as dense (B, B) blocks, KB slots per block-row: slot k of
block-row r is the block at block column `block_cols[r, k]`.  The blocks
are stored transposed, `block_dataT[r, k, j, i] = A_block[i, j]`, and
`pack_bsr` builds that layout once (the same bytes as the JAX package's
`pack_bsr`, so both packages' operators hold identical operands).

The kernel (`csrc/bsr.cu`) replaces the Pallas kernel
`arnoldimethod_tpu/ops/bsr_pallas.py::bsr_matvec`.  It is memory-bound
(4 bytes of block data per multiply-add in float32); the source says how
its design meets that.  `bsr_plan` is its launch plan: how many CTAs (one
thread-block cluster) share a block-row and which slots each sums, the
threads per CTA, and the ring of shared-memory stages that the block
stream goes through.  The kernel reads only the logical block-rows and
slots (`logical_blocks`), never the TPU's padding.

Dispatch: a tensor on the CPU takes `bsr_plain`; a CUDA tensor launches
the kernel, which is built with nvcc at first use, or raises.  Nothing
falls back from the kernel to the plain version.  The kernel takes real
float32 and float64; `BsrOperator` runs complex blocks through it as two
real words.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .._build import PACKAGE_DIR, build_shared, nvcc_command

__all__ = ["KERNEL", "BsrPlan", "bsr_matvec", "bsr_plain", "bsr_plan", "pack_bsr"]

_SOURCE = PACKAGE_DIR / "csrc" / "bsr.cu"
# The JAX kernel's KB chunk; pack_bsr pads KB to a multiple of it.
_KC = 8
MAX_BLOCK_SIZE = 1024

# The launch plan's limits (csrc/bsr.cu checks the same) and targets.
MAX_SMEM_BYTES = 232_448  # 227 KB, the most shared memory a block may use
_MAX_CLUSTER = 8  # the portable cluster size
_BAR_BYTES = 128  # the stage mbarriers, ahead of the ring
_STAGE_BYTES = (16 * 1024, 64 * 1024)  # one bulk copy: least and most
_XS_BYTES = 32 * 1024  # the x window
_THREADS = 256


class BsrPlan(NamedTuple):
    """How csrc/bsr.cu runs one operand shape (see bsr_plan)."""

    S: int  # CTAs per block-row: the cluster size
    chunks: tuple  # (k0, k1), the slots each rank sums, in rank order
    threads: int  # per CTA
    path: str  # "bulk" (async copies into the ring) or "direct" (loads)
    vec: int  # elements a thread reads at once: 16 bytes, or 1 (direct)
    stage_elems: int  # elements per tile, a ring stage on the bulk path
    stage_bytes: int
    stages: int  # ring stages; 0 on the direct path
    xrows: int  # (slot, j) rows of the x window in shared memory
    grid: int  # CTAs launched: max(nbr, 1) * S
    smem_bytes: int


@functools.lru_cache(maxsize=1024)
def bsr_plan(nbr, KB, B, itemsize, sm_count, aligned=True):
    """The BSR kernel's launch plan for nbr logical block-rows of KB slots
    of (B, B) blocks of `itemsize` bytes, on a card of `sm_count` SMs;
    `aligned`: the block data starts on a 16-byte boundary.

    - S CTAs, one cluster, share a block-row: S = 1 when nbr already gives
      about two CTAs per SM, else it grows towards that, capped at 8 and
      at KB, and is then raised to a divisor of KB where one lies below
      the cap, so the chunks are equal.  Rank s sums the contiguous slots
      [s * KB // S, (s + 1) * KB // S).
    - The bulk path (async bulk copies into a ring of stages) needs 16-byte
      aligned tiles: a block of B * B * itemsize bytes, a multiple of 16,
      and aligned data.  Otherwise the direct path reads scalars.
    - threads * vec is a multiple of B (each thread then meets fixed output
      rows), about four vectors a thread per chunk, at most 256 threads
      unless B asks for more.
    - A ring of two stages, each one bulk copy, or one stage holding the
      whole chunk when it fits in 64 KB.  On an H100 a CTA's stream rate
      grows with the bytes of a copy (each stage costs ~0.7 us however
      many are in flight: 20 GB/s at 16 KB, 55 GB/s at 64 KB for one CTA
      alone), so a stage is as large as the grid leaves room for: 64 KB
      while the grid covers at most half the SMs, 32 KB up to one CTA per
      SM (a cluster of S CTAs is placed only where S SMs have room, so a
      CTA keeps its SM half free), 16 KB beyond, where several CTAs share
      each SM (PERF.md).
    """
    if nbr < 0 or KB < 0 or not 1 <= B <= MAX_BLOCK_SIZE:
        raise ValueError(f"no BSR plan for nbr={nbr}, KB={KB}, B={B}")
    if itemsize not in (4, 8) or sm_count < 1:
        raise ValueError(f"no BSR plan for itemsize={itemsize}, sm_count={sm_count}")
    rows = max(nbr, 1)
    cap = max(1, min(_MAX_CLUSTER, KB))
    S = min(cap, -(-2 * sm_count // rows))
    S = next((s for s in range(S, cap + 1) if KB % s == 0), S)
    chunks = tuple((s * KB // S, (s + 1) * KB // S) for s in range(S))
    chunk_elems = max(k1 - k0 for k0, k1 in chunks) * B * B

    bulk = bool(aligned) and (B * B * itemsize) % 16 == 0
    vec = 16 // itemsize if bulk else 1
    u = B // math.gcd(B, vec)  # threads must be a multiple of u
    want = min(_THREADS, max(32, -(-chunk_elems // (4 * vec * 32)) * 32))
    threads = max(u, want // u * u)

    grid = rows * S
    least, most = _STAGE_BYTES
    target = (most if chunk_elems * itemsize <= most
              else max(least, most // -(-2 * grid // sm_count)))
    unit = threads * vec  # elements all threads read in one step
    stage_elems = unit * max(1, min(target // (unit * itemsize),
                                    -(-chunk_elems // unit)))
    stage_bytes = stage_elems * itemsize
    stages = min(2, -(-chunk_elems // stage_elems)) if bulk else 0
    tile_rows = stage_elems // B
    chunk_rows = chunk_elems // B
    xrows = tile_rows * max(1, min(_XS_BYTES // itemsize // tile_rows,
                                   -(-chunk_rows // tile_rows)))
    smem = (_BAR_BYTES + stages * stage_bytes + -(-xrows * itemsize // 16) * 16
            + threads * vec * itemsize)
    return BsrPlan(S, chunks, threads, "bulk" if bulk else "direct", vec,
                   stage_elems, stage_bytes, stages, xrows, grid, smem)


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _logical_extents(block_dataT, logical_blocks):
    """(nbr, KB) to read: the packed shape by default; raises outside it."""
    nbr, KB = block_dataT.shape[:2]
    if logical_blocks is None:
        return int(nbr), int(KB)
    nbr_l, kb_l = (int(v) for v in logical_blocks)
    if not (0 <= nbr_l <= nbr and 0 <= kb_l <= KB):
        raise ValueError(
            f"logical_blocks {(nbr_l, kb_l)} must lie within the packed "
            f"extents ({nbr}, {KB}) and be >= 0"
        )
    return nbr_l, kb_l


def pack_bsr(block_cols, block_data):
    """One-time packing of natural-orientation BSR operands (numpy only).

    block_cols: (nbr, KB) int, the block column of each slot;
    block_data: (nbr, KB, B, B), block_data[r, k] the block at block-row
      r, block column block_cols[r, k].

    Returns (cols int32, dataT) with nbr padded to a multiple of 8, KB to
    a multiple of min(8, KB), and each block transposed:
    dataT[r, k, j, i] = block_data[r, k, i, j].  Pad slots point at block
    column 0 with zero data.  The output equals the JAX package's
    `pack_bsr` byte for byte.
    """
    block_cols = np.asarray(block_cols)
    block_data = np.asarray(block_data)
    nbr, KB, B, _ = block_data.shape
    KC = min(_KC, KB)
    KBp = -(-KB // KC) * KC
    nbrp = -(-nbr // 8) * 8
    if (KBp, nbrp) != (KB, nbr):
        block_cols = np.pad(block_cols, ((0, nbrp - nbr), (0, KBp - KB)))
        block_data = np.pad(
            block_data, ((0, nbrp - nbr), (0, KBp - KB), (0, 0), (0, 0))
        )
    dataT = np.ascontiguousarray(block_data.transpose(0, 1, 3, 2))
    return block_cols.astype(np.int32), dataT


def bsr_plain(block_cols, block_dataT, x):
    """The plain version: gather the x block of every slot, then one
    einsum over (slot, column) per block-row (the formulation of the JAX
    BsrOperator's non-Pallas matvec).  Returns nbr * B rows."""
    B = block_dataT.shape[-1]
    gathered = x.reshape(-1, B)[block_cols.long()]  # (nbr, KB, B)
    return torch.einsum("rkji,rkj->ri", block_dataT, gathered).reshape(-1)


class _BsrKernel:
    """The built CUDA library and the count of kernel launches."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def load(self):
        """Build (once per source hash) and load the library."""
        if self._lib is None:
            path, self.build_log = build_shared(
                "bsr", [_SOURCE], nvcc_command("BSR")
            )
            lib = ctypes.CDLL(str(path))
            for fn in (lib.bsr_f32, lib.bsr_f64):
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 11 + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def plan(self, block_dataT, logical_blocks=None):
        """The launch plan for these CUDA operands (cached per shape)."""
        nbr, KB = _logical_extents(block_dataT, logical_blocks)
        return bsr_plan(nbr, KB, int(block_dataT.shape[-1]),
                        block_dataT.element_size(),
                        _sm_count(torch.cuda.current_device()
                                  if block_dataT.device.index is None
                                  else block_dataT.device.index),
                        block_dataT.data_ptr() % 16 == 0)

    def __call__(self, block_cols, block_dataT, x, logical_blocks=None):
        """y (nbr * B,) = A x.  Any nbr, KB and B <= 1024; block columns
        must lie in [0, x.numel() // B) (BsrOperator checks this once, at
        construction).  logical_blocks (nbr, KB), by default the packed
        shape: only those block-rows and slots are read, and the rows of
        the block-rows past nbr are zeros."""
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(
                f"the BSR kernel takes real float32 or float64, got {x.dtype}"
                + ("; BsrOperator passes it the real and imaginary words"
                   if x.dtype.is_complex else "")
            )
        if block_dataT.dtype != x.dtype:
            raise TypeError(
                f"block data is {block_dataT.dtype}, x is {x.dtype}"
            )
        if block_cols.dtype != torch.int32:
            raise TypeError(f"block_cols must be int32, got {block_cols.dtype}")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError("the BSR kernel takes a contiguous 1-D x")
        if block_dataT.dim() != 4 or not block_dataT.is_contiguous():
            raise ValueError("block_dataT must be a contiguous (nbr, KB, B, B)")
        nbr, KB, B, B2 = block_dataT.shape
        if B != B2 or not 1 <= B <= MAX_BLOCK_SIZE:
            raise ValueError(
                f"blocks must be square with 1 <= B <= {MAX_BLOCK_SIZE}, "
                f"got {B} x {B2}"
            )
        if tuple(block_cols.shape) != (nbr, KB) or not block_cols.is_contiguous():
            raise ValueError(
                f"block_cols must be a contiguous ({nbr}, {KB}), got "
                f"{tuple(block_cols.shape)}"
            )
        if x.numel() % B or (KB and x.numel() == 0):
            raise ValueError(
                f"x has {x.numel()} elements, not a positive multiple of the "
                f"block size {B} (nbc * B)"
            )
        nbr_l, kb_l = _logical_extents(block_dataT, logical_blocks)
        if not (x.device == block_dataT.device == block_cols.device):
            raise ValueError("block_cols, block_dataT and x must share a device")
        lib = self.load()
        fn = lib.bsr_f32 if x.dtype == torch.float32 else lib.bsr_f64
        plan = self.plan(block_dataT, (nbr_l, kb_l))
        y = torch.empty(nbr * B, dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(block_cols.data_ptr(), block_dataT.data_ptr(),
                     x.data_ptr(), y.data_ptr(), nbr, KB, nbr_l, kb_l, B,
                     plan.S, plan.threads, plan.vec, plan.stage_elems,
                     plan.stages, plan.xrows, stream)
        if err != 0:
            raise RuntimeError(f"BSR kernel launch failed: CUDA error {err}")
        self.launches += 1
        return y


KERNEL = _BsrKernel()


def bsr_matvec(block_cols, block_dataT, x, logical_blocks=None):
    """y = A @ x with A in packed BSR form (see pack_bsr).

    block_cols: (nbr, KB) int32 with nbr % 8 == 0 and KB % min(8, KB) == 0;
    block_dataT: (nbr, KB, B, B) transposed blocks; x: (nbc * B,);
    logical_blocks: the real (nbr, KB) before packing (BsrOperator's
    `logical_blocks`), which the kernel reads alone; pad data is zero, so
    the result is the same without it.  Returns nbr * B rows (callers
    slice to the logical row count)."""
    nbr, KB = block_dataT.shape[:2]
    KC = min(_KC, KB)
    if KB == 0 or KB % KC != 0 or nbr % 8 != 0:
        raise ValueError(
            f"bsr_matvec requires packed operands (KB % {KC} == 0, "
            f"nbr % 8 == 0; got KB={KB}, nbr={nbr}) — build them with "
            "pack_bsr, or use BsrOperator which packs at construction"
        )
    _logical_extents(block_dataT, logical_blocks)
    if x.device.type == "cpu":
        return bsr_plain(block_cols, block_dataT, x)
    if x.device.type != "cuda":
        raise ValueError(
            f"the BSR matvec runs on cpu or cuda tensors, got {x.device}"
        )
    return KERNEL(block_cols, block_dataT, x, logical_blocks)
