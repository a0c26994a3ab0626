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
its design meets that.  The transposed layout the TPU kernel needed for
its MXU contraction is the coalesced order for one thread per output row.

Dispatch: a tensor on the CPU takes `bsr_plain`; a CUDA tensor launches
the kernel, which is built with nvcc at first use, or raises.  Nothing
falls back from the kernel to the plain version.  The kernel takes real
float32 and float64; complex blocks raise TypeError on a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._build import PACKAGE_DIR, build_shared, nvcc_command

__all__ = ["KERNEL", "bsr_matvec", "bsr_plain", "pack_bsr"]

_SOURCE = PACKAGE_DIR / "csrc" / "bsr.cu"
# The JAX kernel's KB chunk; pack_bsr pads KB to a multiple of it.
_KC = 8
MAX_BLOCK_SIZE = 1024


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
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, block_cols, block_dataT, x):
        """y (nbr * B,) = A x.  Any nbr, KB and B <= 1024; block columns
        must lie in [0, x.numel() // B) (BsrOperator checks this once, at
        construction)."""
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(
                f"the BSR kernel takes real float32 or float64, got {x.dtype}"
                + ("; a complex BSR operator on a CUDA tensor needs "
                   "use_pallas=False" if x.dtype.is_complex else "")
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
        if not (x.device == block_dataT.device == block_cols.device):
            raise ValueError("block_cols, block_dataT and x must share a device")
        lib = self.load()
        fn = lib.bsr_f32 if x.dtype == torch.float32 else lib.bsr_f64
        y = torch.empty(nbr * B, dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(block_cols.data_ptr(), block_dataT.data_ptr(),
                     x.data_ptr(), y.data_ptr(), nbr, KB, B, stream)
        if err != 0:
            raise RuntimeError(f"BSR kernel launch failed: CUDA error {err}")
        self.launches += 1
        return y


KERNEL = _BsrKernel()


def bsr_matvec(block_cols, block_dataT, x):
    """y = A @ x with A in packed BSR form (see pack_bsr).

    block_cols: (nbr, KB) int32 with nbr % 8 == 0 and KB % min(8, KB) == 0;
    block_dataT: (nbr, KB, B, B) transposed blocks; x: (nbc * B,).
    Returns nbr * B rows (callers slice to the logical row count)."""
    nbr, KB = block_dataT.shape[:2]
    KC = min(_KC, KB)
    if KB == 0 or KB % KC != 0 or nbr % 8 != 0:
        raise ValueError(
            f"bsr_matvec requires packed operands (KB % {KC} == 0, "
            f"nbr % 8 == 0; got KB={KB}, nbr={nbr}) — build them with "
            "pack_bsr, or use BsrOperator which packs at construction"
        )
    if x.device.type == "cpu":
        return bsr_plain(block_cols, block_dataT, x)
    if x.device.type != "cuda":
        raise ValueError(
            f"the BSR matvec runs on cpu or cuda tensors, got {x.device}"
        )
    return KERNEL(block_cols, block_dataT, x)
