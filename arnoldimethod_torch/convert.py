"""Carry state from the JAX package into this one.

Both helpers take plain numpy data, so this module needs nothing of JAX:
a caller (a test, a migration script) reads the JAX operator's arrays with
numpy and hands them over, and a workspace moves through the `.npz`
checkpoint both packages write.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.operators import (
    BsrOperator,
    CsrOperator,
    DenseOperator,
    DiaOperator,
    EllOperator,
    SellOperator,
    ShardedCsrOperator,
    ShiftInvertDenseOperator,
    SplitComplexDenseOperator,
    SplitComplexOperator,
    Stencil5Operator,
    TridiagonalShiftInvertOperator,
    _device,
    _tensor,
)
from .transforms import ChebyshevFilterOperator, CirculantShiftInvertOperator
from .workspace import ArnoldiWorkspace, as_torch_dtype

__all__ = ["operator_from_arrays", "workspace_from_npz"]


def operator_from_arrays(kind, arrays, meta, device=None):
    """Build this package's operator from another package's operator data,
    on `device` (the card by default).

    kind "dense":   arrays {"A"}.
    kind "dia":     arrays {"diags", "offsets"}, meta {"shape"}.
    kind "stencil": arrays {"coeffs"}, meta {"grid", "boundary", "dtype"}
                    (coeffs are (center, west, east, north, south)).
    kind "csr":     arrays {"indptr", "indices", "data"}, meta {"shape"}.
    kind "ell":     arrays {"data", "cols"}, meta {"shape"}.
    kind "sell":    arrays {"buckets" ((data, cols) pairs), "inv_perm"},
                    meta {"shape", "nnz"}.
    kind "bsr":     arrays {"block_cols", "block_dataT"} as `pack_bsr`
                    packed them, meta {"logical_blocks", "shape"} and
                    optionally "use_pallas".
    kind "split_complex":  arrays {"re", "im"}, each the arrays of a real
                    part or None, meta {"re_kind", "re_meta", "im_kind",
                    "im_meta"} (each part's kind and meta).
    kind "split_complex_dense":  arrays {"Ar", "Ai"} (the real words).
    kind "chebyshev":  the inner operator's arrays, meta {"op_kind",
                    "op_meta" (the inner kind and its meta), "a", "b",
                    "degree", "scale_point"}.
    kind "shift_invert_dense":  arrays {"lu", "piv"} as
                    jax.scipy.linalg.lu_factor returns them (0-based
                    pivots; torch's are 1-based, so 1 is added), meta
                    {"sigma", "shape"}.
    kind "tridiag_shift_invert":  arrays {"l", "swap", "d0", "du1", "du2"}
                    (the factors) and {"dl", "d", "du"} (the padded shifted
                    bands), meta {"sigma", "shape", "dtype", "refine"}.
    kind "circulant_shift_invert":  arrays {"inv_re", "inv_im"} (the
                    inverse symbol's real words), meta {"grid", "sigma",
                    "dtype"}.
    kind "sharded_csr":  arrays {"arrs"}, the JAX ShardedCsrOperator's
                    `arrs` (every rank's rows), meta {"mode", "shape"} and
                    optionally "mesh" (default `parallel.make_mesh()`):
                    this rank's ShardedCsrOperator, on the mesh's device
                    type unless `device` says otherwise.
    """
    if kind == "dense":
        return DenseOperator(np.asarray(arrays["A"]), device=device)
    if kind == "dia":
        return DiaOperator(
            np.asarray(arrays["diags"]),
            tuple(int(o) for o in np.asarray(arrays["offsets"])),
            tuple(meta["shape"]),
            device=device,
        )
    if kind == "stencil":
        return Stencil5Operator(
            tuple(np.asarray(arrays["coeffs"]).tolist()),
            tuple(meta["grid"]),
            dtype=meta["dtype"],
            boundary=meta.get("boundary", "dirichlet"),
            device=device,
        )
    if kind == "csr":
        return CsrOperator(arrays["indptr"], arrays["indices"], arrays["data"],
                           tuple(meta["shape"]), device=device)
    if kind == "ell":
        return EllOperator(arrays["data"], arrays["cols"], tuple(meta["shape"]),
                           device=device)
    if kind == "sell":
        return SellOperator(arrays["buckets"], arrays["inv_perm"],
                            tuple(meta["shape"]), meta["nnz"], device=device)
    if kind == "bsr":
        return BsrOperator.from_packed(
            arrays["block_cols"], arrays["block_dataT"],
            tuple(meta["logical_blocks"]), tuple(meta["shape"]),
            use_pallas=meta.get("use_pallas"), device=device,
        )
    if kind == "split_complex":
        return SplitComplexOperator(*(
            None if arrays.get(part) is None else operator_from_arrays(
                meta[part + "_kind"], arrays[part],
                meta.get(part + "_meta", {}), device=device)
            for part in ("re", "im")))
    if kind == "split_complex_dense":
        Ar, Ai = np.asarray(arrays["Ar"]), np.asarray(arrays["Ai"])
        return SplitComplexDenseOperator(Ar + 1j * Ai, word_dtype=Ar.dtype,
                                         device=device)
    if kind == "chebyshev":
        inner = operator_from_arrays(meta["op_kind"], arrays,
                                     meta.get("op_meta", {}), device=device)
        return ChebyshevFilterOperator(inner, meta["a"], meta["b"],
                                       meta["degree"],
                                       scale_point=meta.get("scale_point"))
    if kind == "sharded_csr":
        mesh = meta.get("mesh")
        if mesh is None:
            from .parallel.mesh import make_mesh

            mesh = make_mesh()
        return ShardedCsrOperator(arrays["arrs"], tuple(meta["shape"]), mesh,
                                  mode=meta["mode"], device=device)
    dev = _device(device)
    if kind == "shift_invert_dense":
        piv = np.asarray(arrays["piv"]).astype(np.int32) + 1
        return ShiftInvertDenseOperator(
            _tensor(arrays["lu"], dev), _tensor(piv, dev), meta["sigma"],
            tuple(meta["shape"]),
        )
    if kind == "tridiag_shift_invert":
        dtype = as_torch_dtype(meta["dtype"])
        factors = tuple(
            _tensor(arrays[k], dev, torch.bool if k == "swap" else dtype)
            for k in ("l", "swap", "d0", "du1", "du2")
        )
        bands = tuple(_tensor(arrays[k], dev, dtype) for k in ("dl", "d", "du"))
        return TridiagonalShiftInvertOperator(
            factors, bands, meta["sigma"], tuple(meta["shape"]), dtype,
            meta["refine"],
        )
    if kind == "circulant_shift_invert":
        inv = (np.asarray(arrays["inv_re"], np.float64)
               + 1j * np.asarray(arrays["inv_im"], np.float64))
        word = as_torch_dtype(meta["dtype"])
        cdtype = torch.complex64 if word == torch.float32 else torch.complex128
        return CirculantShiftInvertOperator(
            _tensor(inv, dev, cdtype), meta["grid"], meta["sigma"], word)
    raise ValueError(f"unknown operator kind {kind!r}")


def workspace_from_npz(path, device=None):
    """Load an ArnoldiWorkspace checkpoint written by either package's
    `ArnoldiWorkspace.save` onto `device` (the card by default), with the
    low words `Vlo` and `Hlo` of an extended-precision solve; a
    split-complex checkpoint's `Vim` becomes the imaginary part of V."""
    return ArnoldiWorkspace.load(path, device=device)
