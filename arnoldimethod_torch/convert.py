"""Carry state from the JAX package into this one.

Both helpers take plain numpy data, so this module needs nothing of JAX:
a caller (a test, a migration script) reads the JAX operator's arrays with
numpy and hands them over, and a workspace moves through the `.npz`
checkpoint both packages write.
"""

from __future__ import annotations

import numpy as np

from .models.operators import (
    BsrOperator,
    CsrOperator,
    DenseOperator,
    DiaOperator,
    EllOperator,
    SellOperator,
    Stencil5Operator,
)
from .workspace import ArnoldiWorkspace

__all__ = ["operator_from_arrays", "workspace_from_npz"]


def operator_from_arrays(kind, arrays, meta, device=None):
    """Build this package's operator from another package's operator data.

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
    raise ValueError(f"unknown operator kind {kind!r}")


def workspace_from_npz(path, device=None):
    """Load an ArnoldiWorkspace checkpoint written by either package's
    `ArnoldiWorkspace.save` onto `device`."""
    return ArnoldiWorkspace.load(path, device=device)
