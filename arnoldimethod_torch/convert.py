"""Carry state from the JAX package into this one.

Both helpers take plain numpy data, so this module needs nothing of JAX:
a caller (a test, a migration script) reads the JAX operator's arrays with
numpy and hands them over, and a workspace moves through the `.npz`
checkpoint both packages write.
"""

from __future__ import annotations

import numpy as np

from .models.operators import DenseOperator, DiaOperator, Stencil5Operator
from .workspace import ArnoldiWorkspace

__all__ = ["operator_from_arrays", "workspace_from_npz"]


def operator_from_arrays(kind, arrays, meta, device=None):
    """Build this package's operator from another package's operator data.

    kind "dense":   arrays {"A"}.
    kind "dia":     arrays {"diags", "offsets"}, meta {"shape"}.
    kind "stencil": arrays {"coeffs"}, meta {"grid", "boundary", "dtype"}
                    (coeffs are (center, west, east, north, south)).
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
    raise ValueError(f"unknown operator kind {kind!r}")


def workspace_from_npz(path, device=None):
    """Load an ArnoldiWorkspace checkpoint written by either package's
    `ArnoldiWorkspace.save` onto `device`."""
    return ArnoldiWorkspace.load(path, device=device)
