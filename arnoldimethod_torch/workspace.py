"""Arnoldi workspace: the large arrays of the solver and their ownership.

The n-sized Krylov basis V lives on the device as a (maxdim+1, n) tensor
(vectors are rows), while the (maxdim+1) x maxdim Hessenberg matrix H is
authoritative on the host in float64/complex128: the dense restart kernels
run there and only freshly expanded columns round-trip through the device
dtype.  The solver updates V in place, so the workspace owns its storage.

Behavioral reference: arnoldimethod_tpu/workspace.py and ArnoldiMethod.jl
src/ArnoldiMethod.jl:41-93.  The `.npz` checkpoint format is the JAX
package's, so a checkpoint written there loads here and back.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _device as _dev

__all__ = ["ArnoldiWorkspace", "as_torch_dtype"]


def as_torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def _numpy_name(dtype):
    return str(torch.empty(0, dtype=dtype).numpy().dtype)


class ArnoldiWorkspace:
    """Holds V ((maxdim+1, n) tensor on `device`, basis vectors as rows)
    and H ((maxdim+1, maxdim) host float64/complex128).  The Arnoldi
    relation maintained is A @ V[:k].T = V[:k+1].T @ H[:k+1, :k].

    Supports the same three uses as the reference type: fresh allocation,
    warm restart from an existing decomposition (`partial_schur` with
    start_from), and reuse across calls without reallocation.
    """

    def __init__(self, n, maxdim, dtype=torch.float32, V=None, H=None,
                 device=None):
        if maxdim > n:
            raise ValueError("Krylov dimension should be less than matrix order.")
        if maxdim < 1:
            raise ValueError("Krylov dimension must be at least 1.")
        self.n = int(n)
        self.maxdim = int(maxdim)
        dtype = as_torch_dtype(dtype)
        device = _dev.resolve(device, like=V)

        if V is None:
            V = torch.zeros((maxdim + 1, n), dtype=dtype, device=device)
        else:
            # Copy: the solver updates V in place, so the workspace must
            # own its storage, not alias the caller's.
            V = torch.as_tensor(V).to(dtype=dtype, device=device, copy=True)
            if tuple(V.shape) != (maxdim + 1, n):
                raise ValueError(
                    f"V must have shape {(maxdim + 1, n)}, got {tuple(V.shape)}"
                )
        self.V = V

        host_dtype = np.complex128 if dtype.is_complex else np.float64
        if H is None:
            H = np.zeros((maxdim + 1, maxdim), dtype=host_dtype)
        else:
            H = np.array(H, dtype=host_dtype)
            if H.shape != (maxdim + 1, maxdim):
                raise ValueError(
                    f"H must have shape {(maxdim + 1, maxdim)}, got {H.shape}"
                )
        self.H = H
        # Low word of the basis after an extended=True solve, so that a
        # warm start resumes at double-word accuracy; None after a plain
        # solve, which moves V without tracking it.
        self.Vlo = None
        # Low words of the host Hessenberg after a double-double solve
        # (extended=True with float64 words): H holds the hi words.  None
        # otherwise.
        self.Hlo = None

    @property
    def dtype(self):
        return self.V.dtype

    @property
    def device(self):
        return self.V.device

    # -- Checkpoint / resume ------------------------------------------------
    #
    # The workspace *is* the solver's checkpoint (ref: run.jl:131-179 —
    # partialschur! with start_from): V holds the locked Schur vectors, H
    # the locked R block.

    def save(self, path):
        """Serialize to an .npz file (V and Vlo are copied to the host)."""
        extra = {}
        if self.Vlo is not None:
            extra["Vlo"] = self.Vlo.cpu().numpy()
        if self.Hlo is not None:
            extra["Hlo"] = np.asarray(self.Hlo)
        np.savez(
            path,
            V=self.V.cpu().numpy(),
            H=self.H,
            n=self.n,
            maxdim=self.maxdim,
            dtype=_numpy_name(self.V.dtype),
            **extra,
        )

    @classmethod
    def load(cls, path, device=None):
        """Restore a workspace saved with `save`, by this package or by the
        JAX package, with its extended-precision words (`Vlo`, `Hlo`).  A
        JAX split-complex checkpoint (real words V and `Vim`) loads as the
        complex basis V + i Vim, so its solve can be warm-started here."""
        with np.load(path, allow_pickle=False) as f:
            V, dtype = f["V"], str(f["dtype"])
            if "Vim" in f.files:
                if "Vlo" in f.files:
                    raise ValueError(
                        "checkpoint carries both 'Vlo' and 'Vim': no solve "
                        "writes double-word split-complex state"
                    )
                V = V + 1j * f["Vim"]
                dtype = "complex64" if dtype == "float32" else "complex128"
            ws = cls(
                int(f["n"]),
                int(f["maxdim"]),
                dtype=dtype,
                V=V,
                H=f["H"],
                device=device,
            )
            if "Vlo" in f.files:
                ws.Vlo = torch.from_numpy(np.array(f["Vlo"])).to(
                    dtype=ws.dtype, device=ws.device)
            if "Hlo" in f.files:
                ws.Hlo = np.array(f["Hlo"], dtype=np.float64)
            return ws
