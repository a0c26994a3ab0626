"""Arnoldi workspace: the large arrays of the solver and their ownership.

The n-sized Krylov basis V lives on the device as a (maxdim+1, n) tensor
(vectors are rows), while the (maxdim+1) x maxdim Hessenberg matrix H is
authoritative on the host in float64/complex128: the dense restart kernels
run there and only freshly expanded columns round-trip through the device
dtype.  The solver updates V in place, so the workspace owns its storage.

A sharded workspace (`sharding=basis_sharding(mesh)`) holds this rank's
columns of V, (maxdim+1, n/P), on every rank of the mesh; H stays whole on
every rank.

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

    With `sharding` (`parallel.basis_sharding(mesh)`), V is this rank's
    (maxdim+1, n/P) columns (a V given is the global one, and each rank
    keeps its columns) and `comm` the partition (`parallel.comm.RowComm`).
    """

    def __init__(self, n, maxdim, dtype=torch.float32, V=None, H=None,
                 device=None, sharding=None):
        if maxdim > n:
            raise ValueError("Krylov dimension should be less than matrix order.")
        if maxdim < 1:
            raise ValueError("Krylov dimension must be at least 1.")
        self.n = int(n)
        self.maxdim = int(maxdim)
        dtype = as_torch_dtype(dtype)
        device = _dev.resolve(device, like=V)
        self.sharding = sharding
        self.comm = None
        n_local = self.n
        if sharding is not None:
            from .parallel.mesh import row_comm  # it imports this module

            self.comm = row_comm(sharding, self.n)
            n_local = self.comm.n_local

        if V is None:
            V = torch.zeros((maxdim + 1, n_local), dtype=dtype, device=device)
        else:
            V = torch.as_tensor(V)
            if tuple(V.shape) != (maxdim + 1, n):
                raise ValueError(
                    f"V must have shape {(maxdim + 1, n)}, got {tuple(V.shape)}"
                )
            if self.comm is not None:
                V = self.comm.local(V.T).T
            # Copy: the solver updates V in place, so the workspace must
            # own its storage, not alias the caller's.
            V = V.to(dtype=dtype, device=device, copy=True).contiguous()
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
        """Serialize to an .npz file (V and Vlo are copied to the host).
        Sharded, every rank calls it: V and Vlo are gathered and rank 0
        writes the global checkpoint, the same file an unsharded save
        writes."""
        V, Vlo = self.V, self.Vlo
        if self.comm is not None:
            V = self.comm.gather_rows(V.T).T
            if Vlo is not None:
                Vlo = self.comm.gather_rows(Vlo.T).T
            if self.comm.rank != 0:
                return
        extra = {}
        if Vlo is not None:
            extra["Vlo"] = Vlo.cpu().numpy()
        if self.Hlo is not None:
            extra["Hlo"] = np.asarray(self.Hlo)
        np.savez(
            path,
            V=V.cpu().numpy(),
            H=self.H,
            n=self.n,
            maxdim=self.maxdim,
            dtype=_numpy_name(self.V.dtype),
            **extra,
        )

    @classmethod
    def load(cls, path, device=None, sharding=None):
        """Restore a workspace saved with `save`, by this package or by the
        JAX package, with its extended-precision words (`Vlo`, `Hlo`).  A
        JAX split-complex checkpoint (real words V and `Vim`) loads as the
        complex basis V + i Vim, so its solve can be warm-started here.
        With `sharding`, every rank reads the file and keeps its columns."""
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
                sharding=sharding,
            )
            if "Vlo" in f.files:
                Vlo = torch.from_numpy(np.array(f["Vlo"]))
                if ws.comm is not None:
                    Vlo = ws.comm.local(Vlo.T).T
                ws.Vlo = Vlo.to(dtype=ws.dtype, device=ws.device).contiguous()
            if "Hlo" in f.files:
                ws.Hlo = np.array(f["Hlo"], dtype=np.float64)
            return ws
