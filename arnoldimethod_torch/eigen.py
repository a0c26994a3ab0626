"""partial_eigen: turn a partial Schur decomposition into eigenpairs.

LAPACK-free like the JAX package's version: the eigenvectors of the small
(quasi-)triangular R come from the shifted backward substitution of
dense/eig.py on the host, and the n-sized back-transformation X = Q @ S is
one torch.matmul on the basis's device, in full FP32.  A sharded Q (a
DTensor placed Shard(0), from `partial_schur(..., sharding=...)`) gives
sharded eigenvectors: each rank multiplies its own rows, with no
collective.

The reference's documented caveats carry over: unnecessary (and for
repeated eigenvalues potentially orthogonality-losing) for Hermitian
problems, whose Schur vectors are already eigenvectors
(ref: eigvals.jl:72-81).
"""

from __future__ import annotations

import numpy as np
import torch

from .dense.eig import collect_eigen, eigenvalues
from .driver import PartialSchur
from .ops.expansion import fp32_matmul

__all__ = ["partial_eigen"]


def partial_eigen(decomp: PartialSchur):
    """Return (values, vectors): values is a complex (or real, if the
    spectrum is real) numpy vector of length k, vectors an (n, k) tensor on
    the basis's device with unit-norm columns satisfying
    A @ vectors ~= vectors * values.  A real basis with complex pairs in
    its spectrum gives complex vectors.  A DTensor Q gives a DTensor of
    vectors on the same mesh and placements."""
    R = np.asarray(decomp.R)
    k = R.shape[0]
    if k == 0:
        return np.zeros(0), decomp.Q

    vals = eigenvalues(R)
    S = np.zeros((k, k), dtype=complex)
    buf = np.zeros(k, dtype=complex)
    for j in range(k):
        buf[:] = 0
        klen = collect_eigen(buf, R, j)
        col = np.zeros(k, dtype=complex)
        col[:klen] = buf[:klen]
        if not np.iscomplexobj(R) and j > 0 and R[j, j - 1] != 0:
            # Second member of a conjugate pair: conjugate eigenvector.
            col = np.conj(col)
        S[:, j] = col

    Q = decomp.Q
    mesh = getattr(Q, "device_mesh", None)
    if mesh is not None:
        placements, Q = Q.placements, Q.to_local()
    if bool(np.all(vals.imag == 0)):
        vals = vals.real
        S = S.real
    elif not Q.is_complex():
        Q = Q.to(torch.complex64 if Q.dtype == torch.float32
                 else torch.complex128)
    with fp32_matmul():
        X = torch.matmul(Q, torch.as_tensor(S).to(dtype=Q.dtype,
                                                  device=Q.device))
    if mesh is not None:
        from torch.distributed.tensor import DTensor

        X = DTensor.from_local(X, mesh, placements, run_check=False)
    return vals, X
