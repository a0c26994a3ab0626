"""Device meshes, sharding descriptors and row-sharded operators.

The counterpart of arnoldimethod_tpu/parallel/mesh.py, SPMD over
torch.distributed: one process a device, each holding its contiguous n/P
rows of the operator and of the Krylov basis V, with H, Q and the dense
restart replicated.  A caller initializes the default process group (NCCL
across cards, gloo for CPU processes or processes that share one card),
then

    mesh = make_mesh()
    d, h = partial_schur(shard_operator(op, mesh), v1=v1,
                         sharding=basis_sharding(mesh), ...)

on every rank.  `d.Q` comes back as a DTensor placed Shard(0) on the mesh.
The collectives are parallel/comm.py's: a banded (DIA) matvec exchanges a
halo with the ranks its band reaches, a general sparse one
(ShardedCsrOperator) the footprint of its columns or all of x, dense and
ELL rows gather x, and any other operator runs whole on every rank behind
a wrapper that gathers x and keeps this rank's rows of the result (JAX returns such an operator
unchanged and lets its closures decide).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import _device as _dev
from ..models.operators import (
    CsrOperator,
    DenseOperator,
    DiaOperator,
    EllOperator,
    LinearOperator,
    RowShardedOperator,
    ShardedCsrOperator,
    dia_matvec_df,
)
from .comm import ROWS, RowComm

__all__ = [
    "GatheredOperator",
    "RowSharding",
    "basis_sharding",
    "distribute_rows",
    "make_mesh",
    "make_pod_mesh",
    "replicated_sharding",
    "row_comm",
    "shard_operator",
    "vector_sharding",
]


def make_mesh(n_devices=None):
    """A 1-D DeviceMesh, its dimension named "rows", over every rank of the
    initialized default process group, on the port's device type (the
    card; the CPU where the caller made that the default).  `n_devices`,
    when given, must be the world size."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs torch.distributed.init_process_group first "
            "(one process a device, NCCL or gloo)"
        )
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"requested a {n_devices}-device mesh but the process group has "
            f"{world} ranks: every rank of the group is one row shard"
        )
    return DeviceMesh(_dev.resolve().type, list(range(world)),
                      mesh_dim_names=(ROWS,))


def make_pod_mesh():
    """The `rows` mesh over the whole world (every host's ranks; the
    launcher, e.g. torchrun, gives each process its rank and address)."""
    return make_mesh()


class RowSharding:
    """A (mesh, placements) descriptor: where a tensor's dimensions lie on
    the mesh, as torch.distributed.tensor placements."""

    def __init__(self, mesh, placements):
        self.mesh = mesh
        self.placements = tuple(placements)

    def __repr__(self):
        return f"RowSharding({self.mesh}, {self.placements})"


def basis_sharding(mesh):
    """V (maxdim + 1, n): n on the `rows` dimension (Shard(1))."""
    from torch.distributed.tensor import Shard

    return RowSharding(mesh, (Shard(1),))


def vector_sharding(mesh):
    """A length-n vector on the `rows` dimension (Shard(0))."""
    from torch.distributed.tensor import Shard

    return RowSharding(mesh, (Shard(0),))


def replicated_sharding(mesh):
    """The same tensor on every rank (Replicate())."""
    from torch.distributed.tensor import Replicate

    return RowSharding(mesh, (Replicate(),))


def row_comm(sharding, n):
    """The RowComm of an n-row basis under `sharding`, which must be
    `basis_sharding(mesh)`; raises TypeError or ValueError otherwise."""
    from torch.distributed.tensor import Shard

    if not isinstance(sharding, RowSharding):
        raise TypeError(
            "sharding must be arnoldimethod_torch.parallel.basis_sharding("
            f"mesh), got {type(sharding).__name__}"
        )
    if sharding.placements != (Shard(1),):
        raise ValueError(
            "sharding must be basis_sharding(mesh) (V's n axis on the rows "
            f"dimension, Shard(1)), got placements {sharding.placements}"
        )
    return RowComm(sharding.mesh, n)


def distribute_rows(local, mesh):
    """A DTensor placed Shard(0) on `mesh` from this rank's rows."""
    from torch.distributed.tensor import DTensor, Shard

    return DTensor.from_local(local, mesh, (Shard(0),), run_check=False)


class _RowsOf(RowShardedOperator):
    """This rank's part of `op`: op's shape, dtype and device, and `comm`."""

    def __init__(self, op, comm):
        self.comm, self.shape = comm, op.shape
        self.dtype, self.device = op.dtype, op.device


class _ShardedDia(_RowsOf):
    """A DiaOperator's rows of this rank; the matvec takes the max(-offset)
    entries of x before the rank's rows and the max(offset) after them
    (the halo, from whichever ranks own them: a band may be wider than a
    rank's rows) and runs DiaOperator's shifted multiply-adds on the rank's
    rows, in its order; matvec_df the same with one halo exchange carrying
    both words."""

    def __init__(self, op, comm):
        super().__init__(op, comm)
        self.offsets = op.offsets
        self.diags = comm.local(op.diags.T).T.contiguous()
        self.lo = max(0, -min(self.offsets))
        self.hi = max(0, max(self.offsets))

    def matvec(self, x):
        n, lo = self.comm.n_local, self.lo
        xp = self.comm.halo(x, lo, self.hi)
        y = self.diags[0] * xp[lo + self.offsets[0]: lo + self.offsets[0] + n]
        for d in range(1, len(self.offsets)):
            off = self.offsets[d]
            y = y + self.diags[d] * xp[lo + off: lo + off + n]
        return y

    def matvec_df(self, xh, xl):
        xp = self.comm.halo(torch.stack((xh, xl), dim=1), self.lo, self.hi)
        return dia_matvec_df(self.diags, self.offsets, xp[:, 0], xp[:, 1],
                             self.lo)


class _ShardedEll(_RowsOf):
    """An EllOperator's rows of this rank; the matvec gathers x."""

    def __init__(self, op, comm):
        super().__init__(op, comm)
        self.data = comm.local(op.data).contiguous()
        self.cols = comm.local(op.cols).contiguous()

    def matvec(self, x):
        return (self.data * self.comm.gather_rows(x)[self.cols]).sum(dim=1)


class _ShardedDense(_RowsOf):
    """A DenseOperator's rows of this rank; the matvec gathers x."""

    def __init__(self, op, comm):
        super().__init__(op, comm)
        self.A = comm.local(op.A).contiguous()

    def matvec(self, x):
        return torch.mv(self.A, self.comm.gather_rows(x))


class GatheredOperator(_RowsOf):
    """Any operator on a row-sharded vector: the matvec gathers x, applies
    the whole operator on every rank (a Stencil5Operator launches its
    kernel on the full grid, a BsrOperator its kernel, a shift-invert its
    solve) and keeps this rank's rows.  Where the operator has matvec_df,
    so does the wrapper: one gather carrying both words, the operator's
    matvec_df (stencil5_df on the full grid), this rank's rows."""

    def __init__(self, op, comm):
        super().__init__(op, comm)
        self.op = op
        if hasattr(op, "matvec_df"):
            self.matvec_df = self._matvec_df

    def matvec(self, x):
        return self.comm.local(self.op.matvec(self.comm.gather_rows(x)))

    def _matvec_df(self, xh, xl):
        xh, xl = self.comm.gather_rows(torch.stack((xh, xl), dim=1)).T.contiguous()
        yh, yl = self.op.matvec_df(xh, xl)
        return self.comm.local(yh), self.comm.local(yl)


def shard_operator(op, mesh):
    """This rank's part of `op` on the `rows` mesh, a RowShardedOperator.
    A DiaOperator keeps its rows and exchanges a halo; an EllOperator or a
    DenseOperator keeps its rows and gathers x; a CsrOperator becomes a
    ShardedCsrOperator (`ShardedCsrOperator.build`, gather="auto"); any
    other LinearOperator runs whole behind `GatheredOperator`.

    The row count must divide evenly over the mesh: padding a spectral
    problem would perturb the spectrum, so the choice of padding (and its
    sentinel eigenvalue) belongs to the problem builder, not here."""
    if isinstance(op, RowShardedOperator):
        return op
    if not isinstance(op, LinearOperator):
        raise TypeError(
            f"shard_operator takes a LinearOperator, got {type(op).__name__}"
        )
    comm = RowComm(mesh, op.shape[0])
    if isinstance(op, DiaOperator):
        return _ShardedDia(op, comm)
    if isinstance(op, EllOperator):
        return _ShardedEll(op, comm)
    if isinstance(op, DenseOperator):
        return _ShardedDense(op, comm)
    if isinstance(op, CsrOperator):
        indptr, indices, data = op._host()
        return ShardedCsrOperator.build(indptr, indices, data, op.shape, mesh,
                                        device=op.device)
    return GatheredOperator(op, comm)
