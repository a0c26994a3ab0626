"""Row-sharded solves over torch.distributed (the JAX package's
`arnoldimethod_tpu.parallel`): `partial_schur(shard_operator(op, mesh),
sharding=basis_sharding(mesh))` on every rank of a `make_mesh()` mesh.
`COLLECTIVES` counts the collectives the solve made, by kind."""

from .comm import COLLECTIVES
from .mesh import (
    basis_sharding,
    make_mesh,
    make_pod_mesh,
    replicated_sharding,
    row_comm,
    shard_operator,
    vector_sharding,
)

__all__ = [
    "make_mesh",
    "make_pod_mesh",
    "basis_sharding",
    "vector_sharding",
    "replicated_sharding",
    "shard_operator",
    "COLLECTIVES",
    "row_comm",
]
