"""Device mesh, sharding specs and the collectives of data-parallel
training over ``torch.distributed`` (the counterpart of
:mod:`reprover_tpu.parallel`)."""

from reprover_tpu_torch.parallel.mesh import Mesh, init_distributed, local_mesh, make_mesh
from reprover_tpu_torch.parallel.sharding import (
    batch_sharding,
    causal_param_partition_specs,
    param_partition_specs,
    replicated,
    shard_pytree,
    zero_partition_specs,
)

__all__ = [
    "Mesh",
    "init_distributed",
    "make_mesh",
    "local_mesh",
    "batch_sharding",
    "causal_param_partition_specs",
    "param_partition_specs",
    "replicated",
    "shard_pytree",
    "zero_partition_specs",
]
