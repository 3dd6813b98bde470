"""Data and tensor parallelism on torch.distributed (counterpart of
fresnel_tpu/parallel/): the mesh and data-parallel helpers (`mesh`), the
tensor-parallel state sharding (`tp`), the three sharded renders
(`render`) and the process launch (`launch`)."""

from fresnel_tpu_torch.parallel.mesh import (
    get_mesh,
    shard_batch,
    replicate,
    data_parallel_step,
    jit_data_parallel,
    pmean_gradients,
)
from fresnel_tpu_torch.parallel.tp import (
    infer_leaf_spec,
    infer_state_specs,
    shard_state,
    sharded_fraction,
)

__all__ = [
    "get_mesh", "shard_batch", "replicate", "data_parallel_step",
    "jit_data_parallel", "pmean_gradients",
    "infer_leaf_spec", "infer_state_specs", "shard_state",
    "sharded_fraction",
]
