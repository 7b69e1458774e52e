"""Sharding of the port: the rules mapping every parameter, cache and input
leaf to a partition spec (``rules``, the port of ``repro.sharding.rules``),
the sharded train step on DTensors in those placements (``dtensor``), and
the model's tensor-parallel pieces (``tensor_parallel``)."""
from repro_torch.sharding.rules import (
    MeshAxes,
    Spec,
    batch_specs,
    cache_specs,
    param_specs,
    placements,
    train_state_specs,
)
from repro_torch.sharding.dtensor import (
    check_tensor_parallel,
    fsdp_gathered,
    full_params,
    shard_batch,
    shard_caches,
    shard_state,
    sharded_serving,
    sharded_step,
)
