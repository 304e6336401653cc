"""Scenario-batched solves: the batched step and its stats, on one device or
sharded over one process per device (torch.distributed)."""

from .sharding import (
    SCENARIO_AXIS,
    BatchStats,
    Mesh,
    gather_batch,
    initialize_multihost,
    make_batched_step,
    make_dp_train_step,
    make_mesh,
    replicate_inputs,
    shard_batch,
    shutdown,
    stack_tree,
)

__all__ = ["SCENARIO_AXIS", "BatchStats", "Mesh", "gather_batch", "initialize_multihost",
           "make_batched_step", "make_dp_train_step", "make_mesh", "replicate_inputs",
           "shard_batch", "shutdown", "stack_tree"]
