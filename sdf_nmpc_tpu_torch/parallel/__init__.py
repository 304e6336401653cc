"""Scenario-batched solves on one device (multi-device sharding is queued
in ROADMAP.md)."""

from .sharding import BatchStats, make_batched_step, replicate_inputs, stack_tree

__all__ = ["BatchStats", "make_batched_step", "replicate_inputs", "stack_tree"]
