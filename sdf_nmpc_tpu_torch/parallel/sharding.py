"""Scenario-batched solves on one device: the batched step and its stats.

Counterpart of sdf_nmpc_tpu/parallel/sharding.py ``make_batched_step``
(:76-107), ``BatchStats``, ``replicate_inputs`` and ``stack_tree``.  The
port's step is batch-first already, so the batched step is the RTI step plus
the batch statistics.  Sharding the scenario axis over several cards is not
ported: a ``mesh`` argument raises (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..solver import SolveInputs, SolverState, make_rti_step


class BatchStats(NamedTuple):
    n_ok: torch.Tensor  # () int: scenarios with OK status
    n_failed: torch.Tensor  # () int
    max_kkt: torch.Tensor  # ()
    mean_kkt: torch.Tensor  # ()


def make_batched_step(ocp, cfg, mesh=None, with_evals: bool = False, budget: str = "cold"):
    """batched(states, inputs) -> (results, BatchStats) on the OCP's device.

    Per-node diagnostics default off (they re-run the SDF network).  budget:
    the QP iteration schedule ("cold", "warm" or "steady")."""
    if mesh is not None:
        raise NotImplementedError(
            "sharding the scenario axis over several devices is not ported; it is queued "
            "in ROADMAP.md")
    step = make_rti_step(ocp, cfg, budget=budget, with_evals=with_evals)

    def batched(states: SolverState, inputs: SolveInputs):
        results = step(states, inputs)
        ok = (results.status == 0).to(torch.int32)
        stats = BatchStats(n_ok=ok.sum(), n_failed=(1 - ok).sum(),
                           max_kkt=results.kkt_residual.amax(),
                           mean_kkt=results.kkt_residual.mean())
        return results, stats

    return batched


def _map(fn, *trees):
    """fn over the tensor leaves of matching NamedTuples (None stays None)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*[_map(fn, *leaves) for leaves in zip(*trees)])
    return fn(*trees)


def replicate_inputs(inputs: SolveInputs, batch: int) -> SolveInputs:
    """Tile single-scenario inputs along a new leading scenario axis."""
    return _map(lambda x: x[None].expand(batch, *x.shape).clone(), inputs)


def stack_tree(items):
    """Stack a list of identical NamedTuples along a new leading axis."""
    return _map(lambda *xs: torch.stack(xs), *items)
