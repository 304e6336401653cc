"""Scenario-parallel scale-out: one process per device, the scenario batch
sharded over them, the batch statistics reduced across them.

Counterpart of sdf_nmpc_tpu/parallel/sharding.py: ``SCENARIO_AXIS``,
``make_mesh``, ``initialize_multihost``, ``shard_batch``,
``make_batched_step`` with a mesh, ``BatchStats``, ``replicate_inputs`` and
``stack_tree``.  JAX shards a global array over the devices of one program;
the port runs one process per device on ``torch.distributed`` (NCCL between
cards, gloo on the CPU): every rank holds the same host batch, takes its
contiguous block of the scenario axis (JAX's ``P(SCENARIO_AXIS)`` layout),
runs the RTI step on it, and the counts and KKT statistics are all-reduced,
so every rank sees the global ``BatchStats``.  ``gather_batch`` collects a
sharded tree in rank order (``multihost_utils.process_allgather(tiled=True)``)
and ``make_dp_train_step`` is the data-parallel training step (parameters
from rank 0, gradients all-reduced and averaged).
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from .. import resolve_device
from ..solver import SolveInputs, SolverState, make_rti_step
from ..utils.timing import span

SCENARIO_AXIS = "scenario"
INIT_TIMEOUT_S = 300.0  # how long a rank waits for the others to join


class Mesh(NamedTuple):
    """This rank's view of the scenario mesh: its device, its rank, the
    number of ranks and their process group (None for a one-rank mesh
    outside ``torch.distributed``)."""

    device: torch.device
    rank: int
    size: int
    group: Optional[object] = None


def _group_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return resolve_device(f"cuda:{torch.cuda.current_device()}")
    return torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The 1-D scenario mesh over the initialized process group, or a
    one-rank mesh when no group is initialized.  ``n_devices``, if given,
    must be the group's size: each rank holds one device.

    device -- this rank's device; by default the group's device (the
              current card under NCCL, the CPU under gloo), or the card
              without a group."""
    grouped = dist.is_available() and dist.is_initialized()
    if device is not None:
        device = resolve_device(device)
    elif grouped:
        device = _group_device()
    else:
        device = resolve_device("cuda")
    if not grouped:
        if n_devices is not None and n_devices > 1:
            raise ValueError(f"a mesh of {n_devices} devices needs torch.distributed with "
                             f"{n_devices} ranks: call initialize_multihost first")
        return Mesh(device, 0, 1, None)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices} but the process group has {world} ranks, one "
                         "device each")
    return Mesh(device, rank, world, dist.group.WORLD)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device="cuda") -> Mesh:
    """Join ``torch.distributed`` and return the scenario mesh over every rank.

    Call once per process before building solvers.  The backend is NCCL for
    a CUDA ``device`` (this process pinned to ``cuda:<LOCAL_RANK>``, else to
    ``cuda:<process_id mod the host's cards>``, which assumes the ranks are
    numbered host by host; NCCL takes one rank per card) and gloo for the
    CPU.  With ``coordinator_address`` ('host:port') the group meets there
    with ``num_processes`` ranks, this one ``process_id``; without, it
    reads torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``).  End with ``shutdown()``."""
    kind = torch.device(device).type
    if kind == "cuda":
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = (process_id or 0) % max(torch.cuda.device_count(), 1)
        dev = resolve_device(f"cuda:{local}")
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev = resolve_device(device)
        backend = "gloo"
    kwargs = dict(backend=backend, timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    if coordinator_address is not None:
        kwargs.update(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                      rank=int(process_id))
    else:
        kwargs.update(init_method="env://")
    dist.init_process_group(**kwargs)
    return make_mesh(device=dev)


def shutdown():
    """Leave ``torch.distributed`` (no-op when no group is initialized)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class BatchStats(NamedTuple):
    n_ok: torch.Tensor  # () int: scenarios with OK status
    n_failed: torch.Tensor  # () int
    max_kkt: torch.Tensor  # ()
    mean_kkt: torch.Tensor  # ()


def make_batched_step(ocp, cfg, mesh: Optional[Mesh] = None, with_evals: bool = False,
                      budget: str = "cold"):
    """batched(states, inputs) -> (results, BatchStats).

    Without a mesh, on the OCP's device.  With one, ``states`` and
    ``inputs`` are this rank's shard (``shard_batch``) on ``mesh.device``
    and so are the results; the stats are the global batch's on every rank:
    the counts and the KKT sum (in float64) all-reduced by sum, the largest
    KKT residual by max, the mean the sum over the global B; the reduction
    and its all-reduces are the profiler span ``nmpc.scaleout.stats``.  Per-node
    diagnostics default off (they re-run the SDF network).  budget: the QP
    iteration schedule ("cold", "warm" or "steady")."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh (make_mesh, initialize_multihost), "
                        f"not {type(mesh).__name__}")
    step = make_rti_step(ocp, cfg, budget=budget, with_evals=with_evals)

    def batched(states: SolverState, inputs: SolveInputs):
        results = step(states, inputs)
        with span("nmpc.scaleout.stats"):
            return results, batch_stats(results)

    def batch_stats(results):
        ok = (results.status == 0).to(torch.int32)
        kkt = results.kkt_residual
        n_ok, n_failed = ok.sum(), (1 - ok).sum()
        if mesh is None:
            return BatchStats(n_ok=n_ok, n_failed=n_failed, max_kkt=kkt.amax(),
                              mean_kkt=kkt.mean())
        sums = torch.stack([n_ok.double(), n_failed.double(), kkt.double().sum()])
        top = kkt.amax()
        if mesh.group is not None:
            dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=mesh.group)
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mesh.group)
        mean = (sums[2] / (kkt.shape[0] * mesh.size)).to(kkt.dtype)
        return BatchStats(n_ok=sums[0].to(n_ok.dtype), n_failed=sums[1].to(n_failed.dtype),
                          max_kkt=top, mean_kkt=mean)

    return batched


def _map(fn, *trees):
    """fn over the leaves of matching NamedTuples, tuples, lists and dicts
    (None stays None)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[_map(fn, *leaves) for leaves in zip(*trees)])
    if isinstance(first, (tuple, list)):
        return type(first)(_map(fn, *leaves) for leaves in zip(*trees))
    if isinstance(first, dict):
        return {k: _map(fn, *[t[k] for t in trees]) for k in first}
    return fn(*trees)


def replicate_inputs(inputs: SolveInputs, batch: int) -> SolveInputs:
    """Tile single-scenario inputs along a new leading scenario axis."""
    return _map(lambda x: x[None].expand(batch, *x.shape).clone(), inputs)


def stack_tree(items):
    """Stack a list of identical NamedTuples along a new leading axis."""
    return _map(lambda *xs: torch.stack(xs), *items)


def shard_batch(tree, mesh: Mesh):
    """This rank's block of a batched tree (tensors or numpy arrays, the
    same on every rank) on its device: rows [r B / n, (r + 1) B / n) of
    every leaf, JAX's ``P(SCENARIO_AXIS)`` layout.  A B that the mesh's
    size does not divide raises."""

    def block(x):
        x = torch.as_tensor(x)
        B = x.shape[0]
        if B % mesh.size:
            raise ValueError(f"a batch of {B} does not split evenly over {mesh.size} devices")
        n = B // mesh.size
        return x[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device).contiguous()

    return _map(block, tree)


def gather_batch(tree, mesh: Mesh):
    """Every rank's shard of a batched tree, concatenated in rank order on
    this rank's device (the inverse of ``shard_batch``)."""

    def gather(x):
        if mesh.group is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x, group=mesh.group)
        return torch.cat(parts)

    return _map(gather, tree)


def _mse(pred, y):
    return torch.mean((pred - y) ** 2)


def make_dp_train_step(module: torch.nn.Module, optimizer, mesh: Mesh, loss_fn=_mse):
    """The data-parallel training step: step(x, y) -> the global loss.

    ``module``'s parameters are broadcast from rank 0 here, once.  Each
    step takes this rank's shard (x, y), the loss ``loss_fn(module(x), y)``
    (default the mean squared error) and its gradients; the gradients are
    all-reduced in one flat buffer and divided by the number of ranks (with
    equal shards, the full batch's mean), then ``optimizer`` steps.  The
    returned loss is the ranks' mean, the same on every rank."""
    params = [p for p in module.parameters() if p.requires_grad]
    if mesh.group is not None:
        with torch.no_grad():
            for p in params:
                dist.broadcast(p, src=0, group=mesh.group)

    def step(x, y):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(module(x), y)
        loss.backward()
        if mesh.group is not None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
            flat /= mesh.size
            offset = 0
            for p, g in zip(params, grads):
                p.grad = flat[offset:offset + g.numel()].view_as(p)
                offset += g.numel()
        optimizer.step()
        loss = loss.detach()
        if mesh.group is not None:
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=mesh.group)
            loss /= mesh.size
        return loss

    return step
