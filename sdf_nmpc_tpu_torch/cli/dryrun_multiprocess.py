"""Multi-process dry run of the scale-out path on torch.distributed
(counterpart of scripts/dryrun_multiprocess.py and
__graft_entry__.py::dryrun_multichip):

    python -m sdf_nmpc_tpu_torch.cli.dryrun_multiprocess --device cpu   # 2 gloo ranks
    python -m sdf_nmpc_tpu_torch.cli.dryrun_multiprocess --device cuda  # 1 NCCL rank per card

The parent picks a free loopback port and starts N processes.  Each joins the
group through ``parallel.initialize_multihost`` and then:

1. solves one sharded batch of 2 N scenarios at the dry run's sizes (N = 4
   nodes, 4 QP iterations, a 16-wide 4-layer NeuralDF with an 8-d latent):
   every rank builds the same seeded batch and takes its block; the
   gathered u0 must equal the single-process step on the full batch within
   1e-5 (f32) and every scenario must solve;
2. takes one data-parallel AdamW step (lr 1e-3, optax ``adamw``'s weight
   decay 1e-4 and eps 1e-8) of a NeuralDF on a sharded batch of 8 N rows
   (MSE), which must equal the single-process step on the full batch within
   1e-5;
3. prints ``[p<rank>] ok: ...``.

NCCL takes one rank per card: ``--device cuda`` needs as many cards as
processes.
"""

from __future__ import annotations

import argparse
import copy
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
TOL_U0 = 1e-5  # the JAX dry run's tolerance (f32)
TOL_TRAIN = 1e-5
LATENT = 8
LAYERS = (16, 16, 16, 16)


def build_dryrun(batch: int, device, dtype=None, latent: int = LATENT, layer_sizes=LAYERS,
                 cfg_overrides=None, seed: int = 0):
    """(cfg, ocp, states, inputs) of the dry run: the flagship workload
    (``entry.bench_inputs``) at small sizes with a seeded random NeuralDF
    (torch's draw), random starts near the origin, seeded latents, goal
    (2, 0, 0) with the constrained weights; host tensors (numpy-made), the
    same on every rank."""
    import torch

    from ..config import default_config
    from ..entry import bench_inputs
    from ..nn import NeuralDF
    from ..ocp import build_ocp
    from ..solver import init_state

    over = cfg_overrides if cfg_overrides is not None else dict(mpc=dict(N=4),
                                                                solver=dict(qp_iters=4))
    cfg = default_config().replace(nn=dict(size_latent=latent)).replace(**over)
    dt = dtype or getattr(torch, cfg.solver.dtype)
    net = NeuralDF(size_latent=latent, layer_sizes=layer_sizes,
                   generator=torch.Generator().manual_seed(seed))
    ocp = build_ocp(cfg, sdf=net.to(device=device, dtype=dt), sdf_max_df=1.0, device=device)
    inputs = bench_inputs(ocp, cfg, batch, None, seed, device="cpu", dtype=dt)
    return cfg, ocp, init_state(ocp, inputs.x0, dt), inputs


def _child(rank: int, world: int, port: int, device: str) -> None:
    import torch

    torch.set_num_threads(1)
    from ..nn import NeuralDF
    from ..parallel import (Mesh, gather_batch, initialize_multihost, make_batched_step,
                            make_dp_train_step, shard_batch, shutdown)

    mesh = initialize_multihost(f"127.0.0.1:{port}", world, rank, device=device)
    try:
        dev = mesh.device
        whole = Mesh(dev, 0, 1)  # the single-process reference: the full batch, no group
        # ---- 1. sharded batched solve
        batch = 2 * world
        cfg, ocp, states, inputs = build_dryrun(batch, dev)
        results, stats = make_batched_step(ocp, cfg, mesh=mesh)(shard_batch(states, mesh),
                                                                 shard_batch(inputs, mesh))
        u0 = gather_batch(results.u0, mesh)
        n_ok = int(stats.n_ok)
        if n_ok != batch:
            raise AssertionError(f"[p{rank}] sharded solve failed: {stats}")
        plain, _ = make_batched_step(ocp, cfg)(shard_batch(states, whole),
                                               shard_batch(inputs, whole))
        d_u0 = float((u0 - plain.u0).abs().max())
        if d_u0 > TOL_U0:
            raise AssertionError(f"[p{rank}] sharded u0 differs from the single-process u0 "
                                 f"by {d_u0}")

        # ---- 2. data-parallel training step
        B = 8 * world
        rng = np.random.default_rng(1)
        x = rng.normal(size=(B, 3 + LATENT)).astype(np.float32)
        y = rng.normal(size=(B, 1)).astype(np.float32)
        net = NeuralDF(size_latent=LATENT, layer_sizes=LAYERS,
                       generator=torch.Generator().manual_seed(1)).to(dev)
        ref = copy.deepcopy(net)
        opt = lambda m: torch.optim.AdamW(m.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8)
        step = make_dp_train_step(net, opt(net), mesh)
        loss = float(step(*shard_batch((x, y), mesh)))
        ref_loss = float(make_dp_train_step(ref, opt(ref), whole)(*shard_batch((x, y), whole)))
        d_loss = abs(loss - ref_loss)
        d_params = max(float((a - b).abs().max())
                       for a, b in zip(net.state_dict().values(), ref.state_dict().values()))
        if d_loss > TOL_TRAIN or d_params > TOL_TRAIN:
            raise AssertionError(f"[p{rank}] DP train step mismatch: d_loss={d_loss} "
                                 f"d_params={d_params}")
        print(f"[p{rank}] ok: {world} ranks ({torch.distributed.get_backend()}, {dev}), "
              f"{batch} scenario solves sharded (n_ok={n_ok}, d_u0={d_u0:.2e}), DP train loss "
              f"{loss:.6f} (d_loss={d_loss:.2e}, d_params={d_params:.2e})", flush=True)
    finally:
        shutdown()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(n_proc: int = 2, device: str = "cuda", timeout_s: float = 600.0) -> int:
    """Start the ranks, wait for them, print their output; 0 if every rank
    printed its ok line."""
    if device.startswith("cuda"):
        import torch

        if torch.cuda.device_count() < n_proc:
            raise RuntimeError(f"{n_proc} NCCL ranks need {n_proc} cards, this host has "
                               f"{torch.cuda.device_count()}: NCCL takes one rank per card")
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-m", "sdf_nmpc_tpu_torch.cli.dryrun_multiprocess",
                               "--child", str(i), "--port", str(port), "--nproc", str(n_proc),
                               "--device", device],
                              cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for i in range(n_proc)]
    rc = 0
    try:
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout_s)
            sys.stdout.write(out)
            if p.returncode != 0 or f"[p{i}] ok:" not in out:
                rc = 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"dryrun_multiprocess {'ok' if rc == 0 else 'FAILED'}: {n_proc} processes on "
          f"{device}, coordinator 127.0.0.1:{port}", flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (NCCL, default) or 'cpu' (gloo)")
    ap.add_argument("--nproc", type=int, default=2, help="number of processes (ranks)")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds to wait for the ranks")
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        _child(args.child, args.nproc, args.port, args.device)
        return 0
    return run(args.nproc, args.device, args.timeout)


if __name__ == "__main__":
    raise SystemExit(main())
