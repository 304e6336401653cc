"""The flagship workload: the batched neural-SDF RTI step of BASELINE
config 4 (att quad, N = 20, the 4 x 256 NeuralDF with a 128-d latent, FoV
rows, the condensed QP), built as ``bench.py`` and ``scripts/e2e_tick.py``
build it.

Counterpart of __graft_entry__.py ``_build`` / ``entry``:

    cfg, ocp, step, states, inputs = build(batch=32)      # on the card
    fn, (states, inputs) = entry();  u0 = fn(states, inputs)

The network is the trained one of ``weights/`` when its widths match the
requested ones (and then the scenarios take its encoded-scene latents in
turn), else a seeded initialization (``torch.Generator`` seed 0) with seeded
latents; ``BENCH_RANDOM_WEIGHTS=1`` forces the latter.  Kernel 2's route is
``solver.sdf_fused_dtype``, read by the step.  The scenarios: random starts
near the origin (numpy ``default_rng(0)``, the JAX builder's draws in its
order), the flag on, the camera at the origin, goal (2, 0, 0) with the
constrained weights.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import resolve_device

LAYERS = (256, 256, 256, 256)


def bench_inputs(ocp, cfg, B: int, latents=None, seed: int = 0, device="cuda",
                 dtype=torch.float32):
    """SolveInputs of B scenarios: starts x0[:3] ~ 0.3 N(0, 1) at rest and
    level, the flag on, the camera at the origin, goal (2, 0, 0) with the
    constrained weights.  ``latents`` (n, L): scenario i takes row i mod n;
    None: each scenario draws 0.1 N(0, 1) after its start (the JAX
    builder's order)."""
    from .params import ParamLayout
    from .ref_gen import Ref
    from .solver import SolveInputs

    layout = ParamLayout.from_cfg(cfg)
    rng = np.random.default_rng(seed)
    N = ocp.N
    x0 = np.zeros((B, ocp.nx))
    x0[:, 3] = 1.0
    p = np.zeros((B, N + 1, layout.np_total))
    if latents is not None:
        x0[:, :3] = rng.normal(size=(B, 3)) * 0.3  # the same draws as B calls of size 3
        p[..., layout.latent_start:] = np.asarray(latents)[np.arange(B) % len(latents)][:, None]
    else:
        for i in range(B):
            x0[i, :3] = rng.normal(size=3) * 0.3
            layout.set_latent(p[i], rng.normal(size=layout.size_latent) * 0.1)
    layout.set_flag(p, 1.0)
    layout.set_camera(p, np.zeros(3), np.eye(3))
    layout.set_q_d(p, [1, 0, 0, 0])
    ref = Ref(cfg).use_constrained_weights(True)
    ref.p = np.array([2.0, 0.0, 0.0])
    yr, W = ocp.pack_ref(ref)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return SolveInputs(x0=T(x0), yref=T(np.tile(yr, (B, N, 1))), W=T(np.tile(W, (B, N, 1))),
                       yrefN=T(np.tile(yr[:ocp.nyN], (B, 1))),
                       WN=T(np.tile(W[:ocp.nyN], (B, 1))), p=T(p))


def build(cfg_overrides=None, latent: int = 128, batch: int = 32, layer_sizes=LAYERS,
          device="cuda", net=None):
    """(cfg, ocp, step, states, inputs) of the flagship workload on
    ``device``: ``step(states, inputs)`` is the cold RTI step without the
    per-node evaluations.  ``net``: a NeuralDF to use in place of the
    trained or seeded one (its latents are then seeded)."""
    from .config import default_config
    from .nn import NeuralDF
    from .nn.weights import load_prod_latents, load_prod_sdf
    from .ocp import build_ocp
    from .solver import init_state, make_rti_step

    dev = resolve_device(device)
    cfg = default_config().replace(nn=dict(size_latent=latent))
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    trained_lat = None
    if net is None and os.environ.get("BENCH_RANDOM_WEIGHTS", "") != "1":
        net = load_prod_sdf(require_latent=latent, require_layers=tuple(layer_sizes), device=dev)
        if net is not None:
            trained_lat = load_prod_latents()
    if net is None:
        net = NeuralDF(size_latent=latent, layer_sizes=tuple(layer_sizes),
                       generator=torch.Generator().manual_seed(0))
    ocp = build_ocp(cfg, sdf=net.to(dev), sdf_max_df=1.0, device=dev)
    step = make_rti_step(ocp, cfg, with_evals=False)
    inputs = bench_inputs(ocp, cfg, batch, trained_lat, seed=0, device=dev)
    return cfg, ocp, step, init_state(ocp, inputs.x0), inputs


def entry(device="cuda"):
    """(fn, (states, inputs)): ``fn(states, inputs)`` is u0 (32, nu) of one
    batched step of the flagship workload."""
    _, _, step, states, inputs = build(batch=32, device=device)

    def fn(states, inputs):
        return step(states, inputs).u0

    return fn, (states, inputs)
