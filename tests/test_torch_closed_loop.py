"""Batched closed-loop simulation (sim/closed_loop.py) on tests/test_sim.py's
setup: latent 8, qp_iters 10, f64, one sphere at (1.2, 0.05, 0) of radius
0.35 straight on the path to the goal, its scene oracle as the SDF row.
The port's rollouts against the JAX package's over the first ticks, then
that file's outcome rules on the port's own rollouts."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SPHERE = ([1.2, 0.05, 0.0], 0.35)
FIRST = 10  # ticks held against the JAX rollout (ROADMAP.md section 3's chained-tick watch)


@functools.lru_cache(maxsize=None)
def _setup():
    """(JAX cfg, JAX ocp, port cfg, port ocp) of tests/test_sim.py's
    avoid_setup, the port's scene oracle on the CPU in f64."""
    from sdf_nmpc_tpu.config import default_config as jcfg
    from sdf_nmpc_tpu.ocp import build_ocp as jbuild
    from sdf_nmpc_tpu.sim import Scene as JScene
    from sdf_nmpc_tpu.sim import make_scene_sdf_fn as jfn
    from sdf_nmpc_tpu_torch.config import default_config as tcfg
    from sdf_nmpc_tpu_torch.ocp import build_ocp as tbuild
    from sdf_nmpc_tpu_torch.sim import Scene, make_scene_sdf_fn

    upd = dict(nn=dict(size_latent=8), solver=dict(dtype="float64", qp_iters=10))
    jc, tc = jcfg().replace(**upd), tcfg().replace(**upd)
    jocp = jbuild(jc, sdf_fn=jfn(JScene.make(spheres=[SPHERE]), max_df=1.0), sdf_max_df=1.0)
    tocp = tbuild(tc, sdf=make_scene_sdf_fn(Scene.make(spheres=[SPHERE], device="cpu"),
                                            max_df=1.0), sdf_max_df=1.0, device="cpu")
    return jc, jocp, tc, tocp


def _scene():
    from sdf_nmpc_tpu_torch.sim import Scene

    return Scene.make(spheres=[SPHERE], device="cpu").to(torch.float64)


def _world_sdf(p):
    from sdf_nmpc_tpu_torch.sim import scene_sdf

    return scene_sdf(_scene(), p)


def _inputs(flag, x0s):
    """tests/test_sim.py's inputs for each start in x0s (B, nx): the JAX
    SolveInputs stacked, and the port's (leading B)."""
    from sdf_nmpc_tpu_torch.solver import SolveInputs
    from test_sdf_nmpc import build_inputs

    jc, jocp, _, _ = _setup()
    one = [build_inputs(jc, jocp, x0, flag=flag, constrained_weights=False) for x0 in x0s]
    jin = jax.tree.map(lambda *xs: jnp.stack(xs), *one)
    return jin, SolveInputs(*[torch.as_tensor(np.array(a), dtype=torch.float64) for a in jin])


def _hover(B=1):
    x = np.zeros((B, 10))
    x[:, 3] = 1.0
    return x


@functools.lru_cache(maxsize=None)
def _jax_rollout():
    """The JAX rollout over the first FIRST ticks, jitted once for the module."""
    from sdf_nmpc_tpu.sim import Scene, make_closed_loop, scene_sdf

    jc, jocp, _, _ = _setup()
    scene = Scene.make(spheres=[SPHERE])
    return jax.jit(jax.vmap(make_closed_loop(jocp, jc, n_ticks=FIRST,
                                             scene_sdf_fn=lambda p: scene_sdf(scene, p))))


@functools.lru_cache(maxsize=None)
def _port_rollout(flag, n_ticks=120):
    from sdf_nmpc_tpu_torch.sim import make_closed_loop

    _, _, tc, tocp = _setup()
    jin, tin = _inputs(flag, _hover())
    res = make_closed_loop(tocp, tc, n_ticks=n_ticks, scene_sdf_fn=_world_sdf)(
        torch.as_tensor(_hover()), tin)
    return jin, res


def test_rollout_follows_jax_then_avoids_the_obstacle():
    """The port's B = 1 rollout against the JAX rollout: xs within 1e-6 over
    the first FIRST ticks; then tests/test_sim.py's outcome rules on the
    port's 120 ticks: every status OK, min clearance > 0, tracking error <
    0.35, a lateral excursion beyond 0.15."""
    jin, res = _port_rollout(1.0)
    want = _jax_rollout()(jnp.asarray(_hover()), jin)
    np.testing.assert_allclose(res.xs[:, :FIRST + 1].numpy(), np.asarray(want.xs), atol=1e-6,
                               rtol=0)
    assert res.xs.shape == (1, 121, 10) and res.us.shape == (1, 120, 4)
    assert int(res.statuses.sum()) == 0
    assert float(res.min_clearance) > 0.0, "collided with the obstacle"
    assert float(res.tracking_error) < 0.35, f"missed goal: {float(res.tracking_error)}"
    assert float(res.xs[0, :, 1].abs().max()) > 0.15


def test_rollout_without_sdf_hits_the_obstacle():
    """The flag off drives straight through the sphere: clearance < 0, the
    constraint was load-bearing (tests/test_sim.py); the first ticks as
    the JAX rollout's at 1e-6."""
    jin, res = _port_rollout(0.0)
    want = _jax_rollout()(jnp.asarray(_hover()), jin)
    np.testing.assert_allclose(res.xs[:, :FIRST + 1].numpy(), np.asarray(want.xs), atol=1e-6,
                               rtol=0)
    assert float(res.min_clearance) < 0.0


def test_batched_monte_carlo():
    """B = 6 starts, y jittered by +-0.3 (tests/test_sim.py's draw), 60
    ticks: summarize gives n 6, success 1.0 and collision 0.0."""
    from sdf_nmpc_tpu_torch.sim import make_closed_loop, summarize

    _, _, tc, tocp = _setup()
    B = 6
    x0s = _hover(B)
    x0s[:, 1] += np.random.default_rng(0).uniform(-0.3, 0.3, B)
    _, tin = _inputs(1.0, x0s)
    res = make_closed_loop(tocp, tc, n_ticks=60, scene_sdf_fn=_world_sdf)(
        torch.as_tensor(x0s), tin)
    stats = summarize(res)
    assert stats["n"] == B
    assert stats["success_rate"] == 1.0
    assert stats["collision_rate"] == 0.0


def test_a_batch_equals_its_single_rollouts():
    """Three starts rolled out as one batch and one by one (B = 1): the
    same trajectories, the clearance per rollout with a scene per rollout
    (the (p, scene) form, a Scene batch) as with the one scene.  Held at
    1e-6, as the JAX rollout: a batched product rounds otherwise than a
    single one (1e-16), and 8 chained ticks with the SDF row active carry
    that to ~1e-9 (ROADMAP.md section 3's chained-tick watch)."""
    from sdf_nmpc_tpu_torch.sim import Scene, make_closed_loop, scene_sdf

    _, _, tc, tocp = _setup()
    x0s = _hover(3)
    x0s[:, 1] += [-0.2, 0.05, 0.25]
    _, tin = _inputs(1.0, x0s)
    scenes = Scene.stack([_scene()] * 3)
    batch = make_closed_loop(tocp, tc, n_ticks=8, scene_sdf_fn=lambda p, s: scene_sdf(s, p))(
        torch.as_tensor(x0s), tin, scenes)
    single = make_closed_loop(tocp, tc, n_ticks=8, scene_sdf_fn=_world_sdf)
    for b in range(3):
        one = single(torch.as_tensor(x0s[b:b + 1]), type(tin)(*[t[b:b + 1] for t in tin]))
        for name in ("xs", "us", "statuses", "min_clearance", "tracking_error"):
            np.testing.assert_allclose(getattr(batch, name)[b].numpy(),
                                       getattr(one, name)[0].numpy(), atol=1e-6, rtol=0,
                                       err_msg=f"rollout {b} {name}")


def _observe_jax(x, sc):
    """tests/test_sim.py's stand-in observation: the camera at the body, its
    attitude, a 10 x 16 render, the latent its mean."""
    from sdf_nmpc_tpu.math import quat2rot
    from sdf_nmpc_tpu.sim import render_range_image

    W_R_B = quat2rot(x[3:7] / jnp.linalg.norm(x[3:7]))
    img = render_range_image(sc, x[:3], W_R_B, 10, 16, 0.7592, 0.4903, 5.0, n_steps=16)
    return x[:3], W_R_B, jnp.full(8, jnp.mean(img))


def _observe_port(x, sc):
    """The same observation, batched: (B, 3), (B, 3, 3), (B, 8)."""
    from sdf_nmpc_tpu_torch.math import quat2rot
    from sdf_nmpc_tpu_torch.sim import render_range_image

    W_R_B = quat2rot(x[:, 3:7] / torch.linalg.vector_norm(x[:, 3:7], dim=-1, keepdim=True))
    lat = []
    for b in range(x.shape[0]):
        img = render_range_image(type(sc)(*[a[b] for a in sc]), x[b, :3], W_R_B[b], 10, 16,
                                 0.7592, 0.4903, 5.0, n_steps=16)
        lat.append(img.mean().expand(8))
    return x[:, :3], W_R_B, torch.stack(lat)


def test_perception_in_the_loop():
    """tests/test_sim.py's perception loop, 6 chunks of 10 ticks, each chunk
    re-rendering from the current pose: xs of shape (61, 10) per rollout,
    every status OK, finite; the first chunk's xs within 1e-6 of the JAX
    rollout from the JAX observation of the same start."""
    from sdf_nmpc_tpu.params import ParamLayout
    from sdf_nmpc_tpu.sim import Scene as JScene
    from sdf_nmpc_tpu_torch.sim import Scene, make_closed_loop_perception, scene_sdf

    jc, _, tc, tocp = _setup()
    jin, tin = _inputs(1.0, _hover())
    scene = Scene.stack([_scene()])
    res = make_closed_loop_perception(
        tocp, tc, n_chunks=6, ticks_per_chunk=FIRST, observe_fn=_observe_port,
        scene_sdf_fn=lambda p, sc: scene_sdf(sc, p))(torch.as_tensor(_hover()), tin, scene)
    assert res.xs.shape == (1, 61, 10)
    assert int(res.statuses.sum()) == 0
    assert torch.isfinite(res.xs).all()

    lay = ParamLayout.from_cfg(jc)
    W_p_Co, W_R_Co, latent = _observe_jax(jnp.asarray(_hover()[0]),
                                          JScene.make(spheres=[SPHERE]))
    p = np.array(jin.p)
    lay.set_camera(p, np.asarray(W_p_Co), np.asarray(W_R_Co))
    lay.set_latent(p, np.asarray(latent))
    want = _jax_rollout()(jnp.asarray(_hover()), jin._replace(p=jnp.asarray(p)))
    np.testing.assert_allclose(res.xs[:, :FIRST + 1].numpy(), np.asarray(want.xs), atol=1e-6,
                               rtol=0)
