"""The port's training and evaluation pipelines (``sdf_nmpc_tpu_torch/cli``:
train_synthetic, train_latent_sdf, train_prod_perception, df_test, vae_test,
df_viz_3d, df_viz_img) against the JAX scripts, f64 on the CPU: the same
scenes from the same seeds, one update of each trainer on the same points
(or images and latent noise), the learned-SDF closed loop, the sphere trace
and the closest-point projection; then each pipeline end to end at small
sizes under --device cpu, its artifacts read back by flax and by the port's
loaders."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_port import jax_net, one_torch_thread, port_net, t64  # noqa: F401
from test_torch_training import _draw_vae, images

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

L = 8
LAYERS = (16, 16, 16, 16)
STEP_TOL = dict(rtol=1e-10, atol=1e-10)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _net64(module, variables):
    """The port's NeuralDF with the flax variables, built in f64 before the
    load (values that f32 cannot hold arrive whole)."""
    from sdf_nmpc_tpu_torch.nn import NeuralDF
    from sdf_nmpc_tpu_torch.nn.weights import params_from_jax

    net = NeuralDF(size_latent=module.size_latent, layer_sizes=module.layer_sizes,
                   embed=module.embed, act=module.act, w0=module.w0).double()
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables)))
    return net


def _state_close(net, variables, **tol):
    from sdf_nmpc_tpu_torch.nn.weights import params_from_jax

    want = params_from_jax(jax.tree.map(np.asarray, variables))
    for name, p in net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), **tol, err_msg=name)


def _scene_arrays(scene):
    return [np.asarray(a) for a in scene]


def test_scenes_match_jax():
    """random_scene and generate_scenes (blocking or not) draw the JAX
    scripts' scenes from the same seeds, to the bit."""
    from train_latent_sdf import generate_scenes as j_generate
    from train_synthetic import random_scene as j_random

    from sdf_nmpc_tpu_torch.cli.train_latent_sdf import generate_scenes
    from sdf_nmpc_tpu_torch.cli.train_synthetic import random_scene

    for seed in (0, 3):
        got = random_scene(np.random.default_rng(seed), device="cpu")
        for a, b in zip(got, _scene_arrays(j_random(np.random.default_rng(seed)))):
            np.testing.assert_array_equal(a.numpy(), b)
    for kw in (dict(seed=1), dict(seed=999, blocking=True)):
        for got, want in zip(generate_scenes(4, device="cpu", **kw), j_generate(4, **kw)):
            for a, b in zip(got, _scene_arrays(want)):
                np.testing.assert_array_equal(a.numpy(), b)


def test_sdf_update_matches_flax_adam():
    """One train_sdf_on_scene update on the same points (numpy-drawn, in the
    frustum and the ball): the loss and every parameter within 1e-10 of
    flax + optax.adam(3e-4) on the JAX script's loss."""
    from sdf_nmpc_tpu.sim import scene_sdf as j_scene_sdf
    from train_synthetic import random_scene as j_random

    from sdf_nmpc_tpu_torch.cli.train_synthetic import random_scene, sdf_update

    module, variables = jax_net(size_latent=L, layer_sizes=LAYERS, w0=8.0, seed=0)
    params = _f64(variables)
    jscene = j_random(np.random.default_rng(0))
    pts = np.random.default_rng(1).uniform([0.2, -1.5, -1.0], [4.0, 1.5, 1.0], (256, 3))
    latent = np.zeros(L)
    tx = optax.adam(3e-4)

    def loss_fn(p):
        gt = jax.vmap(lambda q: jnp.clip(j_scene_sdf(jscene, q), -0.3, 1.0))(pts)
        x = jnp.concatenate([pts, jnp.tile(latent[None], (pts.shape[0], 1))], axis=-1)
        return jnp.mean((module.apply(p, x)[:, 0] - gt) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params))
    want = optax.apply_updates(params, updates)

    net = _net64(module, params)
    opt = torch.optim.Adam(net.parameters(), lr=3e-4)
    scene = random_scene(np.random.default_rng(0), device="cpu").to(dtype=torch.float64)
    got = sdf_update(net, opt, scene, t64(pts), t64(latent))
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-12)
    _state_close(net, want, **STEP_TOL)


def test_vae_update_matches_jax():
    """One train_vae_on_images step (no batch norm, no dropout, Adam 2e-4)
    on the same images with the JAX key's latent noise: the reconstruction
    and KLD terms and every parameter within 1e-9 of the JAX script's step."""
    from sdf_nmpc_tpu.data.losses import loss_kld, loss_mse_valid_pixels_bias_pos_dist
    from sdf_nmpc_tpu.nn import sample_latent
    from sdf_nmpc_tpu.nn.vae import Vae as JVae
    from sdf_nmpc_tpu_torch.cli.train_latent_sdf import vae_config
    from sdf_nmpc_tpu_torch.nn import Vae
    from sdf_nmpc_tpu_torch.nn.weights import vae_from_jax
    from sdf_nmpc_tpu_torch.training.vae import vae_train_step
    from test_torch_training import H, W

    jvae = JVae(size_latent=L, shape_imgs=(1, H, W), dropout_rate=0.0, batchnorm=False)
    params = _f64(_draw_vae(jvae, 3)["params"])
    xb = jnp.asarray(images(1, seed=4)[..., None], jnp.float64)
    key = jax.random.PRNGKey(5)
    tx = optax.adam(2e-4)

    def loss_fn(p):  # scripts/train_latent_sdf.py:74-84
        mean, logvar = jvae.apply({"params": p}, xb, True, True,
                                  method=lambda m, x, train, wl: m.encoder(x, train, wl))
        z = sample_latent(key, mean, logvar)
        recon = jvae.apply({"params": p}, z, True, method=lambda m, z, t: m.decoder(z, t),
                           rngs={"latent": key})
        l_r = loss_mse_valid_pixels_bias_pos_dist(xb, recon, 0.1, 0.1, 3)
        l_k = loss_kld(mean, logvar, 1.0, L, (H, W))
        return l_r + l_k, (l_r, l_k)

    (_, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    updates, _ = tx.update(grads, tx.init(params))
    want = optax.apply_updates(params, updates)

    vae = Vae(size_latent=L, shape_imgs=(1, H, W), dropout_rate=0.0, batchnorm=False).double()
    vae.load_state_dict(vae_from_jax(jax.tree.map(np.asarray, {"params": params})))
    opt = torch.optim.Adam(vae.parameters(), lr=2e-4)
    eps = t64(jax.random.normal(key, (1, L), jnp.float64))
    x = t64(np.asarray(xb)[..., 0][:, None])
    got = vae_train_step(vae, opt, x, x, vae_config(L), 2e-4, eps=eps)
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in parts], rtol=1e-10)
    want_state = vae_from_jax(jax.tree.map(np.asarray, {"params": want}))
    for name, p in vae.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_state[name].numpy(), rtol=1e-9, atol=1e-9,
                                   err_msg=name)


def test_latent_sdf_update_matches_jax():
    """One train_latent_sdf update on the same scene indices, points and
    latents: the loss and every parameter within 1e-10 of the JAX script's
    step (scene_sdf of the indexed scene stack, optax.adam(5e-4))."""
    from sdf_nmpc_tpu.sim import Scene as JScene
    from sdf_nmpc_tpu.sim import scene_sdf as j_scene_sdf
    from train_latent_sdf import generate_scenes as j_generate

    from sdf_nmpc_tpu_torch.cli.train_latent_sdf import generate_scenes, latent_sdf_update
    from sdf_nmpc_tpu_torch.sim import Scene

    module, variables = jax_net(size_latent=L, layer_sizes=LAYERS, w0=8.0, seed=1)
    params = _f64(variables)
    rng = np.random.default_rng(2)
    lat = rng.normal(size=(6, L)) * 0.3
    sidx = np.array([4, 0, 4, 2])
    pts = rng.uniform([0.2, -1.5, -1.0], [4.0, 1.5, 1.0], (4, 32, 3))
    stack = jax.tree.map(lambda *xs: jnp.stack(xs), *j_generate(6, seed=1))
    tx = optax.adam(5e-4)

    def loss_fn(p):  # scripts/train_latent_sdf.py:132-143
        scene_b = jax.tree.map(lambda x: x[sidx], stack)
        gt = jax.vmap(lambda sc, ps: jax.vmap(
            lambda q: jnp.clip(j_scene_sdf(JScene(*sc), q), -0.3, 1.0))(ps))(tuple(scene_b), pts)
        lat_b = lat[sidx][:, None, :].repeat(pts.shape[1], axis=1)
        x = jnp.concatenate([pts, lat_b], axis=-1).reshape(-1, 3 + L)
        return jnp.mean((module.apply(p, x)[:, 0] - gt.reshape(-1)) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params))
    want = optax.apply_updates(params, updates)

    net = _net64(module, params)
    opt = torch.optim.Adam(net.parameters(), lr=5e-4)
    tstack = Scene.stack(generate_scenes(6, seed=1, device="cpu")).to(dtype=torch.float64)
    got = latent_sdf_update(net, opt, tstack, t64(lat), torch.as_tensor(sidx), t64(pts))
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-12)
    _state_close(net, want, **STEP_TOL)


def test_validate_closed_loop_matches_jax(monkeypatch):
    """validate_closed_loop over 10 ticks in f64 with a seeded narrow network
    carried across by the weights converter: every tick's status equal and
    the states within 1e-6 of the JAX script's rollout (chained SDF ticks,
    ROADMAP §3's watch); its three numbers within 1e-6."""
    import sdf_nmpc_tpu.sim as jsim
    from train_synthetic import random_scene as j_random
    from train_synthetic import validate_closed_loop as j_validate

    from sdf_nmpc_tpu_torch.cli.train_synthetic import closed_loop_rollout, random_scene

    captured = {}
    make = jsim.make_closed_loop

    def capture(*args, **kw):  # the jitted rollout's states and statuses, as they run
        rollout = make(*args, **kw)

        def run(*a):
            res = rollout(*a)
            jax.debug.callback(lambda xs, st: captured.update(xs=np.asarray(xs),
                                                              statuses=np.asarray(st)),
                               res.xs, res.statuses)
            return res

        return run

    monkeypatch.setattr(jsim, "make_closed_loop", capture)
    module, variables = jax_net(size_latent=L, layer_sizes=LAYERS, w0=8.0, seed=2)
    want3 = j_validate(j_random(np.random.default_rng(0)), module, _f64(variables),
                       size_latent=L, n_ticks=10)
    net = port_net(module, variables)  # f32-initialized values: exact in f64
    res = closed_loop_rollout(random_scene(np.random.default_rng(0), device="cpu"), net,
                              size_latent=L, n_ticks=10, device="cpu")
    assert res.xs.dtype == torch.float64
    np.testing.assert_array_equal(res.statuses[0].numpy(), captured["statuses"])
    np.testing.assert_allclose(res.xs[0].numpy(), captured["xs"], rtol=0, atol=1e-6)
    got3 = (float(res.min_clearance[0]), float(res.tracking_error[0]), int(res.statuses.sum()))
    np.testing.assert_allclose(got3, want3, rtol=0, atol=1e-6)


def test_sphere_trace_and_projection_match_jax():
    """The vectorised sphere trace (scripts/df_viz_img.py:18) and the
    closest-point projection x - d(x) grad d(x) / |grad d(x)|
    (scripts/df_viz_3d.py:73-85) of a seeded network within 1e-10 of the
    JAX scripts' computations, f64."""
    from df_viz_img import sphere_trace as j_trace

    from sdf_nmpc_tpu_torch.cli.df_viz_3d import project, value_and_grad
    from sdf_nmpc_tpu_torch.cli.df_viz_img import pixel_rays, sphere_trace, trace_image

    module, variables = jax_net(size_latent=L, layer_sizes=LAYERS, w0=2.0, seed=4)
    params = _f64(variables)
    # the head scaled into a distance-like field (|grad| below 1): on a raw
    # random network each march step amplifies f64 roundoff about tenfold
    params["params"]["df"] = {"kernel": params["params"]["df"]["kernel"] * 0.1,
                              "bias": params["params"]["df"]["bias"] + 0.1}
    latent = np.random.default_rng(5).normal(size=L) * 0.3
    net = _net64(module, params).eval()
    rays = pixel_rays(9, 16, 0.7592, 0.4903, False, torch.float64, "cpu")

    def j_batch(p):
        return module.apply(params, jnp.concatenate(
            [p, jnp.tile(jnp.asarray(latent)[None], (p.shape[0], 1))], axis=-1))[:, 0]

    want = np.asarray(j_trace(j_batch, jnp.asarray(rays.numpy())))
    got = trace_image(net, t64(latent), 9, 16, 0.7592, 0.4903, False, 5.0) * 5.0
    np.testing.assert_allclose(got.reshape(-1).numpy(), want, **STEP_TOL)
    with torch.no_grad():
        direct = sphere_trace(lambda p: net(torch.cat([p, t64(latent).expand(len(p), -1)], -1))
                              [:, 0], rays)
    np.testing.assert_allclose(direct.numpy(), want, **STEP_TOL)

    pts = np.random.default_rng(6).uniform([0.3, -1.0, -0.5], [3.0, 1.0, 0.5], (64, 3))

    def sdf_scalar(x):
        return module.apply(params, jnp.concatenate([x, jnp.asarray(latent)]))[0]

    nn_df = np.asarray(jax.vmap(sdf_scalar)(pts))
    g = np.asarray(jax.vmap(jax.grad(sdf_scalar))(pts))
    n = np.linalg.norm(g, axis=-1, keepdims=True)
    want_proj = pts - nn_df[:, None] * g / np.where(n == 0, 1.0, n)
    got_proj = project(t64(pts), *value_and_grad(net, t64(latent), t64(pts)))
    np.testing.assert_allclose(got_proj.numpy(), want_proj, **STEP_TOL)


# ------------------------------------------------- the pipelines end to end


@pytest.fixture(scope="module")
def prod_run(tmp_path_factory):
    """train_prod_perception --smoke through its five stages on the CPU
    (one epoch of each trainer, the closed loops cut to 2 ticks and one
    chunk), then the four evaluation modules on its outputs."""
    from sdf_nmpc_tpu_torch.cli import (df_test, df_viz_3d, df_viz_img, train_prod_perception,
                                        vae_test)

    work = tmp_path_factory.mktemp("prod")
    args = train_prod_perception.parse_args(["data", "vae", "df", "save", "eval", "--smoke",
                                             "--device", "cpu", "--workdir", str(work),
                                             "--loop-ticks", "2", "--chunks", "1"])
    args.vae_epochs = args.df_epochs = 1
    for stage in args.stages:
        train_prod_perception.STAGES[stage](args)
    data = ["--data-dir", str(work), "--data", train_prod_perception.DATASET,
            "--size-latent", "16", "--device", "cpu"]
    nets = ["--sdf", str(work / "df_ckpt_32_32_32_32"), "--encoder", str(work / "vae_ckpt"),
            "--layer-sizes", "32_32_32_32"]
    df_test.main(data + nets + ["--out", str(work / "df_test"), "--n-images", "1",
                                "--n-points", "100"])
    df_viz_3d.main(data + nets + ["--out", str(work / "df_viz_3d"), "--n-points", "300"])
    df_viz_img.main(data + nets + ["--out", str(work / "df_viz_img"), "--n-images", "1"])
    vae_test.main(data + ["--vae", str(work / "vae_ckpt"), "--out", str(work / "vae_test"),
                          "--n-images", "1"])
    return work


def test_prod_perception_smoke_stages(prod_run):
    """Every stage ran: the dataset, both checkpoints, the artifacts with the
    JAX stage's meta.json keys and finite eval statistics, and a PNG from
    each evaluation module."""
    out = prod_run / "weights"
    for name in ("sdf.msgpack", "vae_encoder.msgpack", "vae_decoder.msgpack", "latents.npy"):
        assert (out / name).is_file(), name
    meta = json.loads((out / "meta.json").read_text())
    assert {"size_latent", "layer_sizes", "embed", "act", "w0", "img", "scenes", "batchnorm",
            "pipeline", "loss", "vae_epochs", "df_epochs", "pose_mode", "poses", "df_lr",
            "df_lr_steps", "points_per_img", "df_ckpt_epoch", "stats"} <= set(meta)
    assert meta["img"] == "45x80" and meta["layer_sizes"] == [32, 32, 32, 32]
    assert len(meta["stats"]) == 14 and all(np.isfinite(v) for v in meta["stats"].values())
    assert np.load(out / "latents.npy").shape == (12, 16)
    for png in ("df_test/slices_img0.png", "df_viz_3d/closest_points.png",
                "df_viz_img/render_img0.png", "vae_test/vae_img0.png"):
        assert (prod_run / png).stat().st_size > 1000, png


def test_saved_artifacts_read_by_flax_and_the_port(prod_run):
    """The msgpack writer's files: flax's serialization.from_bytes restores
    them into the JAX modules' templates (the same values as the port's
    networks), and the port's load_prod_sdf / load_prod_encoder /
    load_prod_latents read them back equal."""
    from flax import serialization

    from sdf_nmpc_tpu.nn import NeuralDF as JNeuralDF
    from sdf_nmpc_tpu.nn.vae import Vae as JVae
    from sdf_nmpc_tpu_torch.cli.train_prod_perception import load_trained, parse_args
    from sdf_nmpc_tpu_torch.nn.weights import (encoder_to_jax, load_prod_encoder,
                                               load_prod_latents, load_prod_sdf, params_to_jax)

    out = prod_run / "weights"
    vae, df = load_trained(parse_args(["eval", "--smoke", "--device", "cpu", "--workdir",
                                       str(prod_run)]))
    jdf = JNeuralDF(size_latent=16, layer_sizes=(32, 32, 32, 32), embed="oct", act="sin", w0=20.0)
    template = jax.eval_shape(lambda k: jdf.init(k, jnp.zeros(19)), jax.random.PRNGKey(0))
    sdf = serialization.from_bytes(template, (out / "sdf.msgpack").read_bytes())
    jax.tree.map(np.testing.assert_array_equal, sdf, params_to_jax(df.state_dict()))
    jvae = JVae(size_latent=16, shape_imgs=(1, 45, 80), dropout_rate=0.0, batchnorm=True)
    v = jax.eval_shape(lambda k: jvae.init({"params": k, "latent": k, "dropout": k},
                                           jnp.zeros((1, 45, 80, 1)), train=True),
                       jax.random.PRNGKey(0))
    for part in ("encoder", "decoder"):
        tmpl = {"params": v["params"][part], "batch_stats": v["batch_stats"][part]}
        got = serialization.from_bytes(tmpl, (out / f"vae_{part}.msgpack").read_bytes())
        assert jax.tree.structure(got) == jax.tree.structure(tmpl)
    enc = serialization.from_bytes({"params": v["params"]["encoder"],
                                    "batch_stats": v["batch_stats"]["encoder"]},
                                   (out / "vae_encoder.msgpack").read_bytes())
    jax.tree.map(np.testing.assert_array_equal, enc, encoder_to_jax(vae.encoder.state_dict()))

    net = load_prod_sdf(out, require_latent=16, require_layers=(32, 32, 32, 32), device="cpu")
    for k, p in net.state_dict().items():
        assert torch.equal(p, df.state_dict()[k]), k
    encoder, meta = load_prod_encoder(out, expect_img=(45, 80), strict=True, device="cpu")
    assert meta["batchnorm"] is True
    img = torch.rand(2, 1, 45, 80, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(encoder(img), vae.encoder(img))
    assert load_prod_latents(out).shape == (12, 16)


def test_train_synthetic_and_latent_sdf_run_on_cpu(tmp_path, capsys):
    """train_synthetic's main and train_latent_sdf's stages under --device
    cpu at small sizes, the latter's artifacts read by the port's loaders."""
    from sdf_nmpc_tpu_torch.cli import train_latent_sdf, train_synthetic
    from sdf_nmpc_tpu_torch.nn.weights import load_prod_encoder, load_prod_sdf

    train_synthetic.main(["--device", "cpu", "--steps", "3", "--ticks", "3"])
    assert "closed loop with LEARNED sdf" in capsys.readouterr().out
    args = train_latent_sdf.parse_args(["--quick", "--device", "cpu", "--loop-ticks", "2",
                                        "--chunks", "1", "--out", str(tmp_path)])
    args.scenes, args.test_scenes, args.vae_epochs, args.sdf_steps = 6, 1, 1, 5
    stats = train_latent_sdf.run(args, log_fn=lambda *_: None)
    assert stats["scenes"] == 1 and all(np.isfinite(v) for v in stats.values())
    assert load_prod_sdf(tmp_path, require_latent=16, require_layers=(32, 32, 32, 32),
                         device="cpu") is not None
    assert load_prod_encoder(tmp_path, expect_img=(64, 96), strict=True, device="cpu") is not None


@pytest.mark.slow
def test_learned_sdf_closed_loop():
    """The port's counterpart of tests/test_learned_sdf_e2e.py (slow there
    too): 400 steps of train_sdf_on_scene on the seeded scene, then the
    learned network flies the closed loop collision-free to the goal."""
    from sdf_nmpc_tpu_torch.cli.train_synthetic import (random_scene, train_sdf_on_scene,
                                                        validate_closed_loop)

    scene = random_scene(np.random.default_rng(0), device="cpu")
    net, loss = train_sdf_on_scene(scene, steps=400, log_every=0, device="cpu")
    assert loss < 0.01, f"SDF regression did not converge: {loss}"
    clearance, err, fails = validate_closed_loop(scene, net, device="cpu")
    assert fails == 0
    assert clearance > 0.0, f"learned SDF failed to avoid: clearance {clearance}"
    assert err < 0.5, f"missed the goal: {err}"
