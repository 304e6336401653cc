"""The port's trainers (training/df.py, vae.py, checkpoints.py) against the
JAX package's, f64 on the CPU.

The inner loops: the JAX package's parameters and an optax AdamW state
(count 2, drawn moments) carried across (``nn/weights.py``: ``params_from_jax``,
``vae_from_jax``, ``opt_state_from_jax``), then three more steps on both
sides from injected batches, dropout off (the VAE's latent noise the JAX
key's normals): the parameters after each step within 1e-9 of optax's, and
the VAE's BatchNorm running statistics, the encoder's and the decoder's, as
the JAX package's train_step keeps them.  Then the one-epoch-and-resume
contract of tests/test_training.py on the port, a JAX-written VAE run read
by ``load_encoder_from_vae_ckpt``, and the CLI chain on a tiny rendered
dataset."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_port import jax_net, one_torch_thread, port_net, t64  # noqa: F401
from flax import serialization

from sdf_nmpc_tpu.data.losses import loss_kld, loss_mse_valid_pixels_bias_pos_dist, loss_sdf
from sdf_nmpc_tpu.nn.vae import Vae as JVae
from sdf_nmpc_tpu.nn.vae import sample_latent as j_sample_latent
from sdf_nmpc_tpu.training.df import DfTrainConfig as JDfCfg
from sdf_nmpc_tpu_torch.data.h5 import ImageDataset
from sdf_nmpc_tpu_torch.nn import Vae
from sdf_nmpc_tpu_torch.nn.weights import opt_state_from_jax, params_from_jax, vae_from_jax
from sdf_nmpc_tpu_torch.training import (
    DfTrainConfig,
    VaeTrainConfig,
    load_encoder_from_vae_ckpt,
    train_df,
    train_vae,
)
from sdf_nmpc_tpu_torch.training.df import df_train_step
from sdf_nmpc_tpu_torch.training.vae import vae_train_step

H, W = 30, 50
METADATA = {"hfov": 0.7592, "vfov": 0.4903, "is_depth": False, "is_spherical": False,
            "shape_imgs": [1, H, W]}
STEP_TOL = dict(rtol=1e-9, atol=1e-9)
LRS = (1e-4, 5e-5, 2.5e-5)  # the three steps


def adamw_state(tx, params, seed):
    """optax's AdamW state as after two steps: count 2, the moments drawn
    (nu positive)."""
    rng = np.random.default_rng(seed)
    state = tx.init(params)
    adam = state.inner_state[0]
    adam = adam._replace(
        count=jnp.asarray(2, adam.count.dtype),
        mu=jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape) * 1e-3), params),
        nu=jax.tree.map(lambda a: jnp.asarray(rng.uniform(1e-8, 1e-5, a.shape)), params))
    return state._replace(inner_state=(adam,) + tuple(state.inner_state[1:]))


def f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def images(n, seed=0):
    """(n, H, W) dmax-normalized range images of random spheres before a
    wall (the port's renderer)."""
    from sdf_nmpc_tpu_torch.sim.scenes import Scene, render_range_image

    rng = np.random.default_rng(seed)
    scenes = [Scene.make(spheres=[(rng.uniform([0.8, -1.5, -0.6], [4.0, 1.5, 0.6]),
                                   rng.uniform(0.2, 0.7)) for _ in range(3)],
                         boxes=[([rng.uniform(2.0, 4.5), -9, -9], [9, 9, 9])], device="cpu")
              for _ in range(n)]
    return render_range_image(Scene.stack(scenes), np.zeros(3), torch.eye(3), H, W,
                              METADATA["hfov"], METADATA["vfov"], 5.0).numpy()


def adamw(lr):
    return optax.inject_hyperparams(optax.adamw)(learning_rate=lr, weight_decay=1e-5)


# ------------------------------------------------------------- train_df step


def test_df_train_step_matches_optax():
    module, variables = jax_net(size_latent=8, layer_sizes=(16, 16, 16, 16), w0=20.0)
    params = f64(variables)
    weights = tuple(JDfCfg().loss_weights)
    rng = np.random.default_rng(4)

    def batch():
        n = 96
        g = rng.normal(size=(n, 3))
        g /= np.linalg.norm(g, axis=1, keepdims=True)
        g[:8] = 0.0
        return (rng.uniform([0, -2, -1], [4, 2, 1], (n, 3)), rng.normal(size=(n, 8)),
                rng.uniform(-0.3, 1.0, n), g)

    def loss(p, states, latents, gt, grads):
        parts = loss_sdf(lambda q, x: module.apply(q, x, train=True), p,
                         jnp.concatenate([states, latents], -1), grads, gt)
        return sum(w * l for w, l in zip(weights, parts)), jnp.stack(parts)

    tx = adamw(LRS[0])

    @jax.jit
    def j_step(p, opt_state, b, lr):  # training/df.py:147-157
        (_, parts), g = jax.value_and_grad(loss, has_aux=True)(p, *b)
        opt_state.hyperparams["learning_rate"] = lr
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, parts

    opt_state = adamw_state(tx, params, 1)
    net = port_net(module, jax.tree.map(np.asarray, variables))  # the architecture
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))  # in f64
    opt = torch.optim.AdamW(net.parameters())
    opt_state_from_jax(opt, net, serialization.to_state_dict(opt_state), params_from_jax)
    assert all(float(s["step"]) == 2 for s in opt.state.values())
    assert opt.param_groups[0]["weight_decay"] == 1e-5
    for lr in LRS:
        b = batch()
        params, opt_state, want_parts = j_step(params, opt_state, tuple(map(jnp.asarray, b)),
                                               lr)
        parts = df_train_step(net, opt, *map(t64, b[:2]), t64(b[2]), t64(b[3]), weights, lr)
        np.testing.assert_allclose(parts.numpy(), np.asarray(want_parts), rtol=1e-10,
                                   atol=1e-10)
        want = params_from_jax(jax.tree.map(np.asarray, params))
        for name, p in net.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), **STEP_TOL, err_msg=name)


# ------------------------------------------------------------ train_vae step


def _draw_vae(module, seed):
    """flax Vae variables with shapes from abstract evaluation (no compile),
    values from a numpy generator; batch statistics off their init."""
    shapes = jax.eval_shape(
        lambda k: module.init({"params": k, "latent": k, "dropout": k},
                              jnp.zeros((1, H, W, 1)), train=True), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape)
        return rng.normal(size=leaf.shape) * 0.1

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_vae_train_step_matches_optax():
    cfg = VaeTrainConfig(size_latent=8, dropout_rate=0.0, batchnorm=True)
    jvae = JVae(size_latent=8, shape_imgs=(1, H, W), dropout_rate=0.0, batchnorm=True)
    variables = _draw_vae(jvae, 5)
    params, batch_stats = variables["params"], variables["batch_stats"]
    tx = adamw(LRS[0])
    imgs = images(2 * len(LRS), seed=1)
    keys = jax.random.split(jax.random.PRNGKey(9), len(LRS))

    def loss_fn(p, stats, x_in, x_out, key):  # training/vae.py:91-114, dropout off
        (mean, logvar), mutated = jvae.apply(
            {"params": p, "batch_stats": stats}, x_in, train=True, with_logvar=True,
            method=lambda m, x, train, with_logvar: m.encoder(x, train, with_logvar),
            mutable=["batch_stats"])
        latent = j_sample_latent(key, mean, logvar)
        recon, mutated2 = jvae.apply(
            {"params": p, "batch_stats": mutated["batch_stats"]}, latent, True,
            method=lambda m, z, train: m.decoder(z, train), mutable=["batch_stats"])
        l_reg = loss_mse_valid_pixels_bias_pos_dist(x_out, recon, 0.1, 0.1, 3)
        l_kld = loss_kld(mean, logvar, 1.0, 8, (H, W))
        return l_reg + l_kld, (l_reg, l_kld, mutated2["batch_stats"])

    @jax.jit
    def train_step(p, stats, opt_state, x, key, lr):  # training/vae.py:115-119
        (_, (l_reg, l_kld, stats)), g = jax.value_and_grad(loss_fn, has_aux=True)(
            p, stats, x, x, key)
        opt_state.hyperparams["learning_rate"] = lr
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), stats, opt_state, (l_reg, l_kld)

    def j_step(p, stats, opt_state, i):
        x = jnp.asarray(imgs[2 * i:2 * i + 2, :, :, None], jnp.float64)
        return train_step(p, stats, opt_state, x, keys[i], LRS[i])

    opt_state = adamw_state(tx, params, 2)
    vae = Vae(size_latent=8, shape_imgs=(1, H, W), dropout_rate=0.0, batchnorm=True).double()
    vae.load_state_dict(vae_from_jax(jax.tree.map(
        np.asarray, {"params": params, "batch_stats": batch_stats})))
    opt = torch.optim.AdamW(vae.parameters())
    opt_state_from_jax(opt, vae, serialization.to_state_dict(opt_state),
                       lambda tree: vae_from_jax({"params": tree}))
    for i in range(len(LRS)):
        old_stats = jax.tree.map(np.asarray, batch_stats)
        params, batch_stats, opt_state, want = j_step(params, batch_stats, opt_state, i)
        eps = t64(jax.random.normal(keys[i], (2, 8), jnp.float64))
        x = t64(imgs[2 * i:2 * i + 2, None])
        got = vae_train_step(vae, opt, x, x, cfg, LRS[i], eps=eps)
        np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want],
                                   rtol=1e-10, atol=1e-12)
        want_state = vae_from_jax(jax.tree.map(
            np.asarray, {"params": params, "batch_stats": batch_stats}))
        for name, p in vae.state_dict().items():
            if not name.endswith("num_batches_tracked"):
                np.testing.assert_allclose(p.numpy(), want_state[name].numpy(), **STEP_TOL,
                                           err_msg=name)
    # both halves' running statistics moved in the step, as the JAX package's
    moved = jax.tree.map(lambda a, b: float(np.abs(np.asarray(a) - b).max()), batch_stats,
                         old_stats)
    assert min(jax.tree.leaves(moved["encoder"])) > 0
    assert min(jax.tree.leaves(moved["decoder"])) > 0


# --------------------------------------------------------- loops and resume


def tiny_dataset(n=4):
    imgs = images(n, seed=2)[:, None].astype(np.float32)
    return ImageDataset(imgs, range(n), preprocess=lambda x: x, augment=None, device="cpu")


def test_train_df_one_epoch_and_resume(tmp_path):
    from sdf_nmpc_tpu_torch.nn import Encoder

    enc = Encoder(1, 8, dropout_rate=0.0, batchnorm=False,
                  generator=torch.Generator().manual_seed(0))
    cfg = DfTrainConfig(nb_epochs=1, batch_size=2, points_per_img=40, lr_nb_steps=2)
    net, hist = train_df(tiny_dataset(), tiny_dataset(2), METADATA, enc, tmp_path, cfg=cfg,
                         nn_kwargs={"layer_sizes": [16, 16, 16, 16]}, size_latent=8,
                         log_fn=lambda *_: None, device="cpu")
    assert len(hist) == 1 and np.isfinite(hist[0]["train"]).all()
    assert np.isfinite(hist[0]["valid"]).all() and not net.training
    assert (tmp_path / "weights.pt").exists() and (tmp_path / "epochs" / "e0.pt").exists()
    assert json.loads((tmp_path / "state.json").read_text())["epoch"] == 0
    lines = (tmp_path / "train" / "metrics.jsonl").read_text().splitlines()
    assert {json.loads(x)["tag"] for x in lines} >= {"loss/total", "loss/eikonal"}

    # resume from epoch 1 (restart_from_epoch=1 loads e0)
    cfg2 = DfTrainConfig(nb_epochs=2, batch_size=2, points_per_img=40, lr_nb_steps=2)
    _, hist2 = train_df(tiny_dataset(), None, METADATA, enc, tmp_path, cfg=cfg2,
                        nn_kwargs={"layer_sizes": [16, 16, 16, 16]}, size_latent=8,
                        restart_from_epoch=1, log_fn=lambda *_: None, device="cpu")
    assert hist2[0]["epoch"] == 1
    assert hist2[0]["lr"] == cfg2.lr_at_epoch(1)  # the cosine position restored
    blob = torch.load(tmp_path / "epochs" / "e1.pt", weights_only=True)
    # the optimizer went on counting from e0's two steps
    assert {float(s["step"]) for s in blob["optimizer"]["state"].values()} == {4.0}


def test_train_vae_one_epoch_and_resume(tmp_path):
    cfg = VaeTrainConfig(size_latent=8, nb_epochs=1, batch_size=2, lr_nb_steps=2)
    vae, hist = train_vae(tiny_dataset(2), tiny_dataset(2), METADATA, tmp_path, cfg=cfg,
                          log_fn=lambda *_: None, device="cpu")
    assert len(hist) == 1 and np.isfinite(hist[0]["train"]).all()
    assert np.isfinite(hist[0]["valid"]).all() and not vae.training
    assert (tmp_path / "weights.pt").exists()
    bn = vae.encoder.ResBlock_0.BatchNorm_0
    assert int(bn.num_batches_tracked) == 1 and not torch.equal(bn.running_var,
                                                                 torch.ones_like(bn.running_var))
    cfg2 = VaeTrainConfig(size_latent=8, nb_epochs=2, batch_size=2, lr_nb_steps=2)
    _, hist2 = train_vae(tiny_dataset(2), None, METADATA, tmp_path, cfg=cfg2,
                         restart_from_epoch=1, log_fn=lambda *_: None, device="cpu")
    assert hist2[0]["epoch"] == 1 and hist2[0]["lr"] == cfg2.lr_at_epoch(1)
    enc = load_encoder_from_vae_ckpt(tmp_path, 8, device="cpu")
    state = torch.load(tmp_path / "weights.pt", weights_only=True)["model"]
    assert torch.equal(enc.ResBlock_0.BatchNorm_0.running_mean,
                       state["encoder.ResBlock_0.BatchNorm_0.running_mean"])


def test_load_encoder_from_jax_vae_run(tmp_path):
    """A run directory the JAX package's save_checkpoint wrote
    (weights.msgpack: params, opt_state, batch_stats) gives the encoder
    encoder_from_jax gives of the same tree."""
    from sdf_nmpc_tpu.training.checkpoints import save_checkpoint as j_save

    from sdf_nmpc_tpu_torch.nn.weights import encoder_from_jax

    jvae = JVae(size_latent=8, shape_imgs=(1, H, W), dropout_rate=0.0, batchnorm=True)
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32), _draw_vae(jvae, 6))
    j_save(tmp_path, variables["params"], None, 3, batch_stats=variables["batch_stats"])
    enc = load_encoder_from_vae_ckpt(tmp_path, 8, device="cpu")
    want = encoder_from_jax({"params": variables["params"]["encoder"],
                             "batch_stats": variables["batch_stats"]["encoder"]})
    for name, t in enc.state_dict().items():
        assert torch.equal(t, want[name].to(t.dtype)), name
    assert not enc.training


def test_cli_chain_on_rendered_data(tmp_path):
    """create_h5 -> train_vae -> train_df through the CLIs, on the CPU."""
    h5py = pytest.importorskip("h5py")
    from sdf_nmpc_tpu_torch.cli import create_h5, train_df as cli_df, train_vae as cli_vae

    for i, name in enumerate(("a.h5", "b.h5")):
        with h5py.File(tmp_path / name, "w") as f:  # range in millimetres
            f.create_dataset("images", data=(images(5, seed=10 + i) * 5000.0)[:, None])
            for k, v in dict(hfov=0.7592, vfov=0.4903, aspect_ratio=1.667, is_depth=False,
                             is_spherical=False).items():
                f.attrs[k] = v
    create_h5.main([str(tmp_path / "a.h5"), str(tmp_path / "b.h5"), "--out",
                    str(tmp_path / "m.h5"), "--ratio-test", "0.2"])
    cli_vae.main(["--data-dir", str(tmp_path), "--data", "m.h5", "--out", str(tmp_path / "vae"),
                  "--size-latent", "8", "--epochs", "1", "--batch-size", "4", "--device", "cpu"])
    cli_df.main(["--data-dir", str(tmp_path), "--data", "m.h5", "--encoder",
                 str(tmp_path / "vae"), "--out", str(tmp_path / "sdf"), "--size-latent", "8",
                 "--epochs", "1", "--batch-size", "4", "--points-per-img", "40",
                 "--variants", "16_16_16_16", "--device", "cpu"])
    for run in ("vae", "sdf/16_16_16_16"):
        hist = json.loads((tmp_path / run / "history.json").read_text())
        assert len(hist) == 1 and np.isfinite(hist[0]["train"]).all(), run
