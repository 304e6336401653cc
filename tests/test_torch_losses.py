"""The port's training losses (data/losses.py) against the JAX package's,
f64 on the CPU: every VAE loss, the KLD and the BCE on seeded arrays within
1e-12; ``loss_sdf``'s four parts and its parameter gradient (a double
backward through the input gradient) on a small NeuralDF in eval mode
within 1e-10; and trap 2 of the JAX package's train-mode dropout (ROADMAP
§3), which the port keeps on purpose: identical rows give different values
but identical input gradients, the gradient path's masks shared by every
row and drawn apart from the value path's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_net, one_torch_thread, port_net, t64  # noqa: F401

from sdf_nmpc_tpu.data import losses as jl
from sdf_nmpc_tpu_torch.data import losses as tl

RNG = np.random.default_rng(21)
TOL = dict(rtol=1e-12, atol=1e-12)


def _images():
    target = RNG.uniform(0, 1, (3, 1, 6, 7))
    target[target < 0.2] = 0.0  # invalid pixels
    return target, RNG.uniform(0, 1, (3, 1, 6, 7))


@pytest.mark.parametrize("name,kw", [
    ("loss_mse_valid_pixels", {}),
    ("loss_mse_valid_pixels_bias_distance", dict(weight_ratio=0.2, degree=3)),
    ("loss_mse_valid_pixels_bias_positive", dict(weight_ratio=0.1)),
    ("loss_mse_valid_pixels_bias_pos_dist", dict(pos_ratio=0.1, dist_ratio=0.1, degree=3)),
])
def test_image_losses_match_jax(name, kw):
    target, recon = _images()
    want = getattr(jl, name)(jnp.asarray(target), jnp.asarray(recon), **kw)
    got = getattr(tl, name)(t64(target), t64(recon), **kw)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_kld_and_bce_match_jax():
    mean, logvar = RNG.normal(size=(4, 8)), RNG.normal(size=(4, 8)) * 0.3
    np.testing.assert_allclose(
        float(tl.loss_kld(t64(mean), t64(logvar), 2.0, 8, (30, 48))),
        float(jl.loss_kld(jnp.asarray(mean), jnp.asarray(logvar), 2.0, 8, (30, 48))), **TOL)
    p, y = RNG.uniform(0, 1, 50), (RNG.uniform(0, 1, 50) > 0.5).astype(np.float64)
    p[:2] = (0.0, 1.0)  # the clipping
    np.testing.assert_allclose(
        float(tl.loss_weighted_bce(t64(p), t64(y), (0.3, 2.0))),
        float(jl.loss_weighted_bce(jnp.asarray(p), jnp.asarray(y), (0.3, 2.0))), **TOL)


def _sdf_batch(n, L, seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform([0, -2, -1], [4, 2, 1], (n, 3)), rng.normal(size=(n, L))], 1)
    tgrad = rng.normal(size=(n, 3))
    tgrad /= np.linalg.norm(tgrad, axis=1, keepdims=True)
    tgrad[:5] = 0.0  # saturated points
    return x, tgrad, rng.uniform(-0.3, 1.0, n)


WEIGHTS = (50.0, 1.0, 1 / 60, 5.0)  # every part in the gradient


def test_loss_sdf_parts_and_parameter_gradient_match_jax():
    module, variables = jax_net(size_latent=8, layer_sizes=(16, 16, 16, 16), w0=20.0)
    x, tgrad, tout = _sdf_batch(64, 8, 1)
    variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)

    def total(params):
        parts = jl.loss_sdf(lambda p, z: module.apply(p, z), params, jnp.asarray(x),
                            jnp.asarray(tgrad), jnp.asarray(tout))
        return sum(w * p for w, p in zip(WEIGHTS, parts)), jnp.stack(parts)

    (_, want_parts), want_grad = jax.jit(jax.value_and_grad(total, has_aux=True))(variables)

    net = port_net(module, variables)
    parts = tl.loss_sdf(net, t64(x), t64(tgrad), t64(tout))
    sum(w * p for w, p in zip(WEIGHTS, parts)).backward()
    np.testing.assert_allclose(torch.stack(parts).detach().numpy(), np.asarray(want_parts),
                               rtol=1e-10, atol=1e-10)
    want = {f"{k}.{'weight' if leaf == 'kernel' else 'bias'}": np.asarray(v).T
            for k, d in want_grad["params"].items() for leaf, v in d.items()}
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-10, atol=1e-10,
                                   err_msg=name)


def test_train_mode_dropout_structure_matches_jax():
    """Six identical rows under dropout 0.5 in train mode: the JAX package's
    values differ row by row and its input gradients (a vmap of jax.grad
    under one unbatched dropout key) are equal; the port's
    value_and_input_grad, wired as train_df wires it, shows the same."""
    from sdf_nmpc_tpu.nn.neural_df import NeuralDF as JNeuralDF
    from sdf_nmpc_tpu_torch.nn import NeuralDF

    kw = dict(size_latent=4, layer_sizes=(16, 16, 16, 16), embed="oct", act="sin", w0=2.0)
    jmod = JNeuralDF(dropout_rate=0.5, **kw)
    params = jmod.init(jax.random.PRNGKey(0), jnp.zeros(7), train=False)
    rows = jnp.asarray(np.tile(RNG.normal(size=(1, 7)), (6, 1)))
    key = jax.random.PRNGKey(3)
    apply = lambda x: jmod.apply(params, x, train=True, rngs={"dropout": key})
    j_out = np.asarray(apply(rows))[:, 0]
    j_grad = np.asarray(jax.vmap(jax.grad(lambda x: apply(x)[..., 0]))(rows))[:, :3]

    net = NeuralDF(dropout_rate=0.5, generator=torch.Generator().manual_seed(0), **kw).double()
    net.train()
    g = torch.Generator().manual_seed(1)
    out, grad = tl.value_and_input_grad(lambda x: net(x, g), t64(rows),
                                        lambda x: net(x, g, shared_mask=True))
    for values, grads in ((j_out, j_grad), (out.detach().numpy(), grad.detach().numpy())):
        assert len(np.unique(values)) > 1  # per-row masks on the value path
        # equal up to the batched products' rounding (JAX's vmap: 4e-15)
        np.testing.assert_allclose(grads, np.broadcast_to(grads[:1], grads.shape), rtol=1e-12)
        assert np.abs(grads).max() > 0
    # without dropout both paths are the eval-mode network
    net.dropout_rate = 0.0
    out0, grad0 = tl.value_and_input_grad(lambda x: net(x, g), t64(rows),
                                          lambda x: net(x, g, shared_mask=True))
    net.eval()
    out1, grad1 = tl.value_and_input_grad(net, t64(rows))
    assert torch.equal(out0, out1) and torch.equal(grad0, grad1)
