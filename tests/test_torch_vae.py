"""The port's perception VAE (nn/resnet.py, nn/vae.py, nn/normalizer.py)
against the JAX package's flax modules, f64 on the CPU: the same seeded
parameters (flax init, then random BatchNorm scales, biases and positive
running statistics) carried across by ``weights.vae_state_from_jax`` /
``encoder_from_jax`` / ``decoder_from_jax``, the same seeded inputs, NHWC
on the JAX side and NCHW on the port's.  1e-10 covers summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)

RNG = np.random.default_rng(12)
TOL = dict(rtol=1e-10, atol=1e-10)


def _perturbed(variables, seed):
    """f64 numpy tree: BatchNorm scale / bias and batch statistics drawn
    from a seed (running variances positive), every other leaf as inited."""
    rng = np.random.default_rng(seed)

    def visit(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = visit(v, path + (k,))
                continue
            a = np.asarray(v, np.float64)
            if path and path[0] == "batch_stats":
                a = rng.uniform(0.5, 1.5, a.shape) if k == "var" else rng.normal(size=a.shape) * 0.1
            elif k == "scale":
                a = rng.uniform(0.5, 1.5, a.shape)
            elif k == "bias" and any(p.startswith("BatchNorm") for p in path):
                a = rng.normal(size=a.shape) * 0.1
            out[k] = a
        return out

    return visit(jax.tree.map(np.asarray, dict(variables)), ())


def _draw(shapes, seed):
    """A variable tree of ``shapes`` (flax's, from abstract evaluation: no
    compile) with values from a numpy generator: kernels normal over
    sqrt(fan-in), biases small, BatchNorm as flax inits it (``_perturbed``
    then draws it)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        if name in ("scale", "var"):
            return np.ones(leaf.shape)
        if name == "bias" and not any(str(p.key).startswith("BatchNorm") for p in path):
            return rng.normal(size=leaf.shape) * 0.1
        return np.zeros(leaf.shape)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _init(module, seed, *args, **kw):
    """The flax module's variables, drawn by ``_draw``."""
    return _draw(jax.eval_shape(lambda k, *a: module.init(k, *a, **kw), jax.random.PRNGKey(0),
                                *args), seed)


def _apply(module, variables, *args, **kw):
    """One compiled program (op-by-op dispatch compiles every layer apart)."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *args)


def _port(module, state):
    module.double().load_state_dict(state)  # f64 first: the drawn statistics are f64
    return module.eval()


def _nchw(x):
    return torch.as_tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


class _Holder(torch.nn.Module):
    """A port module under the name flax gives it at the top of a tree."""

    def __init__(self, name, module):
        super().__init__()
        self.name = name
        setattr(self, name, module)

    def forward(self, x):
        return getattr(self, self.name)(x)


@pytest.mark.parametrize("stride,bottleneck,bn,hw", [
    (1, False, False, (10, 16)), (2, False, True, (9, 15)), (2, False, True, (10, 16)),
    (2, True, False, (9, 15)), (1, True, True, (9, 15)), (2, True, True, (10, 16))])
def test_resblock_matches_flax(stride, bottleneck, bn, hw):
    from sdf_nmpc_tpu.nn.resnet import ResBlock as J
    from sdf_nmpc_tpu_torch.nn.resnet import ResBlock as T
    from sdf_nmpc_tpu_torch.nn.weights import vae_state_from_jax

    kw = dict(size_in=8, stride=stride, bottleneck=bottleneck, use_batchnorm=bn)
    x = RNG.normal(size=(2, *hw, 8))
    jm = J(**kw)
    v = _perturbed(_init(jm, 1, jnp.asarray(x, jnp.float32)), 1)
    want = np.asarray(_apply(jm, jax.tree.map(jnp.asarray, v), jnp.asarray(x)))
    holder = _Holder("ResBlock_0", T(**kw))
    tree = {c: {"ResBlock_0": v[c]} for c in v}
    got = _nhwc(_port(holder, vae_state_from_jax(tree))(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stride,bottleneck,bn,op,hw", [
    (2, False, True, 1, (8, 15)), (2, False, False, 0, (7, 11)), (2, True, True, 0, (8, 15)),
    (2, True, False, 1, (7, 11)), (1, False, True, 0, (7, 11)), (2, False, True, 1, (7, 11))])
def test_resblock_deconv_matches_flax(stride, bottleneck, bn, op, hw):
    from sdf_nmpc_tpu.nn.resnet import ResBlockDeconv as J
    from sdf_nmpc_tpu_torch.nn.resnet import ResBlockDeconv as T
    from sdf_nmpc_tpu_torch.nn.weights import vae_state_from_jax

    kw = dict(size_in=8, stride=stride, bottleneck=bottleneck, use_batchnorm=bn,
              output_padding=op)
    x = RNG.normal(size=(2, *hw, 8))
    jm = J(**kw)
    v = _perturbed(_init(jm, 2, jnp.asarray(x, jnp.float32)), 2)
    want = np.asarray(_apply(jm, jax.tree.map(jnp.asarray, v), jnp.asarray(x)))
    holder = _Holder("ResBlockDeconv_0", T(**kw))
    got = _nhwc(_port(holder, vae_state_from_jax({c: {"ResBlockDeconv_0": v[c]} for c in v}))(
        _nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k,stride,padding,op", [(3, 2, 1, 1), (3, 1, 1, 0), (1, 2, 0, 1),
                                                 (5, 1, 2, 0), (4, 3, 1, 2)])
def test_conv_transpose_matches_flax(k, stride, padding, op):
    from sdf_nmpc_tpu.nn.resnet import ConvTransposeTorch as J
    from sdf_nmpc_tpu_torch.nn.resnet import ConvTransposeTorch as T
    from sdf_nmpc_tpu_torch.nn.weights import vae_state_from_jax

    x = RNG.normal(size=(2, 7, 9, 5))
    jm = J(features=6, kernel_size=(k, k), strides=(stride, stride), padding=padding,
           output_padding=op)
    v = _perturbed(_init(jm, 3, jnp.asarray(x, jnp.float32)), 3)
    v["params"]["bias"] = RNG.normal(size=6)
    want = np.asarray(_apply(jm, jax.tree.map(jnp.asarray, v), jnp.asarray(x)))
    holder = _Holder("ConvTransposeTorch_0", T(5, 6, k, stride, padding, op))
    got = _nhwc(_port(holder, vae_state_from_jax(
        {"params": {"ConvTransposeTorch_0": v["params"]}}))(_nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("hw", [(9, 15), (7, 11)])
def test_adaptive_avg_pool_matches_jax(hw):
    from sdf_nmpc_tpu.nn.vae import adaptive_avg_pool2d as J
    from sdf_nmpc_tpu_torch.nn.vae import adaptive_avg_pool2d as T

    x = RNG.normal(size=(2, *hw, 6))
    want = np.asarray(J(jnp.asarray(x), (2, 2)))
    np.testing.assert_allclose(_nhwc(T(_nchw(x), (2, 2))), want, **TOL)


def _encoders(size_latent, batchnorm, hw, seed):
    from sdf_nmpc_tpu.nn.vae import Encoder as J
    from sdf_nmpc_tpu_torch.nn.vae import Encoder as T
    from sdf_nmpc_tpu_torch.nn.weights import encoder_from_jax

    jm = J(1, size_latent, dropout_rate=0.0, batchnorm=batchnorm)
    init = _init(jm, seed, jnp.zeros((1, *hw, 1)), with_logvar=True)
    v = _perturbed(init, seed)
    return jm, jax.tree.map(jnp.asarray, v), _port(T(1, size_latent, 0.0, batchnorm),
                                                    encoder_from_jax(v))


@pytest.mark.parametrize("hw,batchnorm", [((36, 64), True), ((27, 48), True),
                                          ((27, 48), False)])
def test_encoder_matches_flax(hw, batchnorm):
    jm, v, enc = _encoders(8, batchnorm, hw, seed=4)
    x = RNG.uniform(size=(2, *hw, 1))
    want = _apply(jm, v, jnp.asarray(x), with_logvar=True)
    got = enc(_nchw(x), with_logvar=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("shape", [(1, 30, 48), (1, 270, 480)])
def test_decoder_matches_flax(shape):
    """(1, 30, 48): the final resize from 128 x 240 shrinks (antialiased);
    (1, 270, 480): it grows."""
    from sdf_nmpc_tpu.nn.vae import Decoder as J
    from sdf_nmpc_tpu_torch.nn.vae import Decoder as T
    from sdf_nmpc_tpu_torch.nn.weights import decoder_from_jax

    jm = J(1, 8, shape, dropout_rate=0.0, batchnorm=True)
    v = _perturbed(_init(jm, 5, jnp.zeros((1, 8))), 5)
    dec = _port(T(1, 8, shape, 0.0, True), decoder_from_jax(v))
    z = RNG.normal(size=(2, 8))
    want = np.asarray(_apply(jm, jax.tree.map(jnp.asarray, v), jnp.asarray(z)))
    got = _nhwc(dec(torch.as_tensor(z)))
    assert got.shape == want.shape == (2, shape[1], shape[2], 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_vae_eval_forward_matches_flax():
    from sdf_nmpc_tpu.nn.vae import Vae as J
    from sdf_nmpc_tpu_torch.nn.vae import Vae as T
    from sdf_nmpc_tpu_torch.nn.weights import decoder_from_jax, encoder_from_jax

    jm = J(size_latent=8, shape_imgs=(1, 30, 48), dropout_rate=0.0, batchnorm=True)
    keys = {"params": jax.random.PRNGKey(6), "latent": jax.random.PRNGKey(7)}
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, train=True), keys,
                            jnp.zeros((1, 30, 48, 1)))  # the training forward creates logvar
    v = _perturbed(_draw(shapes, 6), 6)
    part = lambda name: {c: v[c][name] for c in v}
    state = {**{f"encoder.{k}": t for k, t in encoder_from_jax(part("encoder")).items()},
             **{f"decoder.{k}": t for k, t in decoder_from_jax(part("decoder")).items()}}
    vae = _port(T(8, (1, 30, 48), 0.0, True), state)
    x = RNG.uniform(size=(2, 30, 48, 1))
    want = np.asarray(_apply(jm, jax.tree.map(jnp.asarray, v), jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(vae(_nchw(x))), want, **TOL)


@pytest.mark.parametrize("num_samples", [1, 3])
def test_sample_latent_matches_jax(num_samples):
    """The same standard-normal draw on both sides (the JAX key's)."""
    from sdf_nmpc_tpu.nn.vae import sample_latent as J
    from sdf_nmpc_tpu_torch.nn.vae import sample_latent as T

    mean, logvar = RNG.normal(size=(4, 6)), RNG.normal(size=(4, 6)) * 0.3
    key = jax.random.PRNGKey(7)
    shape = (4, 6) if num_samples == 1 else (4, num_samples, 6)
    eps = np.asarray(jax.random.normal(key, shape, jnp.float64))
    want = np.asarray(J(key, jnp.asarray(mean), jnp.asarray(logvar), num_samples))
    got = T(torch.as_tensor(mean), torch.as_tensor(logvar), num_samples, eps=torch.from_numpy(eps.copy()))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    gen = lambda: torch.Generator().manual_seed(3)
    a = T(torch.as_tensor(mean), torch.as_tensor(logvar), num_samples, generator=gen())
    b = T(torch.as_tensor(mean), torch.as_tensor(logvar), num_samples, generator=gen())
    assert a.shape == want.shape and torch.equal(a, b)


def test_normalizer_matches_jax():
    from sdf_nmpc_tpu.nn.normalizer import compute_stats as jstats
    from sdf_nmpc_tpu.nn.normalizer import normalize as jnorm
    from sdf_nmpc_tpu_torch.nn.normalizer import compute_stats, normalize

    data, x = RNG.normal(size=(50, 7)) * 3 + 1, RNG.normal(size=(5, 7))
    js, ts = jstats(jnp.asarray(data)), compute_stats(torch.as_tensor(data))
    np.testing.assert_allclose(ts.mean.numpy(), np.asarray(js.mean), **TOL)
    np.testing.assert_allclose(ts.std.numpy(), np.asarray(js.std), **TOL)
    np.testing.assert_allclose(normalize(torch.as_tensor(x), ts).numpy(),
                               np.asarray(jnorm(jnp.asarray(x), js)), **TOL)


def test_seeded_init_is_reproducible():
    from sdf_nmpc_tpu_torch.nn.vae import Vae

    a = Vae(8, (1, 30, 48), generator=torch.Generator().manual_seed(9))
    b = Vae(8, (1, 30, 48), generator=torch.Generator().manual_seed(9))
    for (name, pa), (_, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(pa, pb), name
