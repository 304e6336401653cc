"""The port's nn/torch_import.py: reference-shaped torch modules (the
reference archives' attribute nesting, hence their state-dict keys) are
traced, saved as TorchScript, loaded back through the port's
``load_torchscript_state_dict``, imported onto the port's modules, and held
against the reference module's forward and against the JAX package's
import of the same archive through its flax modules, in f64."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_archive import _RefVae
from tests.test_nn import build_torch_neural_df
from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)

RNG = np.random.default_rng(21)
TOL = dict(rtol=1e-10, atol=1e-10)
SHAPE = (48, 80)


def _archive(tmp_path, module, example, name):
    """state dict of ``module`` after a trace -> torch.jit.save -> load."""
    from sdf_nmpc_tpu_torch.nn.torch_import import load_torchscript_state_dict

    path = tmp_path / name
    torch.jit.save(torch.jit.trace(module, example), str(path))
    return load_torchscript_state_dict(path)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)


def _ref_vae():
    torch.manual_seed(0)
    tvae = _RefVae(8, SHAPE, batchnorm=True).eval()
    gen = torch.Generator().manual_seed(1)
    for m in tvae.modules():  # non-trivial running statistics
        if isinstance(m, torch.nn.BatchNorm2d):
            with torch.no_grad():
                m.running_mean.uniform_(-0.1, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.weight.uniform_(0.5, 1.5, generator=gen)
    return tvae


def test_vae_archive_onto_port_encoder_and_decoder(tmp_path):
    from sdf_nmpc_tpu.nn import Decoder as JDecoder
    from sdf_nmpc_tpu.nn import Encoder as JEncoder
    from sdf_nmpc_tpu.nn.torch_import import import_decoder as jimport_decoder
    from sdf_nmpc_tpu.nn.torch_import import import_encoder as jimport_encoder
    from sdf_nmpc_tpu_torch.nn.torch_import import import_decoder, import_encoder
    from sdf_nmpc_tpu_torch.nn.vae import Decoder, Encoder

    tvae = _ref_vae()
    x = RNG.uniform(size=(2, 1, *SHAPE))
    sd = _archive(tmp_path, tvae, torch.tensor(x, dtype=torch.float32), "vae.pt")
    assert "encoder.layers.resnet.3.layers.0.weight" in sd

    enc = Encoder(1, 8, dropout_rate=0.0, batchnorm=True).double()
    enc.load_state_dict(import_encoder(sd, use_batchnorm=True))
    ref = tvae.double()
    with torch.no_grad():
        got = enc.eval()(torch.as_tensor(x))
        want = ref.encoder(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    jenc = JEncoder(1, 8, dropout_rate=0.0, batchnorm=True)
    jwant = jenc.apply(_f64(jimport_encoder(sd, use_batchnorm=True)),
                       jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **TOL)

    dec = Decoder(1, 8, (1, *SHAPE), dropout_rate=0.0, batchnorm=True,
                  unflatten_hw=(2, 2)).double()
    dec.load_state_dict(import_decoder(sd, use_batchnorm=True))
    z = RNG.normal(size=(3, 8))
    with torch.no_grad():
        got = dec.eval()(torch.as_tensor(z))
        want = ref.decoder(torch.as_tensor(z))  # grows 32 x 32 -> 48 x 80
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    jdec = JDecoder(1, 8, shape_imgs=(1, *SHAPE), dropout_rate=0.0, batchnorm=True,
                    unflatten_hw=(2, 2))
    jwant = jdec.apply(_f64(jimport_decoder(sd, use_batchnorm=True, unflatten_hw=(2, 2))),
                       jnp.asarray(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant).transpose(0, 3, 1, 2), **TOL)


def test_neural_df_archive_onto_port(tmp_path):
    from sdf_nmpc_tpu.nn import NeuralDF as JNeuralDF
    from sdf_nmpc_tpu.nn.torch_import import import_neural_df as jimport
    from sdf_nmpc_tpu_torch.nn import NeuralDF
    from sdf_nmpc_tpu_torch.nn.torch_import import import_neural_df

    torch.manual_seed(2)
    tm = build_torch_neural_df(size_latent=16, layer_sizes=(32, 32, 32, 32)).eval()

    class Wrapper(torch.nn.Module):
        """The reference NeuralDF's nesting (layers.main1 ...)."""

        def __init__(self, inner):
            super().__init__()
            self.layers = inner.layers

        def forward(self, x):
            emb = self.layers["embeddings"](x[:, :3])
            h = self.layers["main1"](torch.cat([emb, x[:, 3:]], 1))
            h = self.layers["main2"](torch.cat([h, emb, x[:, 3:]], 1))
            return self.layers["df"](h)

    wrapped = Wrapper(tm).eval()
    x = RNG.normal(size=(9, 19))
    sd = _archive(tmp_path, wrapped, torch.tensor(x, dtype=torch.float32), "sdf.pt")
    net = NeuralDF(size_latent=16, layer_sizes=(32, 32, 32, 32), w0=1.0, nb_freqs=5).double()
    net.load_state_dict(import_neural_df(sd))
    with torch.no_grad():
        got = net(torch.as_tensor(x)).numpy()
        want = wrapped.double()(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jm = JNeuralDF(size_latent=16, layer_sizes=(32, 32, 32, 32), w0=1.0, nb_freqs=5)
    np.testing.assert_allclose(got, np.asarray(jm.apply(_f64(jimport(sd)), jnp.asarray(x))),
                               **TOL)


def test_mlp_archive_onto_port(tmp_path):
    from sdf_nmpc_tpu.nn.mlp import Mlp as JMlp
    from sdf_nmpc_tpu.nn.torch_import import import_mlp as jimport
    from sdf_nmpc_tpu_torch.nn import Mlp
    from sdf_nmpc_tpu_torch.nn.torch_import import import_mlp

    torch.manual_seed(3)
    tm = torch.nn.Module()
    tm.layers = torch.nn.Sequential(
        torch.nn.Linear(3, 16), torch.nn.Tanh(), torch.nn.Dropout(0),
        torch.nn.Linear(16, 16), torch.nn.Tanh(), torch.nn.Dropout(0),
        torch.nn.Linear(16, 1), torch.nn.Identity())
    tm.forward = lambda x: tm.layers(x)
    x = RNG.normal(size=(6, 3))
    sd = _archive(tmp_path, tm.layers, torch.tensor(x, dtype=torch.float32), "mlp.pt")
    sd = {f"layers.{k}": v for k, v in sd.items()}  # the reference Mlp's nesting
    net = Mlp(3, 1, (16, 16), inner_act=torch.tanh).double()
    net.load_state_dict(import_mlp(sd, n_hidden=2))
    with torch.no_grad():
        got = net(torch.as_tensor(x)).numpy()
        want = tm.layers.double()(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jm = JMlp(size_out=1, layer_sizes=(16, 16), inner_act=jnp.tanh)
    np.testing.assert_allclose(got, np.asarray(jm.apply(_f64(jimport(sd, n_hidden=2)),
                                                        jnp.asarray(x))), **TOL)
