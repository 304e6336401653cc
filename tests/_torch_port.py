"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: the same seeded numpy inputs go to both sides."""

from __future__ import annotations

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The CUDA device for tests marked ``gpu``; decided here, at run time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host: pytest -m gpu)")
    return torch.device("cuda")


def jax_net(size_latent=16, layer_sizes=(32, 32, 32, 32), embed="oct", act="sin",
            w0=2.0, seed=1):
    """(flax module, variables) of a NeuralDF from the JAX package."""
    from sdf_nmpc_tpu.nn import init_neural_df

    return init_neural_df(size_latent=size_latent, layer_sizes=layer_sizes, embed=embed,
                          act=act, w0=w0, seed=seed)


def port_net(module, variables, dtype=torch.float64, device="cpu"):
    """The port's NeuralDF carrying the JAX module's parameters."""
    import jax

    from sdf_nmpc_tpu_torch.nn import NeuralDF
    from sdf_nmpc_tpu_torch.nn.weights import params_from_jax

    net = NeuralDF(size_latent=module.size_latent, layer_sizes=module.layer_sizes,
                   embed=module.embed, act=module.act, w0=module.w0,
                   nb_freqs=module.nb_freqs, res=module.res)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables)))
    return net.to(dtype=dtype, device=device)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def t32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)
