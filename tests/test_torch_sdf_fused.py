"""Kernel 2 (sdf_value_grad): the plain stacked-tangent version against the
JAX Pallas kernel (interpret mode, f32) and the JAX autodiff oracle (f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_net, port_net, t32, t64

RNG = np.random.default_rng(17)


def _points(B, L):
    return RNG.normal(size=(B, 3)), RNG.normal(size=(B, L)) * 0.3


@pytest.mark.parametrize("embed,act", [("pos", "sin"), ("oct", "sin"), ("pos", "relu"),
                                       ("ico", "softplus")])
def test_plain_f32_matches_pallas_kernel_interpret(embed, act):
    """The JAX kernel tests' tolerances (tests/test_ops.py): value 2e-4,
    gradient 2e-3; both sides compute the embedding tangents as cos(xb)."""
    from sdf_nmpc_tpu.ops import make_fused_sdf
    from sdf_nmpc_tpu_torch.ops.sdf_fused import pack_neural_df_params, sdf_value_grad

    module, variables = jax_net(embed=embed, act=act, w0=2.0, seed=1)
    fused = jax.jit(make_fused_sdf(module, variables, tile=8, interpret=True, dtype="f32"))
    net = port_net(module, variables, dtype=torch.float32)
    pos, lat = (a.astype(np.float32) for a in _points(13, 16))
    df_j, gr_j = fused(jnp.asarray(pos), jnp.asarray(lat))
    df_t, gr_t = sdf_value_grad(pack_neural_df_params(net), t32(pos), t32(lat))
    np.testing.assert_allclose(df_t.numpy(), np.asarray(df_j), atol=2e-4)
    np.testing.assert_allclose(gr_t.numpy(), np.asarray(gr_j), atol=2e-3)


@pytest.mark.parametrize("embed,act", [("oct", "sin"), ("none", "sin"), ("cube", "relu"),
                                       ("dod", "softplus")])
def test_plain_f64_matches_jax_autodiff(embed, act):
    """f64 against vmap(value_and_grad(module.apply)): the analytic stacked
    tangents equal reverse-mode AD; the embedding's cos(xb) against the
    module's sin(xb + pi/2) differs at 1e-16 |xb| in f64, hence 1e-10."""
    from sdf_nmpc_tpu.ops import reference_value_and_grad
    from sdf_nmpc_tpu_torch.ops.sdf_fused import pack_neural_df_params, sdf_value_grad

    module, variables = jax_net(embed=embed, act=act, w0=3.0, seed=6)
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    pos, lat = _points(20, 16)
    df_j, gr_j = jax.jit(reference_value_and_grad(module, v64))(jnp.asarray(pos),
                                                                 jnp.asarray(lat))
    net = port_net(module, variables)
    df_t, gr_t = sdf_value_grad(pack_neural_df_params(net), t64(pos), t64(lat))
    np.testing.assert_allclose(df_t.numpy(), np.asarray(df_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(gr_t.numpy(), np.asarray(gr_j), rtol=1e-10, atol=1e-10)


def test_kernel_weight_layout_is_inert_padding():
    """The CUDA kernel's padded weights (hidden width 256, W3 rows split as
    [h | input]) reproduce the unpadded products exactly."""
    from sdf_nmpc_tpu_torch.ops.sdf_fused import _kernel_weights, pack_neural_df_params

    module, variables = jax_net(embed="oct", act="sin", w0=2.0, seed=1)
    packed = pack_neural_df_params(port_net(module, variables, dtype=torch.float32))
    kw = _kernel_weights(packed)
    in1, in1p, s1 = packed["in1"], kw["in1p"], packed["sizes"][1]
    assert in1p % 32 == 0 and kw["W3"].shape == (256 + in1p, 256)
    h = torch.randn(5, s1)
    x0 = torch.randn(5, in1)
    want = torch.cat([h, x0], -1) @ packed["W3"]
    hp = torch.zeros(5, 256)
    hp[:, :s1] = h
    xp = torch.zeros(5, in1p)
    xp[:, :in1] = x0
    got = (torch.cat([hp, xp], -1) @ kw["W3"])[:, : want.shape[1]]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)

