"""The SDF row's other inputs: the autodiff row (``ocp.autodiff_value_grad``)
that the RTI step takes for a NeuralDF with res != 'full' and under
``solver.fused_sdf: False``, and an omnidirectional sensor (hfov >= 3.14: no
hfov row), each against the JAX package (f64, narrow net)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, port_net, t64  # noqa: F401  (fixtures)
from test_torch_family_step import family_scenarios
from test_torch_families import family_configs
from test_torch_nosdf import chained_ticks_match

L = 16  # narrow net: latent 16, 4 x 32
RES = ["full", "state", "latent", "none"]


def _net(res):
    from sdf_nmpc_tpu.nn import init_neural_df

    return init_neural_df(size_latent=L, layer_sizes=(32, 32, 32, 32), embed="oct", act="sin",
                          w0=2.0, res=res, seed=3)


@pytest.mark.parametrize("res", RES)
def test_autodiff_value_grad_matches_jax(res):
    """autodiff_value_grad (torch.func) against the JAX package's default SDF
    row, vmap(value_and_grad(sdf_fn)), f64 on 20 points: within 1e-10 (the
    module's f64 forward agrees to 1e-11, tests/test_torch_weights.py)."""
    from sdf_nmpc_tpu.nn import make_sdf_fn
    from sdf_nmpc_tpu_torch.ocp import autodiff_value_grad

    module, variables = _net(res)
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    rng = np.random.default_rng(7)
    pos, lat = rng.normal(size=(20, 3)), rng.normal(size=(20, L)) * 0.3
    vals, grads = jax.jit(jax.vmap(jax.value_and_grad(make_sdf_fn(module, v64))))(
        jnp.asarray(pos), jnp.asarray(lat))
    net = port_net(module, variables).requires_grad_(False)
    df, grad = autodiff_value_grad(net)(t64(pos), t64(lat))
    assert df.dtype == grad.dtype == torch.float64 and grad.shape == (20, 3)
    np.testing.assert_allclose(df.numpy(), np.asarray(vals), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grads), rtol=1e-10, atol=1e-10)


def _sdf_ocps(res, cfg_upd):
    from sdf_nmpc_tpu.nn import make_sdf_fn
    from sdf_nmpc_tpu.ocp import build_ocp as jbuild
    from sdf_nmpc_tpu_torch.ocp import build_ocp

    jc, tc = family_configs("att", nn=dict(size_latent=L), **cfg_upd)
    module, variables = _net(res)
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    jocp = jbuild(jc, sdf_fn=make_sdf_fn(module, v64), sdf_max_df=1.0)
    tocp = build_ocp(tc, sdf=port_net(module, variables), sdf_max_df=1.0, device="cpu")
    return jc, jocp, tc, tocp


def _no_kernel_2(monkeypatch):
    from sdf_nmpc_tpu_torch.ops import sdf_fused

    def refuse(*a, **k):
        raise AssertionError("the autodiff row reached kernel 2's wrapper")

    monkeypatch.setattr(sdf_fused, "sdf_value_grad", refuse)
    monkeypatch.setattr(sdf_fused, "pack_neural_df_params", refuse)


@pytest.mark.parametrize("res", RES)
def test_autodiff_row_step_matches_jax(res, monkeypatch):
    """The f64 cold tick with the autodiff SDF row, B=3, N=20: res='full'
    under fused_sdf: False, and res 'state', 'latent', 'none' with the
    default settings, against the JAX make_rti_step (which takes the
    autodiff row off the TPU): status OK, u0, X and U within 1e-6.  Kernel
    2's wrapper is never reached (it would raise)."""
    solver = dict(dtype="float64", **({"fused_sdf": False} if res == "full" else {}))
    jc, jocp, tc, tocp = _sdf_ocps(res, dict(solver=solver))
    _no_kernel_2(monkeypatch)
    chained_ticks_match(jc, jocp, tc, tocp, ("cold",), seed=13, scenarios=family_scenarios)


@pytest.mark.parametrize("vfov", [True, False])
def test_omni_sensor_step_matches_jax(vfov):
    """An omnidirectional sensor (hfov pi, a spherical 30-degree vfov): no
    hfov row; stage and terminal rows [vfov, sdf] or [sdf] alone.  The f64
    cold tick, B=3, N=20, against the JAX make_rti_step: the row counts
    equal, status OK, u0, X and U within 1e-6."""
    upd = dict(sensor=dict(hfov=np.pi, vfov=np.pi / 6, is_spherical=True),
               flags=dict(vfov_constraint=vfov), solver=dict(dtype="float64"))
    jc, jocp, tc, tocp = _sdf_ocps("full", upd)
    assert (tocp.nh, tocp.nhN) == (jocp.nh, jocp.nhN) == (1 + vfov, 1 + vfov)
    assert tocp.cheap_stage_indices == jocp.cheap_stage_indices
    np.testing.assert_array_equal(tocp.lh, jocp.lh)
    chained_ticks_match(jc, jocp, tc, tocp, ("cold",), seed=17, scenarios=family_scenarios)
