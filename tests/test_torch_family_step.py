"""The RTI step on the five quad families beside att: the port's f64 step
against the JAX make_rti_step, cold, warm and steady ticks chained (narrow
net, N=20).  The kernel-9 families (rates, wrench, props) take their
residual rows from torch.func around kernel 9's plain version, acc and
att_tau kernel 1's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_net, one_torch_thread, port_net  # noqa: F401  (fixtures)
from test_torch_families import family_configs

L = 16  # narrow net: latent 16, 4 x 32


def family_scenarios(jcfg, jocp, B, seed):
    """(x0, p, yref, W) batches of hard random starts, as utils/accuracy.py
    draws them (body rates for nx=13 after the shared fields), half with
    the constrained weights."""
    from sdf_nmpc_tpu.params import ParamLayout
    from sdf_nmpc_tpu.ref_gen import Ref

    lay = ParamLayout.from_cfg(jcfg)
    rng = np.random.default_rng(seed)
    N, nx = jocp.N, jocp.nx
    x0 = np.zeros((B, nx))
    x0[:, 3] = 1.0
    x0[:, :3] = rng.normal(size=(B, 3)) * 0.5
    x0[:, 7:10] = rng.normal(size=(B, 3)) * 0.5
    x0[:, 10:] = rng.normal(size=(B, nx - 10)) * 0.2
    p = np.zeros((B, N + 1, lay.np_total))
    lay.set_flag(p, 1.0)
    lay.set_camera(p, np.zeros(3), np.eye(3))
    lay.set_q_d(p, [1, 0, 0, 0])
    yr, W = [], []
    for b in range(B):
        lay.set_latent(p[b], rng.normal(size=L) * 0.2)
        ref = Ref(jcfg).use_constrained_weights(bool(b % 2))
        ref.p = rng.normal(size=3) * 1.5
        y_, w_ = jocp.pack_ref(ref)
        yr.append(y_)
        W.append(w_)
    return x0, p, np.stack(yr), np.stack(W)


def step_inputs(cls, T, x0, p, yr, W, N, nyN):
    return cls(x0=T(x0), yref=T(np.repeat(yr[:, None], N, 1)), W=T(np.repeat(W[:, None], N, 1)),
               yrefN=T(yr[:, :nyN]), WN=T(W[:, :nyN]), p=T(p))


def family_ocps(model, **solver):
    """(JAX cfg, JAX ocp, port cfg, port ocp, net) of a family on the narrow
    net, f64 parameters on both sides."""
    from sdf_nmpc_tpu.nn import make_sdf_fn
    from sdf_nmpc_tpu.ocp import build_ocp as jbuild
    from sdf_nmpc_tpu_torch.ocp import build_ocp as tbuild

    jc, tc = family_configs(model, nn=dict(size_latent=L), solver=solver)
    module, variables = jax_net(size_latent=L, embed="oct", act="sin", w0=2.0, seed=3)
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    net = port_net(module, variables)
    jocp = jbuild(jc, sdf_fn=make_sdf_fn(module, v64), sdf_max_df=1.0)
    tocp = tbuild(tc, sdf=net, sdf_max_df=1.0, device="cpu")
    return jc, jocp, tc, tocp, (module, v64, net)


@pytest.mark.parametrize("model", ["rates", "wrench", "props", "acc", "att_tau"])
def test_f64_rti_step_matches_jax_per_family(model):
    """f64, default config, narrow net, B=3, N=20: cold, warm and steady
    ticks chained, the plant following the JAX prediction; u0, X and U agree
    to 1e-6 (the att step's agreement, tests/test_torch_rti_step.py)."""
    from sdf_nmpc_tpu.solver import SolveInputs as JInputs
    from sdf_nmpc_tpu.solver import init_state as jinit
    from sdf_nmpc_tpu.solver import make_rti_step as jmake
    from sdf_nmpc_tpu_torch.solver import SolveInputs as TInputs
    from sdf_nmpc_tpu_torch.solver import init_state as tinit
    from sdf_nmpc_tpu_torch.solver import make_rti_step as tmake

    jc, jocp, tc, tocp, _ = family_ocps(model, dtype="float64")
    assert (tocp.nx, tocp.ny, tocp.nyN) == (jocp.nx, jocp.ny, jocp.nyN)
    N, B = jocp.N, 3
    x0, p, yr, W = family_scenarios(jc, jocp, B, seed=23)
    jT = lambda a: jnp.asarray(a, jnp.float64)
    tT = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    jstate = jax.vmap(lambda x: jinit(jocp, x, jnp.float64))(jnp.asarray(x0))
    tstate = tinit(tocp, torch.as_tensor(x0), torch.float64)
    for budget in ("cold", "warm", "steady"):
        jres = jax.jit(jax.vmap(jmake(jocp, jc, with_evals=False, budget=budget)))(
            jstate, step_inputs(JInputs, jT, x0, p, yr, W, N, jocp.nyN))
        tres = tmake(tocp, tc, budget=budget, with_evals=False)(
            tstate, step_inputs(TInputs, tT, x0, p, yr, W, N, tocp.nyN))
        assert (np.asarray(jres.status) == 0).all() and (tres.status.numpy() == 0).all()
        for name, got, want in (("u0", tres.u0, jres.u0), ("X", tres.state.X, jres.state.X),
                                ("U", tres.state.U, jres.state.U)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                       err_msg=f"{model} {budget} {name}")
        jstate, tstate = jres.state, tres.state
        x0 = np.asarray(jres.state.X[:, 1])
