"""The slice as a whole: the port's batched RTI step against the JAX
make_rti_step (f64, and f32 with all four JAX kernels in interpret mode).
The port's f32 plain path against the accuracy goldens is in
test_torch_accuracy.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_net, one_torch_thread, port_net  # noqa: F401  (fixtures)

L = 16  # narrow net: latent 16, 4 x 32


def _scenarios(cfg, N, B, seed):
    """(x0, p, yref, W) batches: hard random starts as in utils/accuracy.py."""
    from sdf_nmpc_tpu.params import ParamLayout
    from sdf_nmpc_tpu.ref_gen import Ref

    lay = ParamLayout.from_cfg(cfg)
    rng = np.random.default_rng(seed)
    x0 = np.zeros((B, 10))
    x0[:, 3] = 1.0
    x0[:, :3] = rng.normal(size=(B, 3)) * 0.5
    x0[:, 7:10] = rng.normal(size=(B, 3)) * 0.5
    p = np.zeros((B, N + 1, lay.np_total))
    lay.set_flag(p, 1.0)
    lay.set_camera(p, np.zeros(3), np.eye(3))
    lay.set_q_d(p, [1, 0, 0, 0])
    for b in range(B):
        lay.set_latent(p[b], rng.normal(size=L) * 0.2)
    yr, W = [], []
    from sdf_nmpc_tpu.models import make_model

    model = make_model(cfg)
    for b in range(B):
        ref = Ref(cfg).use_constrained_weights(bool(b % 2))
        ref.p = rng.normal(size=3) * 1.5
        y_, w_ = model.formate_ref(ref)
        yr.append(y_)
        W.append(w_)
    return x0, p, np.stack(yr), np.stack(W)


def _jax_inputs(x0, p, yr, W, N, dt):
    from sdf_nmpc_tpu.solver import SolveInputs

    return SolveInputs(x0=jnp.asarray(x0, dt), yref=jnp.asarray(np.repeat(yr[:, None], N, 1), dt),
                       W=jnp.asarray(np.repeat(W[:, None], N, 1), dt),
                       yrefN=jnp.asarray(yr[:, :4], dt), WN=jnp.asarray(W[:, :4], dt),
                       p=jnp.asarray(p, dt))


def _port_inputs(x0, p, yr, W, N, dt):
    from sdf_nmpc_tpu_torch.solver import SolveInputs

    T = lambda a: torch.as_tensor(np.asarray(a), dtype=dt)
    return SolveInputs(x0=T(x0), yref=T(np.repeat(yr[:, None], N, 1)),
                       W=T(np.repeat(W[:, None], N, 1)), yrefN=T(yr[:, :4]), WN=T(W[:, :4]),
                       p=T(p))


def _configs(**solver):
    from sdf_nmpc_tpu.config import default_config as jcfg
    from sdf_nmpc_tpu_torch.config import default_config as tcfg

    upd = dict(nn=dict(size_latent=L), solver=solver)
    return jcfg().replace(**upd), tcfg().replace(**upd)


def test_f64_rti_step_matches_jax_cold_warm_steady():
    """f64, default config, narrow net, B=4, N=20: cold, warm and steady
    ticks chained; u0, X and U agree to 1e-6 (the JAX package holds its own
    f64 solve against an independent oracle at 2e-6)."""
    from sdf_nmpc_tpu.nn import make_sdf_fn
    from sdf_nmpc_tpu.ocp import build_ocp as jbuild
    from sdf_nmpc_tpu.solver import init_state as jinit
    from sdf_nmpc_tpu.solver import make_rti_step as jmake
    from sdf_nmpc_tpu_torch.ocp import build_ocp as tbuild
    from sdf_nmpc_tpu_torch.solver import init_state as tinit
    from sdf_nmpc_tpu_torch.solver import make_rti_step as tmake

    jc, tc = _configs(dtype="float64")
    module, variables = jax_net(size_latent=L, embed="oct", act="sin", w0=2.0, seed=3)
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    jocp = jbuild(jc, sdf_fn=make_sdf_fn(module, v64), sdf_max_df=1.0)
    tocp = tbuild(tc, sdf=port_net(module, variables), sdf_max_df=1.0, device="cpu")
    N, B = 20, 4
    x0, p, yr, W = _scenarios(jc, N, B, seed=11)
    jstate = jax.vmap(lambda x: jinit(jocp, x, jnp.float64))(jnp.asarray(x0))
    tstate = tinit(tocp, torch.as_tensor(x0), torch.float64)
    for budget in ("cold", "warm", "steady"):
        jres = jax.jit(jax.vmap(jmake(jocp, jc, with_evals=True, budget=budget)))(
            jstate, _jax_inputs(x0, p, yr, W, N, jnp.float64))
        tres = tmake(tocp, tc, budget=budget)(tstate, _port_inputs(x0, p, yr, W, N,
                                                                   torch.float64))
        assert (np.asarray(jres.status) == 0).all() and (tres.status.numpy() == 0).all()
        for name, got, want in (("u0", tres.u0, jres.u0), ("X", tres.state.X, jres.state.X),
                                ("U", tres.state.U, jres.state.U)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                       err_msg=f"{budget} {name}")
        np.testing.assert_allclose(tres.evals.numpy(), np.asarray(jres.evals), atol=1e-6)
        # The KKT residual reads the final duals.  Where the QP has not
        # converged (residual ~1), the split between a soft row's lam and gam
        # is ill-determined: the JAX step itself gives 0.88 vmapped and 0.91
        # unbatched for the same scenario.  So it is held only where converged.
        j_kkt = np.asarray(jres.kkt_residual)
        conv = j_kkt < 1e-3
        np.testing.assert_allclose(tres.kkt_residual.numpy()[conv], j_kkt[conv], atol=1e-5)
        jstate, tstate = jres.state, tres.state
        x0 = np.asarray(jres.state.X[:, 1])  # the plant follows the prediction


def test_f32_rti_step_matches_jax_with_all_four_kernels_interpret():
    """f32, N=4 (nz=16, nc=15), the JAX step running its four Pallas kernels
    in interpret mode (lin_impl='pallas', chol_impl='fused', the fused f32
    sdf value+grad): u0 agrees to 1e-4."""
    from sdf_nmpc_tpu.nn import make_sdf_fn
    from sdf_nmpc_tpu.ocp import build_ocp as jbuild
    from sdf_nmpc_tpu.ops import make_fused_sdf_vg
    from sdf_nmpc_tpu.solver import init_state as jinit
    from sdf_nmpc_tpu.solver import make_rti_step as jmake
    from sdf_nmpc_tpu_torch.ocp import build_ocp as tbuild
    from sdf_nmpc_tpu_torch.solver import init_state as tinit
    from sdf_nmpc_tpu_torch.solver import make_rti_step as tmake

    N = 4
    jc, tc = _configs(lin_impl="pallas", chol_impl="fused", sdf_fused_dtype="f32")
    jc = jc.replace(mpc=dict(N=N, T=0.3))
    tc = tc.replace(mpc=dict(N=N, T=0.3))
    module, variables = jax_net(size_latent=L, embed="oct", act="sin", w0=2.0, seed=3)
    vg = make_fused_sdf_vg(module, variables, tile=8, interpret=True, dtype="f32")
    jocp = jbuild(jc, sdf_fn=make_sdf_fn(module, variables), sdf_max_df=1.0,
                  sdf_value_grad_batch=vg)
    tocp = tbuild(tc, sdf=port_net(module, variables, dtype=torch.float32), sdf_max_df=1.0,
                  device="cpu")
    x0, p, yr, W = _scenarios(jc, N, 3, seed=5)
    jres = jax.jit(jax.vmap(jmake(jocp, jc, with_evals=False)))(
        jax.vmap(lambda x: jinit(jocp, x, jnp.float32))(jnp.asarray(x0, jnp.float32)),
        _jax_inputs(x0, p, yr, W, N, jnp.float32))
    tres = tmake(tocp, tc, with_evals=False)(tinit(tocp, torch.as_tensor(x0), torch.float32),
                                             _port_inputs(x0, p, yr, W, N, torch.float32))
    assert (np.asarray(jres.status) == 0).all() and (tres.status.numpy() == 0).all()
    np.testing.assert_allclose(tres.u0.numpy(), np.asarray(jres.u0), atol=1e-4)


@pytest.mark.parametrize("over", [{}, {"qp_iters": 26}, {"qp_stiff_iters": None},
                                  {"qp_stiff_iters_steady": 6, "qp_iters_steady": 16},
                                  {"qp_stiff_k": 16, "qp_ratio_cap": "auto"}])
def test_budget_knobs_match_jax(over):
    from sdf_nmpc_tpu.solver.sqp import resolve_iter_budget as jbudget
    from sdf_nmpc_tpu.solver.sqp import resolve_stiff_knobs as jknobs
    from sdf_nmpc_tpu_torch.solver.sqp import resolve_iter_budget, resolve_stiff_knobs

    jc, tc = _configs(**over)
    assert resolve_stiff_knobs(tc) == jknobs(jc)
    for budget in ("cold", "warm", "steady"):
        assert resolve_iter_budget(tc, budget) == jbudget(jc, budget)


def test_init_and_shift_state_match_jax():
    from sdf_nmpc_tpu.solver import init_state as jinit
    from sdf_nmpc_tpu.solver import shift_state as jshift
    from sdf_nmpc_tpu_torch.solver import init_state as tinit
    from sdf_nmpc_tpu_torch.solver import shift_state as tshift

    class _Ocp:  # the fields init_state reads
        N, nx, nu, device = 5, 10, 4, torch.device("cpu")
        u_hover = np.array([0.49, 0.0, 0.0, 0.0])

    x0 = np.random.default_rng(0).normal(size=(2, 10))
    j = jax.vmap(lambda x: jinit(_Ocp, x, jnp.float64))(jnp.asarray(x0))
    t = tinit(_Ocp, torch.as_tensor(x0), torch.float64)
    np.testing.assert_array_equal(t.X.numpy(), np.asarray(j.X))
    np.testing.assert_array_equal(t.U.numpy(), np.asarray(j.U))
    X = np.random.default_rng(1).normal(size=(2, 6, 10))
    U = np.random.default_rng(2).normal(size=(2, 5, 4))
    for k in (0, 1, 3):
        js = jax.vmap(lambda a, b: jshift(type(j)(X=a, U=b), k))(jnp.asarray(X), jnp.asarray(U))
        ts = tshift(type(t)(X=torch.as_tensor(X), U=torch.as_tensor(U)), k)
        np.testing.assert_array_equal(ts.X.numpy(), np.asarray(js.X))
        np.testing.assert_array_equal(ts.U.numpy(), np.asarray(js.U))


def _narrow_ocp():
    from sdf_nmpc_tpu_torch.ocp import build_ocp

    module, variables = jax_net(size_latent=L)
    net = port_net(module, variables, dtype=torch.float32)
    _, tc = _configs()
    return build_ocp(tc, sdf=net, device="cpu"), tc, net


def test_unsupported_settings_raise():
    """The Riccati backend builds a step (since its port; 'auto' resolves
    to it beyond N = 20), and an unknown qp_backend raises, naming the
    values taken; recursive feasibility without its braking-distance
    polynomial raises and names the missing argument, as the JAX build_ocp
    does."""
    from sdf_nmpc_tpu_torch.ocp import build_ocp
    from sdf_nmpc_tpu_torch.solver import make_rti_step

    ocp, tc, net = _narrow_ocp()
    assert callable(make_rti_step(ocp, tc.replace(solver={"qp_backend": "riccati"})))
    with pytest.raises(ValueError, match="riccati"):
        make_rti_step(ocp, tc.replace(solver={"qp_backend": "sparse"}))
    with pytest.raises(ValueError, match="bdist_coeffs"):
        build_ocp(tc.replace(flags=dict(recursive_feasibility=True)), sdf=net, device="cpu")


@pytest.mark.parametrize("over", [{"chol_impl": "xla"}, {"chol_impl": "custom"},
                                  {"lin_impl": "xla"}, {"qp_data_bf16": True},
                                  {"qp_compute_dtype": "float64"}])
def test_unported_knob_values_raise(over):
    """A solver knob the port reads means what it means in the JAX package
    or raises: these values, once refused, build a step since their port
    (tests/test_torch_linalg.py, test_torch_solver_knobs.py), and the same
    knob with a value the JAX package does not take raises, naming the
    values taken: none is read and dropped."""
    from sdf_nmpc_tpu_torch.solver import make_rti_step

    ocp, tc, _ = _narrow_ocp()
    assert callable(make_rti_step(ocp, tc.replace(solver=over)))
    (knob, _), = over.items()
    with pytest.raises(ValueError, match=knob):
        make_rti_step(ocp, tc.replace(solver={knob: "bogus"}))


@pytest.mark.parametrize("over", [{"fused_sdf": False}, {"sdf_fused_dtype": "bf16"},
                                  {"sdf_fused_dtype": "mixed"}])
def test_ported_knob_values_build(over):
    """The SDF-row settings ported since the knob check came in build a step:
    the autodiff row and kernel 2's bf16 routes (on the CPU the exact plain
    version, tests/test_torch_sdf_fused.py)."""
    from sdf_nmpc_tpu_torch.solver import make_rti_step

    ocp, tc, _ = _narrow_ocp()
    assert callable(make_rti_step(ocp, tc.replace(solver=over)))


@pytest.mark.parametrize("over", [{"dual_warm_start": True}, {"ir_steps": 1},
                                  {"qp_stiff_k": 6}, {"chol_impl": "pallas"},
                                  {"chol_impl": "fused"}])
def test_composed_path_settings_build(over):
    """The settings that take the composed QP path build a step."""
    from sdf_nmpc_tpu_torch.solver import make_rti_step

    ocp, tc, _ = _narrow_ocp()
    assert callable(make_rti_step(ocp, tc.replace(solver=over)))
