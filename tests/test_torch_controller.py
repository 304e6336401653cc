"""The port's Nmpc controller, RefGen / Waypoint and make_batched_step
against their JAX counterparts (f64, narrow net)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_net, port_net
from test_torch_rti_step import L, _configs, _jax_inputs, _port_inputs, _scenarios


def _nets():
    module, variables = jax_net(size_latent=L, embed="oct", act="sin", w0=2.0, seed=3)
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    return module, v64, port_net(module, variables)


@pytest.mark.parametrize("dual_ws", [False, True])
def test_nmpc_ticks_match_jax(dual_ws):
    """Six closed-loop ticks of both controllers from the same start, each
    fed the JAX controller's predicted next state, waypoints from RefGen,
    sdf flag on with a latent: cold -> warm -> steady as in the JAX
    schedule, fail counts, u0, the clipped commands, the trajectory
    matrices and the sdf diagnostic to 1e-6 (the RTI step's own f64
    agreement, tests/test_torch_rti_step.py).  With dual_warm_start each
    tick starts from the duals the last one left, whose lam / gam split on
    near-active rows is ill-determined short of convergence (the JAX
    controller runs the unbatched step, the port a batch of one), so the
    two drift apart tick by tick (1.1e-5 on X by tick 5): 5e-5 there."""
    from sdf_nmpc_tpu.controller import Nmpc as JNmpc
    from sdf_nmpc_tpu.nn import make_sdf_fn
    from sdf_nmpc_tpu.ref_gen import RefGen as JRefGen
    from sdf_nmpc_tpu.ref_gen import Waypoint as JWaypoint
    from sdf_nmpc_tpu_torch.controller import Nmpc
    from sdf_nmpc_tpu_torch.ref_gen import RefGen, Waypoint

    jc, tc = _configs(dtype="float64", dual_warm_start=dual_ws)
    module, v64, net = _nets()
    jn = JNmpc(jc, sdf_fn=make_sdf_fn(module, v64))
    tn = Nmpc(tc, sdf=net, device="cpu")
    rng = np.random.default_rng(4)
    latent = rng.normal(size=L) * 0.2
    x = np.zeros(10)
    x[3] = 1.0
    x[:3] = [0.1, -0.2, 0.05]
    tol = 5e-5 if dual_ws else 1e-6
    budgets = []
    for tick in range(6):
        refs = []
        for n, gen, wp in ((jn, JRefGen(jc), JWaypoint), (tn, RefGen(tc), Waypoint)):
            n.set_sdf_flag(True)
            n.set_latent(latent, x[:3], np.eye(3))
            n.set_x0(x)
            gen.set_x0(x)
            refs.append(gen.gen_ref_list_wps([wp([2.0, 0.5, 1.0]), wp([3.0, 1.0, 1.0])]))
            n.set_refs(refs[-1])
        budgets.append(tn.budget)
        assert tn.solve() == jn.solve() == 0
        np.testing.assert_allclose(tn.get_u(), jn.get_u(), atol=tol, err_msg=f"tick {tick}")
        for name in ("get_cmd_acc", "get_cmd_TRPYr"):  # u times limits up to 20
            np.testing.assert_allclose(getattr(tn, name)(), getattr(jn, name)(), atol=20 * tol)
        for got, want in zip(tn.get_matrices(), jn.get_matrices()):
            np.testing.assert_allclose(got, want, atol=tol)
        np.testing.assert_allclose(tn.eval(5), jn.eval(5), atol=tol)
        for (pg, qg), (pw, qw) in zip(tn.get_openloop_traj(), jn.get_openloop_traj()):
            np.testing.assert_allclose(np.r_[pg, qg], np.r_[pw, qw], atol=tol)
        assert tn.get_t() > 0
        x = np.asarray(jn.get_matrices()[0][1])  # the plant follows the prediction
    assert budgets == ["cold", "warm", "warm", "warm", "steady", "steady"]


def test_nmpc_contracts():
    """solve before set_x0 raises; the perception arguments and a command
    map the model lacks raise and say why; dead reckoning keeps the
    predicted state; reset drops the warm start."""
    from sdf_nmpc_tpu_torch.controller import Nmpc

    _, tc = _configs(dtype="float64", qp_iters=4, qp_iters_warm=4, qp_iters_steady=4)
    tc = tc.replace(mpc=dict(N=4, T=0.3, allow_dead_reck=True))
    net = _nets()[2]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Nmpc(tc, sdf=net, bdist_coeffs=np.ones(5), device="cpu")
    n = Nmpc(tc, sdf=net, device="cpu")
    with pytest.raises(RuntimeError, match="set_x0"):
        n.solve()
    x = np.zeros(10)
    x[3] = 1.0
    n.set_x0(x)
    assert n.solve() == 0
    n.set_x0(x + 5.0, position_safe=False)
    np.testing.assert_array_equal(n.x0, n.get_matrices()[0][1])
    with pytest.raises(NotImplementedError):
        n.get_cmd_props()
    lo, hi = n.cmd_TRPYr_min, n.cmd_TRPYr_max
    assert ((n.get_cmd_TRPYr() >= lo) & (n.get_cmd_TRPYr() <= hi)).all()
    n.reset()
    assert n.x0 is None and n.budget == "cold"


def _ref_arrays(refs):
    return np.array([np.r_[r.p, r.q, r.v, r.wz] for r in refs])


@pytest.mark.parametrize("over", [dict(), dict(ref=dict(yaw_mode="ref")),
                                  dict(ref=dict(yaw_mode="zero")),
                                  dict(ref=dict(yaw_mode="current")),
                                  dict(ref=dict(stop_and_turn=dict(enable=True, dang_min=0.5)))])
def test_refgen_matches_jax(over):
    """Waypoint polylines, the joystick reference and the hover reference:
    every node's p, q, v and wz equal to 1e-12."""
    from sdf_nmpc_tpu.ref_gen import RefGen as JRefGen
    from sdf_nmpc_tpu.ref_gen import Waypoint as JWaypoint
    from sdf_nmpc_tpu_torch.ref_gen import RefGen, Waypoint

    jc, tc = _configs()
    jc, tc = jc.replace(**over), tc.replace(**over)
    x0 = np.zeros(10)
    x0[:3] = [0.3, -0.1, 1.0]
    x0[3:7] = [np.cos(0.4), 0, 0, np.sin(0.4)]
    wps = [([2.0, 1.5, 1.2], (np.cos(0.6), 0, 0, np.sin(0.6))), ([2.5, -1.0, 1.0], (1, 0, 0, 0))]
    jg, tg = JRefGen(jc), RefGen(tc)
    jg.set_x0(x0)
    tg.set_x0(x0)
    pairs = [(tg.gen_ref_list_wps([Waypoint(*w) for w in wps]),
              jg.gen_ref_list_wps([JWaypoint(*w) for w in wps])),
             (tg.gen_ref_list_wps([Waypoint([0.3, -0.1, 1.0])]),
              jg.gen_ref_list_wps([JWaypoint([0.3, -0.1, 1.0])])),
             (tg.gen_ref_joystick([0.5, -0.2, 0.1, 0.3]), jg.gen_ref_joystick([0.5, -0.2, 0.1, 0.3])),
             (tg.gen_ref_joystick([0.0, 0.0, 0.1, 0.3]), jg.gen_ref_joystick([0.0, 0.0, 0.1, 0.3])),
             (tg.from_x0(), jg.from_x0())]
    for got, want in pairs:
        assert len(got) == len(want)
        np.testing.assert_allclose(_ref_arrays(got), _ref_arrays(want), atol=1e-12)
    assert str(Waypoint(*wps[0])) == str(JWaypoint(*wps[0]))


def test_make_batched_step_matches_jax():
    """B=4, f64, cold budget: results and BatchStats of the port's batched
    step against the JAX make_batched_step (u0 1e-6; the counts equal; the
    KKT statistics to 1e-3 relative: the largest is a scenario short of
    convergence, whose residual reads the ill-determined lam / gam split,
    tests/test_torch_rti_step.py), and the stats equal
    to a reduction of the port's own results; replicate_inputs and
    stack_tree against the JAX helpers; a mesh raises."""
    from sdf_nmpc_tpu.nn import make_sdf_fn
    from sdf_nmpc_tpu.ocp import build_ocp as jbuild
    from sdf_nmpc_tpu.parallel import make_batched_step as jbatched
    from sdf_nmpc_tpu.parallel import replicate_inputs as jrep
    from sdf_nmpc_tpu.parallel import stack_tree as jstack
    from sdf_nmpc_tpu.solver import init_state as jinit
    from sdf_nmpc_tpu_torch.ocp import build_ocp as tbuild
    from sdf_nmpc_tpu_torch.parallel import make_batched_step, replicate_inputs, stack_tree
    from sdf_nmpc_tpu_torch.solver import init_state as tinit

    jc, tc = _configs(dtype="float64")
    module, v64, net = _nets()
    jocp = jbuild(jc, sdf_fn=make_sdf_fn(module, v64), sdf_max_df=1.0)
    tocp = tbuild(tc, sdf=net, sdf_max_df=1.0, device="cpu")
    N, B = 20, 4
    x0, p, yr, W = _scenarios(jc, N, B, seed=17)
    jres, jstats = jbatched(jocp, jc)(jax.vmap(lambda x: jinit(jocp, x, jnp.float64))(
        jnp.asarray(x0)), _jax_inputs(x0, p, yr, W, N, jnp.float64))
    step = make_batched_step(tocp, tc)
    tres, stats = step(tinit(tocp, torch.as_tensor(x0), torch.float64),
                       _port_inputs(x0, p, yr, W, N, torch.float64))
    np.testing.assert_allclose(tres.u0.numpy(), np.asarray(jres.u0), atol=1e-6)
    assert tres.evals is None
    assert int(stats.n_ok) == int(jstats.n_ok) and int(stats.n_failed) == int(jstats.n_failed)
    np.testing.assert_allclose(float(stats.max_kkt), float(jstats.max_kkt), rtol=1e-3)
    np.testing.assert_allclose(float(stats.mean_kkt), float(jstats.mean_kkt), rtol=1e-3)
    ok = tres.status == 0
    assert int(stats.n_ok) == int(ok.sum()) and int(stats.n_failed) == B - int(ok.sum())
    assert float(stats.max_kkt) == float(tres.kkt_residual.max())
    assert float(stats.mean_kkt) == float(tres.kkt_residual.mean())

    one = _port_inputs(x0[:1], p[:1], yr[:1], W[:1], N, torch.float64)
    single = type(one)(*[t[0] for t in one])
    jone = jax.tree.map(lambda a: a[0], _jax_inputs(x0[:1], p[:1], yr[:1], W[:1], N,
                                                    jnp.float64))
    for got, want in zip(replicate_inputs(single, 3), jrep(jone, 3)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    st = tinit(tocp, torch.as_tensor(x0), torch.float64, dual_warm_start=True)
    items = [type(st)(X=st.X[b], U=st.U[b], qp_duals=type(st.qp_duals)(*[d[b] for d in
                                                                         st.qp_duals]))
             for b in range(B)]
    stacked = stack_tree(items)
    jitems = [jax.tree.map(lambda a: np.asarray(a[b]), jax.vmap(
        lambda x: jinit(jocp, x, jnp.float64, dual_warm_start=True))(jnp.asarray(x0)))
        for b in range(B)]
    for got, want in zip(jax.tree.leaves(stacked.qp_duals), jax.tree.leaves(jstack(jitems).qp_duals)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(stacked.X.numpy(), st.X.numpy())
    assert stack_tree([type(st)(X=st.X[0], U=st.U[0])] * 2).qp_duals is None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_batched_step(tocp, tc, mesh=object())
