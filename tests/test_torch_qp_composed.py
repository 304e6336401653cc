"""The composed QP path (solver/qp.py, kernels 5-8) against the JAX
solve_qp, and the dual-warm-started RTI tick against the JAX make_rti_step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_net, one_torch_thread, port_net, t32, t64  # noqa: F401  (fixtures)
from test_torch_ip_kernel import _qp
from test_torch_rti_step import L, _configs, _jax_inputs, _port_inputs, _scenarios


def _warm_duals(B, nz, nc, seed):
    """Positive slacks and duals of the scale an earlier tick leaves."""
    rng = np.random.default_rng(seed)
    return ([rng.uniform(0.05, 2.0, size=(B, nc)) for _ in range(6)]
            + [rng.uniform(0.05, 2.0, size=(B, nz)) for _ in range(2)])


CASES = {"warm duals": dict(k_stiff=8, warm=True), "ir_steps=1": dict(k_stiff=8, ir_steps=1),
         "k_stiff 6": dict(k_stiff=6), "k_stiff 8": dict(k_stiff=8)}


@pytest.mark.parametrize("case", list(CASES))
def test_composed_f64_matches_jax_solve_qp_xla(case):
    """f64, nz=16, nc=10, 8 warm + 6 stiff iterations: the port's composed
    path (chol_impl='pallas', plain versions of kernels 5-8 on the CPU)
    against the JAX solve_qp with XLA Cholesky under vmap.  dz and mu to
    1e-9; the KKT residual, which reads the final duals of near-active rows,
    to 1e-5 where it is determined: where the JAX solve converged below
    1e-4, or where the JAX package's vmapped and unbatched solves agree on
    it to 1e-7 (short of convergence the split of a near-active row's dual
    between lam and gam is ill-determined, and the JAX solve itself moves by
    1e-5 between the two).  Of the duals, the slacks, the box
    duals and each row's lam + gam (fixed by the slack stationarity row) to
    1e-6."""
    from sdf_nmpc_tpu.solver.qp import QpData as JQ
    from sdf_nmpc_tpu.solver.qp import QpDuals as JD
    from sdf_nmpc_tpu.solver.qp import solve_qp as jsolve
    from sdf_nmpc_tpu_torch.solver.qp import QpData as TQ
    from sdf_nmpc_tpu_torch.solver.qp import QpDuals as TD
    from sdf_nmpc_tpu_torch.solver.qp import solve_qp as tsolve

    kw = dict(CASES[case])
    warm = _warm_duals(4, 16, 10, seed=2) if kw.pop("warm", False) else None
    kw = {"iters": 14, "stiff_iters": 6, "mu0": 0.1, "box_margin": 1e-6, "ir_steps": 0, **kw}
    q = _qp(4, 16, 10, seed=7)
    jq = JQ(**{k: jnp.asarray(v) for k, v in q.items()})
    jw = None if warm is None else JD(*[jnp.asarray(a) for a in warm])
    one = jax.jit(lambda qq, d: jsolve(qq, chol_impl="xla", warm_duals=d, **kw))
    want = jax.jit(jax.vmap(one))(jq, jw)
    single = np.array([float(one(jax.tree.map(lambda a: a[b], jq),
                                 None if jw is None else jax.tree.map(lambda a: a[b], jw))
                             .kkt_residual) for b in range(4)])
    got = tsolve(TQ(**{k: t64(v) for k, v in q.items()}), chol_impl="pallas",
                 warm_duals=None if warm is None else TD(*[t64(a) for a in warm]), **kw)
    np.testing.assert_allclose(got.dz.numpy(), np.asarray(want.dz), atol=1e-9)
    np.testing.assert_allclose(got.complementarity.numpy(), np.asarray(want.complementarity),
                               rtol=1e-9, atol=1e-15)
    j_kkt = np.asarray(want.kkt_residual)
    held = (j_kkt < 1e-4) | (np.abs(single - j_kkt) <= 1e-7 * j_kkt)
    assert held.sum() >= 3
    np.testing.assert_allclose(got.kkt_residual.numpy()[held], j_kkt[held], atol=1e-5)
    g, w = got.duals, [np.asarray(a) for a in want.duals]
    for i in (0, 1, 6, 7):  # sl, su, nu_l, nu_u
        np.testing.assert_allclose(g[i].numpy(), w[i], atol=1e-6, err_msg=f"dual field {i}")
    for i in (2, 3):  # lam + gam per side
        np.testing.assert_allclose((g[i] + g[i + 2]).numpy(), w[i] + w[i + 2], atol=1e-6)


@pytest.mark.parametrize("k_stiff", [8, 4])
def test_pallas_f32_matches_jax_pallas_interpret(k_stiff):
    """f32, nz=16, nc=10, 8 warm + 4 stiff iterations, chol_impl='pallas' on
    both sides: the JAX path runs its lanes kernels in interpret mode (k=8:
    kernels 7 and 8; k=4: kernels 5 and 6 with the T factor in XLA), the port
    the plain versions.  dz to 1e-4 (tests/test_qp_kernels.py), or where
    larger twice the JAX package's own spread between its 'pallas' and
    'xla' paths on the same QPs, as tests/test_torch_ip_kernel.py holds the
    fused path."""
    from sdf_nmpc_tpu.solver.qp import QpData as JQ
    from sdf_nmpc_tpu.solver.qp import solve_qp as jsolve
    from sdf_nmpc_tpu_torch.solver.qp import QpData as TQ
    from sdf_nmpc_tpu_torch.solver.qp import solve_qp as tsolve

    q = {k: v.astype(np.float32) for k, v in _qp(4, 16, 10, seed=3).items()}
    kw = dict(iters=12, stiff_iters=4, k_stiff=k_stiff, ir_steps=0)
    jq = JQ(**{k: jnp.asarray(v) for k, v in q.items()})
    run = lambda impl: np.asarray(jax.jit(jax.vmap(
        lambda qq: jsolve(qq, chol_impl=impl, **kw).dz))(jq))
    want, xla = run("pallas"), run("xla")
    spread = float(np.abs(want - xla).max())
    got = tsolve(TQ(**{k: t32(v) for k, v in q.items()}), chol_impl="pallas", **kw)
    np.testing.assert_allclose(got.dz.numpy(), want, atol=max(1e-4, 2 * spread))


def test_dispatch_follows_jax_supported():
    """auto / fused take kernel 4 exactly where the JAX package's fused
    kernel is supported (qp.py:159-173); everything else and 'pallas' take
    the composed path.  Seen through which plain functions run."""
    from sdf_nmpc_tpu_torch.solver import qp as qp_mod

    q32 = qp_mod.QpData(**{k: t32(v) for k, v in _qp(2, 16, 10, seed=1).items()})
    q64 = qp_mod.QpData(*[t.double() for t in q32])
    warm = qp_mod.QpDuals(*[t32(a) for a in _warm_duals(2, 16, 10, seed=1)])
    seen = []
    orig_phase, orig_iter = qp_mod.make_fused_solve, qp_mod.run_phase

    def spy_fused(**kw):
        seen.append("fused")
        return orig_phase(**kw)

    def spy_iter(*a, **kw):
        seen.append("composed")
        return orig_iter(*a, **kw)

    cases = [(q32, dict(), "fused"), (q32, dict(chol_impl="fused"), "fused"),
             (q32, dict(chol_impl="pallas"), "composed"), (q64, dict(), "composed"),
             (q32, dict(warm_duals=warm), "composed"), (q32, dict(ir_steps=1), "composed"),
             (q32, dict(k_stiff=6), "composed"), (q32, dict(k_stiff=16), "composed"),
             (q32, dict(k_stiff=6, stiff_iters=0), "fused")]
    try:
        qp_mod.make_fused_solve, qp_mod.run_phase = spy_fused, spy_iter
        for q, kw, path in cases:
            seen.clear()
            kw = {"iters": 3, "stiff_iters": 1, "k_stiff": 8, **kw}
            qp_mod.solve_qp(q, **kw)
            assert set(seen) == {path}, (kw, seen)
    finally:
        qp_mod.make_fused_solve, qp_mod.run_phase = orig_phase, orig_iter


def test_dual_warm_started_ticks_match_jax_make_rti_step():
    """f64, narrow net, B=4, N=20, dual_warm_start: a cold tick from the
    seeded duals, then two warm ticks carrying the duals each tick leaves:
    u0, X, U to 1e-6, as tests/test_torch_rti_step.py holds the step
    without duals; the carried slacks, box duals and lam + gam per row to
    1e-6 (the lam / gam split of a near-active row is ill-determined short
    of convergence, see test_composed_f64_matches_jax_solve_qp_xla)."""
    from sdf_nmpc_tpu.nn import make_sdf_fn
    from sdf_nmpc_tpu.ocp import build_ocp as jbuild
    from sdf_nmpc_tpu.solver import init_state as jinit
    from sdf_nmpc_tpu.solver import make_rti_step as jmake
    from sdf_nmpc_tpu_torch.ocp import build_ocp as tbuild
    from sdf_nmpc_tpu_torch.solver import init_state as tinit
    from sdf_nmpc_tpu_torch.solver import make_rti_step as tmake

    jc, tc = _configs(dtype="float64", dual_warm_start=True)
    module, variables = jax_net(size_latent=L, embed="oct", act="sin", w0=2.0, seed=3)
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    jocp = jbuild(jc, sdf_fn=make_sdf_fn(module, v64), sdf_max_df=1.0)
    tocp = tbuild(tc, sdf=port_net(module, variables), sdf_max_df=1.0, device="cpu")
    N, B = 20, 4
    x0, p, yr, W = _scenarios(jc, N, B, seed=13)
    jstate = jax.vmap(lambda x: jinit(jocp, x, jnp.float64, dual_warm_start=True))(
        jnp.asarray(x0))
    tstate = tinit(tocp, torch.as_tensor(x0), torch.float64, dual_warm_start=True)
    for field, a in zip(tstate.qp_duals, jstate.qp_duals):
        np.testing.assert_array_equal(field.numpy(), np.asarray(a))
    for budget in ("cold", "warm", "warm"):
        jres = jax.jit(jax.vmap(jmake(jocp, jc, with_evals=False, budget=budget)))(
            jstate, _jax_inputs(x0, p, yr, W, N, jnp.float64))
        tres = tmake(tocp, tc, budget=budget, with_evals=False)(
            tstate, _port_inputs(x0, p, yr, W, N, torch.float64))
        assert (np.asarray(jres.status) == 0).all() and (tres.status.numpy() == 0).all()
        for name, got, want in (("u0", tres.u0, jres.u0), ("X", tres.state.X, jres.state.X),
                                ("U", tres.state.U, jres.state.U)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                       err_msg=f"{budget} {name}")
        g = tres.state.qp_duals
        w = [np.asarray(a) for a in jres.state.qp_duals]
        for i in (0, 1, 6, 7):  # sl, su, nu_l, nu_u
            np.testing.assert_allclose(g[i].numpy(), w[i], atol=1e-6,
                                       err_msg=f"{budget} dual field {i}")
        for i in (2, 3):  # lam + gam per side
            np.testing.assert_allclose((g[i] + g[i + 2]).numpy(), w[i] + w[i + 2], atol=1e-6,
                                       err_msg=f"{budget} lam + gam {i}")
        jstate, tstate = jres.state, tres.state
        x0 = np.asarray(jres.state.X[:, 1])  # the plant follows the prediction


def test_state_without_duals_returns_none():
    """new_duals only where the state carried duals (sqp.py:670)."""
    from sdf_nmpc_tpu_torch.ocp import build_ocp
    from sdf_nmpc_tpu_torch.solver import init_state, make_rti_step

    module, variables = jax_net(size_latent=L)
    _, tc = _configs(qp_iters=4, dual_warm_start=True)
    tc = tc.replace(mpc=dict(N=4, T=0.3))
    ocp = build_ocp(tc, sdf=port_net(module, variables, dtype=torch.float32), device="cpu")
    x0, p, yr, W = _scenarios(tc, 4, 2, seed=1)
    inp = _port_inputs(x0, p, yr, W, 4, torch.float32)
    step = make_rti_step(ocp, tc, with_evals=False)
    assert step(init_state(ocp, inp.x0), inp).state.qp_duals is None
    out = step(init_state(ocp, inp.x0, dual_warm_start=True), inp).state.qp_duals
    assert out is not None and out.sl.shape == (2, 4 * ocp.nh + ocp.nhN)
