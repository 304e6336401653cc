"""The formulation extras of the port against the JAX package: the SDF cost
row, ``sdf_constraint: False``, the recursive-feasibility and stability
terminal ingredients and the caller's extension rows (constraints.py), in
``build_ocp``, the RTI step and the Nmpc controller.  f64 on the CPU with a
narrow network (latent 16, 4 x 32), the JAX side under the x64 of
tests/conftest.py; the recursive-feasibility accuracy workload with the
trained network against the independent oracle's recfeas_u0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_net, one_torch_thread, port_net, t64  # noqa: F401  (fixtures)
from test_torch_families import family_configs
from test_torch_family_step import family_scenarios, step_inputs

L = 16
RNG = np.random.default_rng(43)
VARIANTS = {
    "sdf_cost": dict(sdf_cost=True),
    "no_sdf_constraint": dict(sdf_constraint=False),
    "recfeas": dict(recursive_feasibility=True),
    "recfeas_stability": dict(recursive_feasibility=True, stability=True),
    "extensions": {},
}


def _extension_rows(cons, cfg, batched):
    """build_ocp's extra_* keywords from a constraints module (the JAX
    package's or the port's): roll stage and terminal rows, stage velocity
    rows, two half-space FoV rows, the yxvel cost rows, a terminal cost row
    and an eval row.  ``batched``: the port's row functions index the last
    axis."""
    roll_s, roll_t = cons.roll_const(cfg, slack=(50.0, 500.0))
    vel_s, _ = cons.vel_const(cfg)
    fov = cons.fov_const_normals(cfg, v_const=False, slack=(20.0, 200.0))
    if batched:
        term_cost, ev = (lambda x, p: x[..., 7] * x[..., 8]), (lambda x, u, p: x[..., 9] + u[..., 0])
    else:
        term_cost, ev = (lambda x, p: x[7] * x[8]), (lambda x, u, p: x[9] + u[0])
    return dict(extra_const_stage=roll_s + vel_s + fov, extra_const_term=roll_t,
                extra_cost_stage=cons.yxvel_cost(cfg, 2.0, 3.0),
                extra_cost_term=[(term_cost, 4.0)], extra_eval=[("vz_plus_u0", ev)])


def _ocps(model, variant, r_tilde=1.0, **solver):
    """(JAX cfg, JAX ocp, port cfg, port ocp, port net) of a variant on the
    narrow net, f64 parameters on both sides."""
    from sdf_nmpc_tpu import constraints as jcons
    from sdf_nmpc_tpu.nn import make_sdf_fn
    from sdf_nmpc_tpu.ocp import build_ocp as jbuild
    from sdf_nmpc_tpu.utils.accuracy import synthetic_bdist_coeffs
    from sdf_nmpc_tpu_torch import constraints as tcons
    from sdf_nmpc_tpu_torch.ocp import build_ocp as tbuild

    jc, tc = family_configs(model, nn=dict(size_latent=L), flags=VARIANTS[variant],
                            solver=solver)
    module, variables = jax_net(size_latent=L, embed="oct", act="sin", w0=2.0, seed=3)
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    net = port_net(module, variables)
    kw = dict(sdf_max_df=1.0, bdist_coeffs=synthetic_bdist_coeffs(jc), r_tilde=r_tilde)
    jext = _extension_rows(jcons, jc, False) if variant == "extensions" else {}
    text = _extension_rows(tcons, tc, True) if variant == "extensions" else {}
    jocp = jbuild(jc, sdf_fn=make_sdf_fn(module, v64), **kw, **jext)
    tocp = tbuild(tc, sdf=net, **kw, **text, device="cpu")
    return jc, jocp, tc, tocp, net


def _points(jcfg, nx, K):
    """K seeded (x, u, p) nodes: unnormalized quaternions near identity,
    velocities ~1 m/s, a rotated and shifted camera, flag 1 but on the last
    node (0.5), seeded latents."""
    from sdf_nmpc_tpu.params import ParamLayout

    lay = ParamLayout.from_cfg(jcfg)
    x = RNG.normal(size=(K, nx)) * 0.5
    x[:, 3:7] = np.array([1.0, 0, 0, 0]) + RNG.normal(size=(K, 4)) * 0.15
    x[:, 7:10] = RNG.normal(size=(K, 3))
    u = RNG.uniform(-0.8, 0.8, size=(K, 4))
    u[:, 0] = RNG.uniform(0.2, 0.8, size=K)
    p = np.zeros((K, lay.np_total))
    for k in range(K):
        Q, R = np.linalg.qr(np.eye(3) + RNG.normal(size=(3, 3)) * 0.2)
        Q = Q * np.sign(np.diag(R))  # near the identity, det +1
        lay.set_camera(p[k], RNG.normal(size=3) * 0.3, Q)
        lay.set_latent(p[k], RNG.normal(size=L) * 0.2)
        lay.set_q_d(p[k], [1.0, 0, 0, 0])
    lay.set_flag(p, 1.0)
    lay.set_flag(p[-1], 0.5)
    return x, u, p


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_build_ocp_matches_jax(variant):
    """ny, nyN, nh, nhN, every bound, slack and weight array, the eval
    names, and y, yN, h_stage, h_term and eval_fn on seeded nodes, to
    1e-12; r_tilde None (theory.stability's maximum) under stability."""
    jc, jocp, tc, tocp, net = _ocps("att", variant, r_tilde=None)
    for k in ("ny", "nyN", "nh", "nhN", "eval_names", "cheap_rows_pos_only",
              "cheap_stage_indices", "sdf_stage_idx"):
        assert getattr(tocp, k) == getattr(jocp, k), k
    for k in ("lh", "uh", "zl", "Zl", "lhN", "uhN", "zlN", "ZlN", "extra_W_stage",
              "extra_W_term", "lbu", "ubu", "dt", "cost_scaling"):
        np.testing.assert_allclose(getattr(tocp, k), getattr(jocp, k), rtol=1e-12, atol=0,
                                   err_msg=k)
    assert (tocp.sdf_row_batch is None) == (jocp.sdf_row_batch is None)
    x, u, p = _points(jc, jocp.nx, 9)
    J = lambda a: jnp.asarray(a)
    pairs = [("y", tocp.y(t64(x), t64(u), t64(p), net), jax.vmap(jocp.y)(J(x), J(u), J(p))),
             ("yN", tocp.yN(t64(x), t64(p)), jax.vmap(jocp.yN)(J(x), J(p)))]
    if jocp.nh:
        pairs.append(("h_stage", tocp.h_stage(t64(x), t64(u), t64(p), net),
                      jax.vmap(jocp.h_stage)(J(x), J(u), J(p))))
    if jocp.nhN:
        pairs.append(("h_term", tocp.h_term(t64(x), t64(p), net),
                      jax.vmap(jocp.h_term)(J(x), J(p))))
    pairs.append(("eval", tocp.eval_fn(t64(x), t64(u), t64(p), net),
                  jax.vmap(jocp.eval_fn)(J(x), J(u), J(p))))
    for name, got, want in pairs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    yr = RNG.normal(size=jocp.ny)
    from sdf_nmpc_tpu.ref_gen import Ref as JRef
    from sdf_nmpc_tpu_torch.ref_gen import Ref as TRef

    jref, tref = JRef(jc).use_constrained_weights(True), TRef(tc).use_constrained_weights(True)
    jref.p = tref.p = yr[:3]
    for got, want in zip(tocp.pack_ref(tref), jocp.pack_ref(jref)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_constraint_builders_match_jax():
    """Every constraints.py builder's rows (bounds and slacks, and each
    row's value on seeded nodes) against the JAX package's, to 1e-12, with
    and without a slack pair."""
    from sdf_nmpc_tpu import constraints as jcons
    from sdf_nmpc_tpu_torch import constraints as tcons

    jc, tc = family_configs("att", nn=dict(size_latent=L))
    x, u, p = _points(jc, 10, 11)
    J = lambda a: jnp.asarray(a)
    for slack in (None, (7.0, 70.0)):
        built = [(tcons.fov_const_normals(tc, slack=slack), jcons.fov_const_normals(jc, slack=slack),
                  True),
                 (tcons.fov_const_normals(tc, h_const=False, slack=slack),
                  jcons.fov_const_normals(jc, h_const=False, slack=slack), True)]
        for name in ("roll_const", "pitch_const"):
            (ts, tt), (js, jt) = getattr(tcons, name)(tc, slack), getattr(jcons, name)(jc, slack)
            built += [(ts, js, True), (tt, jt, False)]
        (ts, tt), (js, jt) = (tcons.vel_const(tc, term=True, slack=slack),
                              jcons.vel_const(jc, term=True, slack=slack))
        built += [(ts, js, True), (tt, jt, False)]
        for trows, jrows, stage in built:
            assert len(trows) == len(jrows) > 0
            for tr, jr in zip(trows, jrows):
                assert tuple(tr[1:]) == tuple(jr[1:])
                if stage:
                    got, want = tr[0](t64(x), t64(u), t64(p)), jax.vmap(jr[0])(J(x), J(u), J(p))
                else:
                    got, want = tr[0](t64(x), t64(p)), jax.vmap(jr[0])(J(x), J(p))
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    for tr, jr in zip(tcons.yxvel_cost(tc, 2.0, 3.0), jcons.yxvel_cost(jc, 2.0, 3.0)):
        assert tr[1] == jr[1]
        np.testing.assert_array_equal(tr[0](t64(x), t64(u), t64(p)).numpy(),
                                      np.asarray(jax.vmap(jr[0])(J(x), J(u), J(p))))


def check_step_matches_jax(variant, model):
    """The port's f64 step against the JAX make_rti_step, B=2, N=20: a cold
    tick, then a steady tick from its state, the plant following the JAX
    prediction; u0, X, U and the evals to 1e-6 (the step's agreement on the
    main path, tests/test_torch_rti_step.py)."""
    from sdf_nmpc_tpu.solver import SolveInputs as JInputs
    from sdf_nmpc_tpu.solver import init_state as jinit
    from sdf_nmpc_tpu.solver import make_rti_step as jmake
    from sdf_nmpc_tpu_torch.solver import SolveInputs as TInputs
    from sdf_nmpc_tpu_torch.solver import init_state as tinit
    from sdf_nmpc_tpu_torch.solver import make_rti_step as tmake

    jc, jocp, tc, tocp, _ = _ocps(model, variant, dtype="float64")
    N, B = jocp.N, 2
    x0, p, yr, W = family_scenarios(jc, jocp, B, seed=29)
    jT = lambda a: jnp.asarray(a, jnp.float64)
    tT = lambda a: torch.as_tensor(np.array(a), dtype=torch.float64)
    jstate = jax.vmap(lambda x: jinit(jocp, x, jnp.float64))(jnp.asarray(x0))
    tstate = tinit(tocp, torch.as_tensor(x0), torch.float64)
    for budget in ("cold", "steady"):
        jres = jax.jit(jax.vmap(jmake(jocp, jc, budget=budget)))(
            jstate, step_inputs(JInputs, jT, x0, p, yr, W, N, jocp.nyN))
        tres = tmake(tocp, tc, budget=budget)(
            tstate, step_inputs(TInputs, tT, x0, p, yr, W, N, tocp.nyN))
        assert (np.asarray(jres.status) == 0).all() and (tres.status.numpy() == 0).all()
        for name, got, want in (("u0", tres.u0, jres.u0), ("X", tres.state.X, jres.state.X),
                                ("U", tres.state.U, jres.state.U),
                                ("evals", tres.evals, jres.evals)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                       err_msg=f"{variant} {model} {budget} {name}")
        jstate, tstate = jres.state, tres.state
        x0 = np.asarray(jres.state.X[:, 1])


@pytest.mark.parametrize("variant,model", [("recfeas_stability", "att"),
                                           ("recfeas_stability", "rates"), ("extensions", "att")])
def test_f64_rti_step_matches_jax(variant, model):
    """Recursive feasibility with stability (on rates through the body-frame
    vel_world) and the extension rows; tests/test_torch_sdf_cost_step.py
    holds the sdf_cost steps."""
    check_step_matches_jax(variant, model)


def test_sdf_cost_step_takes_kernel_9_and_no_sdf_row_fast_path():
    """Under sdf_cost the OCP's residual is wider than the model's, so the
    step takes kernel 9 for every family (kernel 1 for none) and no fast
    SDF row; recursive feasibility keeps kernel 1 and the fast row.  f32:
    every tensor the condensing kernel receives is float32 (on the card a
    float64 one would not reach it), torch.func's tangents included."""
    from sdf_nmpc_tpu_torch.ops import condense_kernel, lin_kernels
    from sdf_nmpc_tpu_torch.solver import init_state, make_rti_step

    for variant, want in (("sdf_cost", ("erk4_sens", "lin_y_sens")),
                          ("recfeas", ("lin_y_sens", "erk4_sens"))):
        jc, jocp, tc, tocp, _ = _ocps("att", variant)
        assert (tocp.ny != tocp.model.ny) == (variant == "sdf_cost")
        assert (tocp.sdf_row_batch is None) == (variant == "sdf_cost")
        called = {name: 0 for name in want}
        saved = {name: getattr(lin_kernels, name) for name in want}
        saved_condense, dtypes = condense_kernel.condense, set()

        def counted(name):
            def fn(*a):
                called[name] += 1
                return saved[name](*a)
            return fn

        def condense(*a):
            dtypes.update(t.dtype for t in a)
            return saved_condense(*a)

        try:
            condense_kernel.condense = condense
            for name in want:
                setattr(lin_kernels, name, counted(name))
            x0, p, yr, W = family_scenarios(jc, jocp, 2, seed=5)
            T = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
            from sdf_nmpc_tpu_torch.solver import SolveInputs

            res = make_rti_step(tocp, tc, with_evals=False)(
                init_state(tocp, T(x0)), step_inputs(SolveInputs, T, x0, p, yr, W, tocp.N,
                                                     tocp.nyN))
        finally:
            condense_kernel.condense = saved_condense
            for name, fn in saved.items():
                setattr(lin_kernels, name, fn)
        assert called == {want[0]: 1, want[1]: 0}, (variant, called)
        assert dtypes == {torch.float32}, (variant, dtypes)
        assert torch.isfinite(res.u0).all()


def test_f64_recfeas_step_matches_oracle():
    """The port's f64 step with 40 IP iterations on the recursive-
    feasibility workload (the trained network, the synthetic braking
    polynomial, r_tilde 1.0) against the independent oracle's recfeas_u0
    within 2e-6, the JAX package's own anchor
    (tests/test_oracle_parity.py::test_f64_matches_oracle)."""
    from sdf_nmpc_tpu_torch.utils import accuracy

    rep = accuracy.check_accuracy(device="cpu", variant="recfeas",
                                  solver_over=dict(dtype="float64", qp_iters=40))
    assert rep["n_scen"] == 8 and rep["n_ok"] == 8 and rep["u0_max_err"] <= 2e-6, rep


def test_f32_plain_recfeas_step_meets_ci_gate_vs_oracle():
    """The port's f32 plain path on the CPU, the recursive-feasibility
    workload's 8 cold scenarios against the oracle's recfeas_u0: the JAX
    package's CI gate (mean <= 2.5e-4, max <= 2.5e-3), every status OK."""
    from sdf_nmpc_tpu_torch.utils import accuracy

    rep = accuracy.check_accuracy(device="cpu", variant="recfeas")
    assert rep["n_scen"] == 8 and rep["n_ok"] == 8
    assert accuracy.ci_gate_ok(rep["u0_mean_err"], rep["u0_max_err"]), rep


def test_synthetic_bdist_coeffs_match_jax():
    from sdf_nmpc_tpu.utils.accuracy import synthetic_bdist_coeffs as jcoeffs
    from sdf_nmpc_tpu_torch.utils.accuracy import synthetic_bdist_coeffs as tcoeffs

    jc, tc = family_configs("att")
    np.testing.assert_array_equal(tcoeffs(tc), jcoeffs(jc))


def test_nmpc_with_bdist_and_r_tilde_matches_jax():
    """Both controllers built from (cfg, network, bdist_coeffs, r_tilde)
    with recursive feasibility and stability on, f64: one cold tick from the
    same start and waypoints, u0, the trajectory matrices and every node's
    diagnostics (sdf, braking_dist, rec_feas_margin) to 1e-6."""
    from sdf_nmpc_tpu.controller import Nmpc as JNmpc
    from sdf_nmpc_tpu.nn import make_sdf_fn
    from sdf_nmpc_tpu.ref_gen import RefGen as JRefGen
    from sdf_nmpc_tpu.ref_gen import Waypoint as JWaypoint
    from sdf_nmpc_tpu.utils.accuracy import synthetic_bdist_coeffs
    from sdf_nmpc_tpu_torch.controller import Nmpc
    from sdf_nmpc_tpu_torch.ref_gen import RefGen, Waypoint

    jc, tc = family_configs("att", nn=dict(size_latent=L), solver=dict(dtype="float64"),
                            flags=VARIANTS["recfeas_stability"])
    module, variables = jax_net(size_latent=L, embed="oct", act="sin", w0=2.0, seed=3)
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    coeffs = synthetic_bdist_coeffs(jc)
    jn = JNmpc(jc, sdf_fn=make_sdf_fn(module, v64), bdist_coeffs=coeffs, r_tilde=2.0)
    tn = Nmpc(tc, sdf=port_net(module, variables), bdist_coeffs=coeffs, r_tilde=2.0,
              device="cpu")
    assert tn.ocp.eval_names == ("sdf", "braking_dist", "rec_feas_margin")
    np.testing.assert_allclose(tn.ocp.extra_W_term, jn.ocp.extra_W_term, rtol=1e-12)
    latent = np.random.default_rng(4).normal(size=L) * 0.2
    x = np.zeros(10)
    x[3] = 1.0
    x[:3], x[7:10] = [0.1, -0.2, 0.05], [0.4, 0.1, 0.0]
    for n, gen, wp in ((jn, JRefGen(jc), JWaypoint), (tn, RefGen(tc), Waypoint)):
        n.set_sdf_flag(True)
        n.set_latent(latent, x[:3], np.eye(3))
        n.set_x0(x)
        gen.set_x0(x)
        n.set_refs(gen.gen_ref_list_wps([wp([2.0, 0.5, 1.0]), wp([3.0, 1.0, 1.0])]))
    assert tn.solve() == jn.solve() == 0
    np.testing.assert_allclose(tn.get_u(), jn.get_u(), atol=1e-6)
    for got, want in zip(tn.get_matrices(), jn.get_matrices()):
        np.testing.assert_allclose(got, want, atol=1e-6)
    for k in range(tc.mpc.N + 1):
        np.testing.assert_allclose(tn.eval(k), jn.eval(k), atol=1e-6, err_msg=f"node {k}")


@pytest.mark.parametrize("over", [{}, {"qp_stiff_iters_warm": 11}, {"qp_stiff_iters_warm": None}])
def test_recfeas_budgets_match_jax(over):
    """The wide stiff split of recursive feasibility: k_stiff 48 and 16
    stiff iterations cold, 26 / 22 / 22 IP iterations, and the steady
    budget's stiff count inherited from the warm one (tests/test_budgets.py's
    expectations), per budget as the JAX resolution gives them."""
    from sdf_nmpc_tpu.solver.sqp import resolve_iter_budget as jbudget
    from sdf_nmpc_tpu.solver.sqp import resolve_stiff_knobs as jknobs
    from sdf_nmpc_tpu_torch.solver.sqp import _budget_knobs

    jc, tc = family_configs("att", flags=VARIANTS["recfeas_stability"], solver=over)
    k, si, cap = jknobs(jc)
    warm_si = jc.solver.get("qp_stiff_iters_warm", si)
    want = {"cold": (jbudget(jc, "cold"), k, si, cap), "warm": (jbudget(jc, "warm"), k, warm_si, cap),
            "steady": (jbudget(jc, "steady"), k, warm_si, cap)}
    assert want["cold"][:3] == (26, 48, 16)
    assert [want[b][0] for b in ("warm", "steady")] == [22, 22]
    for budget, w in want.items():
        assert _budget_knobs(tc, budget) == w, budget
