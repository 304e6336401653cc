"""The stage-wise (Riccati) QP backend: the port's ``solve_qp_riccati`` and
its RTI step against the JAX package's (f64), against the port's condensed
backend (tests/test_qp_riccati.py's bounds), and its f32 plain path on the
accuracy goldens.

The KKT residual reads the final duals of near-active rows, whose barrier
ratios reach ~1e10 even in f64: where the interior point sits at its
floating-point floor (mu near 32 eps), the final iterate's duals are
ill-determined and the residual moves by far more than the iterate under a
last-bit change of the input.  So it is held per scenario within max(tol,
10 x the JAX package's own drift), the drift being the largest change of
the JAX residual over DRIFT_DRAWS seeded relative perturbations of 1e-14
of its inputs, measured in the same test; ddx, ddu, u0, X and U (the best
iterate) are held flat."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_net, one_torch_thread, port_net  # noqa: F401  (fixtures)

L = 8  # narrow net: latent 8, 4 x 32
PERTURB = 1e-14
DRIFT_DRAWS = 3


def _jax_drift(run, want, *args):
    """The largest change of the JAX KKT residual over DRIFT_DRAWS seeded
    relative perturbations of PERTURB of the float arrays in args."""
    rng = np.random.default_rng(0)
    drift = np.zeros(np.shape(want))
    for _ in range(DRIFT_DRAWS):
        moved = jax.tree.map(lambda a: a * (1 + PERTURB * rng.normal(size=np.shape(a))), args)
        drift = np.maximum(drift, np.abs(np.asarray(run(*moved).kkt_residual) - np.asarray(want)))
    return drift


def _stage_data(B, N, nx, nu, nh, nhN, seed):
    """Seeded StageQpData fields: SPD stage Hessians, stable-ish dynamics,
    rows that the [-1, 1] bounds leave near-active, a du box of +-0.5."""
    rng = np.random.default_rng(seed)

    def spd(*s, n):
        M = rng.normal(size=s + (n, n))
        return M @ np.swapaxes(M, -1, -2) / n + 0.1 * np.eye(n)

    return dict(
        Q=spd(B, N + 1, n=nx), q=rng.normal(size=(B, N + 1, nx)), R=spd(B, N, n=nu),
        r=rng.normal(size=(B, N, nu)), Ssu=0.05 * rng.normal(size=(B, N, nu, nx)),
        A=np.eye(nx) + 0.1 * rng.normal(size=(B, N, nx, nx)),
        B=0.3 * rng.normal(size=(B, N, nx, nu)), b=0.05 * rng.normal(size=(B, N, nx)),
        e0=0.1 * rng.normal(size=(B, nx)), Cx=rng.normal(size=(B, N, nh, nx)),
        Cu=rng.normal(size=(B, N, nh, nu)), c=rng.normal(size=(B, N, nh)),
        lh=np.full((B, nh), -1.0), uh=np.full((B, nh), 1.0), z1=np.full((B, N, nh), 20.0),
        z2=np.full((B, N, nh), 5.0), CxN=rng.normal(size=(B, nhN, nx)),
        cN=rng.normal(size=(B, nhN)), lhN=np.full((B, nhN), -1.0), uhN=np.full((B, nhN), 1.0),
        z1N=np.full((B, nhN), 30.0), z2N=np.full((B, nhN), 5.0),
        lb=np.full((B, N, nu), -0.5), ub=np.full((B, N, nu), 0.5))


def _kkt_held(got, want, drift, tol, label):
    lim = np.maximum(tol, 10 * drift)
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert (d <= lim).all(), f"{label}: KKT residual off by {d} against {lim}"


@pytest.mark.parametrize("k_stiff", [0, 2])
def test_solve_qp_riccati_matches_jax(k_stiff):
    """B 3, N 8, nx 10, nu 4, nh 3, nhN 2, 12 iterations (the last 4 with
    the stiff split): ddx, ddu and the complementarity at 1e-10; the KKT
    residual at 1e-10 or the JAX package's own drift (module doc)."""
    from sdf_nmpc_tpu.solver.qp_riccati import StageQpData as JS
    from sdf_nmpc_tpu.solver.qp_riccati import solve_qp_riccati as jsolve
    from sdf_nmpc_tpu_torch.solver import StageQpData, solve_qp_riccati

    d = _stage_data(3, 8, 10, 4, 3, 2, seed=0)
    kw = dict(iters=12, stiff_iters=4, k_stiff=k_stiff)
    run = jax.jit(jax.vmap(lambda s: jsolve(s, **kw)))
    jd = JS(**{k: jnp.asarray(v) for k, v in d.items()})
    want = run(jd)
    got = solve_qp_riccati(StageQpData(**{k: torch.as_tensor(v) for k, v in d.items()}), **kw)
    for name in ("ddx", "ddu", "complementarity"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-10, rtol=0, err_msg=name)
    _kkt_held(got.kkt_residual.numpy(), want.kkt_residual,
              _jax_drift(run, want.kkt_residual, jd), 1e-10, f"k_stiff {k_stiff}")


def _ocps(model, N, **solver):
    """(JAX cfg, JAX ocp, port cfg, port ocp) on the narrow net, f64
    parameters on both sides; T = 0.075 N, the reference's interval."""
    from sdf_nmpc_tpu.nn import make_sdf_fn
    from sdf_nmpc_tpu.ocp import build_ocp as jbuild
    from sdf_nmpc_tpu_torch.ocp import build_ocp as tbuild
    from test_torch_families import family_configs

    jc, tc = family_configs(model, nn=dict(size_latent=L), solver=solver,
                            mpc=dict(N=N, T=0.075 * N))
    module, variables = jax_net(size_latent=L, embed="oct", act="sin", w0=2.0, seed=3)
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    jocp = jbuild(jc, sdf_fn=make_sdf_fn(module, v64), sdf_max_df=1.0)
    tocp = tbuild(tc, sdf=port_net(module, variables), sdf_max_df=1.0, device="cpu")
    return jc, jocp, tc, tocp


def _scenarios(jcfg, jocp, B, seed):
    """(x0, p, yref, W) batches of hard random starts as utils/accuracy.py
    draws them, half with the constrained weights (test_torch_family_step's
    draw at latent 8)."""
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


def _held_against_jax(model, N, budgets, **solver):
    """The port's f64 step against the JAX make_rti_step on 4 scenarios,
    the budgets chained, the plant following the JAX prediction: u0, X and
    U at 1e-9; the KKT residual at 1e-9 or the JAX drift (module doc)."""
    from sdf_nmpc_tpu.solver import SolveInputs as JInputs
    from sdf_nmpc_tpu.solver import init_state as jinit
    from sdf_nmpc_tpu.solver import make_rti_step as jmake
    from sdf_nmpc_tpu_torch.solver import SolveInputs as TInputs
    from sdf_nmpc_tpu_torch.solver import init_state as tinit
    from sdf_nmpc_tpu_torch.solver import make_rti_step as tmake
    from test_torch_family_step import step_inputs

    jc, jocp, tc, tocp = _ocps(model, N, dtype="float64", **solver)
    B = 4
    x0, p, yr, W = _scenarios(jc, jocp, B, seed=29)
    jT = lambda a: jnp.asarray(a, jnp.float64)
    tT = lambda a: torch.as_tensor(np.array(a), dtype=torch.float64)
    jstate = jax.vmap(lambda x: jinit(jocp, x, jnp.float64))(jnp.asarray(x0))
    tstate = tinit(tocp, torch.as_tensor(x0), torch.float64)
    for budget in budgets:
        run = jax.jit(jax.vmap(jmake(jocp, jc, with_evals=False, budget=budget)))
        jinp = step_inputs(JInputs, jT, x0, p, yr, W, N, jocp.nyN)
        jres = run(jstate, jinp)
        tres = tmake(tocp, tc, budget=budget, with_evals=False)(
            tstate, step_inputs(TInputs, tT, x0, p, yr, W, N, tocp.nyN))
        assert (np.asarray(jres.status) == 0).all() and (tres.status.numpy() == 0).all()
        for name, got, want in (("u0", tres.u0, jres.u0), ("X", tres.state.X, jres.state.X),
                                ("U", tres.state.U, jres.state.U)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9, rtol=0,
                                       err_msg=f"{model} N={N} {budget} {name}")
        drift = _jax_drift(run, jres.kkt_residual, jstate, jinp)
        _kkt_held(tres.kkt_residual.numpy(), jres.kkt_residual, drift, 1e-9,
                  f"{model} N={N} {budget}")
        jstate, tstate = jres.state, tres.state
        x0 = np.asarray(jres.state.X[:, 1])


def test_riccati_rti_step_matches_jax_cold_warm_steady():
    """att, qp_backend riccati at the reference N = 20: cold, warm and
    steady ticks chained (kernel 1's and 2's plain versions, the stiff
    split on the last iterations of each budget)."""
    _held_against_jax("att", 20, ("cold", "warm", "steady"), qp_backend="riccati")


def test_auto_backend_takes_riccati_beyond_n20_as_jax():
    """qp_backend auto at N = 30 resolves to the Riccati backend on both
    sides (JAX sqp.py:101-111) and the cold steps agree."""
    from sdf_nmpc_tpu.solver.sqp import resolve_qp_backend as jresolve
    from sdf_nmpc_tpu_torch.solver import resolve_qp_backend

    jc, _, tc, _ = _ocps("att", 30)
    assert resolve_qp_backend(tc, 30) == jresolve(jc, 30) == "riccati"
    assert resolve_qp_backend(tc, 20) == jresolve(jc, 20) == "condensed"
    _held_against_jax("att", 30, ("cold",))


def test_riccati_rti_step_matches_jax_props():
    """props at N = 20 on the Riccati backend: kernel 9's plain version and
    the torch.func residual rows feed the stage Hessians."""
    _held_against_jax("props", 20, ("cold",), qp_backend="riccati")


def _port_backends(sdf, **upd):
    """(ocp, condensed step, Riccati step) of the port at 40 IP iterations,
    f64, on the CPU (tests/test_qp_riccati.py's _step_pair)."""
    from sdf_nmpc_tpu_torch.config import default_config
    from sdf_nmpc_tpu_torch.ocp import build_ocp
    from sdf_nmpc_tpu_torch.solver import make_rti_step

    cfg = default_config().replace(nn=dict(size_latent=L), solver=dict(dtype="float64"), **upd)
    ocp = build_ocp(cfg, sdf=sdf, sdf_max_df=1.0, device="cpu")
    step = lambda backend: make_rti_step(ocp, cfg.replace(
        solver=dict(qp_backend=backend, qp_iters=40)), with_evals=False)
    return cfg, ocp, step("condensed"), step("riccati")


@pytest.mark.parametrize("rows", ["unconstrained", "sdf"])
def test_riccati_matches_the_ports_condensed_backend(rows):
    """Both backends solve the same barrier-smoothed QP: at 40 iterations
    in f64 their RTI steps agree at tests/test_qp_riccati.py's bounds, u0
    2e-6 and X 2e-5 without constraint rows (BASELINE config 1), u0 5e-5
    with the narrow net's SDF and FoV rows."""
    from sdf_nmpc_tpu_torch.solver import init_state

    if rows == "sdf":
        module, variables = jax_net(size_latent=L, embed="oct", act="sin", w0=2.0, seed=3)
        cfg, ocp, cond, ric = _port_backends(port_net(module, variables))
        assert ocp.nh > 0
    else:
        cfg, ocp, cond, ric = _port_backends(None, flags=dict(enable_sdf=False))
    x0, p, yr, W = _scenarios(cfg, ocp, 4, seed=1)
    from sdf_nmpc_tpu_torch.solver import SolveInputs
    from test_torch_family_step import step_inputs

    inp = step_inputs(SolveInputs, lambda a: torch.as_tensor(np.array(a), dtype=torch.float64),
                      x0, p, yr, W, ocp.N, ocp.nyN)
    st = init_state(ocp, inp.x0, torch.float64)
    rc, rr = cond(st, inp), ric(st, inp)
    assert (rc.status == 0).all() and (rr.status == 0).all()
    np.testing.assert_allclose(rr.u0.numpy(), rc.u0.numpy(), atol=2e-6 if rows != "sdf" else 5e-5)
    if rows != "sdf":
        np.testing.assert_allclose(rr.state.X.numpy(), rc.state.X.numpy(), atol=2e-5)


def test_riccati_f32_plain_path_on_the_golden_cold_starts():
    """qp_backend riccati at the f32 defaults on the 32 cold starts of the
    accuracy workload (the trained 4x256 NeuralDF) against the f64 golden:
    max <= 1e-3 and 32/32 status OK, the JAX package's own contract
    (tests/test_qp_riccati.py:103-115), on the port's plain path."""
    from sdf_nmpc_tpu_torch.utils import accuracy

    ref = np.load(accuracy.REF_NPZ)["u0"]
    u0, status = accuracy.solve_batch(device="cpu", solver_over={"qp_backend": "riccati"})
    assert (status == 0).all()
    err = np.abs(u0 - ref).max()
    assert err <= 1e-3, f"riccati f32 u0 max err {err:.3e}"
