"""BASELINE config 1, the obstacle-free waypoint NMPC (``flags.enable_sdf:
False``): no constraint rows (nh = nhN = 0), the plain condensing recursion
and a QP without general rows (nc = 0) on the composed path.  The port's f64
step against the JAX make_rti_step on att, acc and att_tau (rates, wrench and
props in test_torch_nosdf_families.py), the port's f64 step against the
independent oracle, the composed
nc = 0 solve against the JAX solve_qp, the port's f32 plain step against the
independent oracle's ``nosdf_u0`` under the CI gate, and the Nmpc controller
without a network."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_families import family_configs
from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)

NOSDF = dict(flags=dict(enable_sdf=False))


def waypoint_scenarios(jcfg, jocp, B, seed):
    """(x0, p, yref, W) batches: hard random starts as utils/accuracy.py
    draws them (body rates for nx = 13), goals 1.5 m apart, half with the
    constrained weights; no camera, latent or flag (config 1 reads none)."""
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
    lay.set_q_d(p, [1, 0, 0, 0])
    yr, W = [], []
    for b in range(B):
        ref = Ref(jcfg).use_constrained_weights(bool(b % 2))
        ref.p = rng.normal(size=3) * 1.5
        y_, w_ = jocp.pack_ref(ref)
        yr.append(y_)
        W.append(w_)
    return x0, p, np.stack(yr), np.stack(W)


def chained_ticks_match(jc, jocp, tc, tocp, budgets, B=3, seed=0, atol=1e-6, scenarios=None):
    """The port's f64 step against the JAX step over ``budgets`` chained, the
    plant following the JAX prediction: status OK on both sides, u0, X and
    U within atol; returns the port's last result.  The JAX step runs jitted
    on one scenario at a time (its tracing under vmap takes twice as long),
    the port's batched."""
    from sdf_nmpc_tpu.solver import SolveInputs as JInputs
    from sdf_nmpc_tpu.solver import init_state as jinit
    from sdf_nmpc_tpu.solver import make_rti_step as jmake
    from sdf_nmpc_tpu_torch.solver import SolveInputs as TInputs
    from sdf_nmpc_tpu_torch.solver import init_state as tinit
    from sdf_nmpc_tpu_torch.solver import make_rti_step as tmake

    N, nyN = jocp.N, jocp.nyN
    x0, p, yr, W = (scenarios or waypoint_scenarios)(jc, jocp, B, seed)

    def inputs(cls, T):
        return cls(x0=T(x0), yref=T(np.repeat(yr[:, None], N, 1)),
                   W=T(np.repeat(W[:, None], N, 1)), yrefN=T(yr[:, :nyN]), WN=T(W[:, :nyN]),
                   p=T(p))

    jT = lambda a: jnp.asarray(a, jnp.float64)
    tT = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    jstate = jax.vmap(lambda x: jinit(jocp, x, jnp.float64))(jnp.asarray(x0))
    tstate = tinit(tocp, torch.as_tensor(x0), torch.float64)
    for budget in budgets:
        jstep, jinp = jax.jit(jmake(jocp, jc, with_evals=False, budget=budget)), inputs(JInputs,
                                                                                       jT)
        each = [jstep(*jax.tree.map(lambda a: a[b], (jstate, jinp))) for b in range(B)]
        jres = jax.tree.map(lambda *a: jnp.stack(a), *each)
        tres = tmake(tocp, tc, budget=budget, with_evals=False)(tstate, inputs(TInputs, tT))
        assert (np.asarray(jres.status) == 0).all() and (tres.status.numpy() == 0).all()
        for name, got, want in (("u0", tres.u0, jres.u0), ("X", tres.state.X, jres.state.X),
                                ("U", tres.state.U, jres.state.U)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                                       err_msg=f"{budget} {name}")
        jstate, tstate = jres.state, tres.state
        x0 = np.asarray(jres.state.X[:, 1])
    return tres


def test_nosdf_ocp_has_no_rows():
    """build_ocp with enable_sdf off takes no network and builds no row, as
    the JAX build_ocp (nh = nhN = 0, no diagnostics)."""
    from sdf_nmpc_tpu.ocp import build_ocp as jbuild
    from sdf_nmpc_tpu_torch.ocp import build_ocp

    jc, tc = family_configs("att", **NOSDF)
    jocp, tocp = jbuild(jc), build_ocp(tc, device="cpu")
    assert (tocp.nh, tocp.nhN, tocp.eval_names) == (jocp.nh, jocp.nhN, jocp.eval_names) == (
        0, 0, ())
    assert tocp.sdf is None and tocp.h_term is None and tocp.sdf_row_batch is None
    for name in ("lh", "uh", "zl", "Zl", "lhN", "uhN", "zlN", "ZlN"):
        assert getattr(tocp, name).shape == (0,)


def nosdf_step_matches_jax(model):
    """f64, enable_sdf off, B=3, N=20: a cold tick then a steady one chained:
    status OK, u0, X and U within 1e-6 (the f64 step's agreement with sdf;
    the JAX package's own f64 anchor to its oracle is 2e-6).  No evals:
    config 1 has no diagnostics."""
    from sdf_nmpc_tpu.ocp import build_ocp as jbuild
    from sdf_nmpc_tpu_torch.ocp import build_ocp

    jc, tc = family_configs(model, solver=dict(dtype="float64"), **NOSDF)
    res = chained_ticks_match(jc, jbuild(jc), tc, build_ocp(tc, device="cpu"),
                              ("cold", "steady"), seed=41)
    assert res.evals is None


@pytest.mark.parametrize("model", ["att", "acc", "att_tau"])
def test_f64_nosdf_step_matches_jax(model):
    """The families with a component-form residual (kernel 1's plain
    version); rates, wrench and props in test_torch_nosdf_families.py."""
    nosdf_step_matches_jax(model)


def _nc0_qp(B, nz, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, nz, nz))
    return dict(H=np.einsum("bij,bkj->bik", A, A) + nz * np.eye(nz),
                g=rng.normal(size=(B, nz)) * 5, C=np.zeros((B, 0, nz)), c0=np.zeros((B, 0)),
                lh=np.zeros((B, 0)), uh=np.zeros((B, 0)), z1=np.zeros((B, 0)),
                z2=np.zeros((B, 0)), lb=np.full((B, nz), -0.3), ub=np.full((B, nz), 0.4))


def test_nc0_composed_solve_matches_jax_solve_qp():
    """A box-bounded QP without general rows (nc = 0), f64, 20 iterations with
    the 8-iteration stiff tail (k_s = min(8, 0) = 0, the tail average): the
    composed path (kernels 5 and 6's plain versions on H + diag(rb)) against
    the JAX solve_qp with chol_impl='xla'.  dz, KKT residual and
    complementarity within 1e-9 (one f64 IP computation in two orders of
    sums); the box is active, so the barrier terms are exercised."""
    from sdf_nmpc_tpu.solver.qp import QpData as JQp
    from sdf_nmpc_tpu.solver.qp import solve_qp as jsolve
    from sdf_nmpc_tpu_torch.solver.qp import QpData, solve_qp

    q = _nc0_qp(3, 12, seed=5)
    kw = dict(iters=20, stiff_iters=8, k_stiff=8, mu0=0.1, box_margin=1e-6)
    want = jax.jit(jax.vmap(lambda d: jsolve(d, chol_impl="xla", **kw)))(
        JQp(**{k: jnp.asarray(v) for k, v in q.items()}))
    got = solve_qp(QpData(**{k: torch.as_tensor(v) for k, v in q.items()}), **kw)
    dz = np.asarray(want.dz)
    assert (np.isclose(dz, -0.3, atol=1e-4) | np.isclose(dz, 0.4, atol=1e-4)).any()  # box active
    np.testing.assert_allclose(got.dz.numpy(), np.asarray(want.dz), atol=1e-9)
    np.testing.assert_allclose(got.kkt_residual.numpy(), np.asarray(want.kkt_residual), atol=1e-9)
    np.testing.assert_allclose(got.complementarity.numpy(), np.asarray(want.complementarity),
                               rtol=1e-9, atol=1e-15)


def test_f64_nosdf_step_matches_oracle():
    """The port's f64 step with 40 IP iterations on the 32 cold scenarios
    against the independent oracle's nosdf_u0 within 2e-6, the JAX
    package's own anchor (tests/test_oracle_parity.py::test_f64_matches_oracle)."""
    from sdf_nmpc_tpu_torch.utils import accuracy

    rep = accuracy.check_accuracy(device="cpu", variant="nosdf",
                                  solver_over=dict(dtype="float64", qp_iters=40))
    assert rep["n_ok"] == 32 and rep["u0_max_err"] <= 2e-6, rep


def test_f32_plain_nosdf_step_meets_ci_gate_vs_oracle():
    """The port's f32 plain path on the CPU, BASELINE config 1's 32 cold
    scenarios against the independent oracle's nosdf_u0: the JAX package's
    CI gate (mean <= 2.5e-4, max <= 2.5e-3, tests/test_oracle_parity.py),
    every status OK."""
    from sdf_nmpc_tpu_torch.utils import accuracy

    rep = accuracy.check_accuracy(device="cpu", variant="nosdf")
    assert rep["n_scen"] == 32 and rep["n_ok"] == 32
    assert accuracy.ci_gate_ok(rep["u0_mean_err"], rep["u0_max_err"]), rep


def test_nmpc_without_a_network():
    """The Nmpc controller on config 1 (sdf=None), f64 on the CPU, N=6: the
    cold -> warm -> steady promotion, no failure, finite clipped commands;
    no diagnostics (eval returns [0])."""
    from sdf_nmpc_tpu_torch.controller import Nmpc
    from sdf_nmpc_tpu_torch.ref_gen import RefGen, Waypoint

    _, tc = family_configs("att", solver=dict(dtype="float64"), mpc=dict(N=6, T=0.45),
                           **NOSDF)
    nmpc, gen = Nmpc(tc, device="cpu"), RefGen(tc)
    x = np.zeros(10)
    x[3] = 1.0
    budgets = []
    for _ in range(6):
        nmpc.set_x0(x)
        gen.set_x0(x)
        nmpc.set_refs(gen.gen_ref_list_wps([Waypoint([2.0, 0.5, 0.3])]))
        budgets.append(nmpc.budget)
        assert nmpc.solve() == 0
        cmd = nmpc.get_cmd_TRPYr()
        assert np.isfinite(cmd).all()
        assert (cmd >= nmpc.cmd_TRPYr_min).all() and (cmd <= nmpc.cmd_TRPYr_max).all()
        x = nmpc.get_matrices()[0][1]
    assert budgets == ["cold", "warm", "warm", "warm", "steady", "steady"]
    assert nmpc.eval(1) == [0]
    assert np.abs(nmpc.get_u() - nmpc.ocp.u_hover).max() > 1e-3
