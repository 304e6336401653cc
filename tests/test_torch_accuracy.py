"""The port's f32 plain path on the main path's accuracy workload, against
the repo's goldens, with the JAX package's CI gate."""

from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def test_f32_plain_path_passes_ci_gate_on_goldens():
    """The port's f32 plain path on the 32 cold scenarios of
    accuracy_ref_u0.npz and the warm (ticks 1-3) / steady (ticks 4+) replays
    of warm_ref.npz: the JAX package's CI gate, mean <= 2.5e-4 and max <=
    2.5e-3 (tests/test_oracle_parity.py), every status OK."""
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    cold = acc.check_accuracy(device="cpu")
    assert cold["n_ok"] == cold["n_scen"] == 32
    assert acc.ci_gate_ok(cold["u0_mean_err"], cold["u0_max_err"]), cold
    warm = acc.check_warm_accuracy(device="cpu", budget="warm")
    steady = acc.check_warm_accuracy(device="cpu", budget="steady")
    assert warm["n_ok"] == warm["n_solves"] == 128
    assert steady["n_ok"] == steady["n_solves"] == 128
    g = acc.replay_gates(warm, steady)
    assert acc.ci_gate_ok(g["warm_mean"], g["warm_max"]), g
    assert acc.ci_gate_ok(g["steady_mean"], g["steady_max"]), g


def _jax_dual_ws_replay(budgets):
    """The JAX package's f32 step (CPU, its composed XLA path) on the dual
    warm-start replay of utils/accuracy.py, once per budget: tick 0 cold
    from the seeded duals, each later tick with the budget from the duals
    the last left.  Returns {budget: the (16, 8) u0 errors against
    warm_ref.npz}."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sdf_nmpc_tpu.solver import SolveInputs, SolverState, init_state, make_rti_step
    from sdf_nmpc_tpu.utils import accuracy as ja

    cap = np.load(ja.WARM_NPZ)
    cfg, ocp, layout = ja.build_setup(dict(dual_warm_start=True))
    f32, N = jnp.float32, ocp.N
    scen = ja.build_scenarios(cfg, ocp, layout)[:ja.WARM_SCEN]
    rows = lambda i: np.stack([s[i] for s in scen])
    yrs, Ws = rows(2), rows(3)
    fixed = dict(yref=jnp.asarray(np.tile(yrs[:, None], (1, N, 1)), f32),
                 W=jnp.asarray(np.tile(Ws[:, None], (1, N, 1)), f32),
                 yrefN=jnp.asarray(yrs[:, :ocp.nyN], f32), WN=jnp.asarray(Ws[:, :ocp.nyN], f32),
                 p=jnp.asarray(rows(1), f32))
    steps = {b: jax.jit(jax.vmap(make_rti_step(ocp, cfg, with_evals=False, budget=b)))
             for b in ("cold", *budgets)}
    seeded = jax.vmap(lambda x: init_state(ocp, x, f32, dual_warm_start=True))(
        jnp.asarray(cap["x0"][:, 0], f32)).qp_duals
    out = {}
    for budget in budgets:
        duals, errs = seeded, []
        for k in range(cap["x0"].shape[1]):
            st = SolverState(X=jnp.asarray(cap["X"][:, k], f32),
                             U=jnp.asarray(cap["U"][:, k], f32), qp_duals=duals)
            res = steps["cold" if k == 0 else budget](
                st, SolveInputs(x0=jnp.asarray(cap["x0"][:, k], f32), **fixed))
            duals = res.state.qp_duals
            assert (np.asarray(res.status) == 0).all()
            errs.append(np.abs(np.asarray(res.u0, np.float64) - cap["u0_ref"][:, k]).max(1))
        out[budget] = np.stack(errs, 1)
    return out


def test_f32_plain_path_dual_warm_start_on_goldens():
    """The same workload with solver.dual_warm_start, through the composed
    QP path (plain versions of kernels 5-8): the cold solve from the seeded
    duals, and the replays carrying each scenario's duals from tick to tick.
    The cold solve, the steady ticks and every warm tick but one meet the
    JAX package's CI gate.  That one, scenario 11's first warm tick, stays
    far from the f64 golden in the JAX package's own f32 step too; there
    the port is held to the largest f32 reading on it (SHORT_TICKS).
    Every status OK."""
    from sdf_nmpc_tpu_torch.utils import accuracy as acc

    over = {"dual_warm_start": True}
    cold = acc.check_accuracy(device="cpu", solver_over=over)
    warm = acc.check_warm_accuracy(device="cpu", budget="warm", solver_over=over)
    steady = acc.check_warm_accuracy(device="cpu", budget="steady", solver_over=over)
    short, limit = acc.short_tick("att", dual_warm_start=True)
    g = acc.replay_gates(warm, steady, exempt=short)
    jerr = _jax_dual_ws_replay(("warm", "steady"))
    jg = acc.replay_gates({"err": jerr["warm"]}, {"err": jerr["steady"]}, exempt=short)
    print(f"dual warm start, f32 on the CPU: port cold mean {cold['u0_mean_err']:.3e} max "
          f"{cold['u0_max_err']:.3e}; warm ticks but {short} port mean {g['warm_mean']:.3e} max "
          f"{g['warm_max']:.3e}, JAX mean {jg['warm_mean']:.3e} max {jg['warm_max']:.3e}; "
          f"tick {short} port {g['exempt_err']:.4e}, JAX {jg['exempt_err']:.4e}; steady ticks "
          f"port mean {g['steady_mean']:.3e} max {g['steady_max']:.3e}, JAX mean "
          f"{jg['steady_mean']:.3e} max {jg['steady_max']:.3e}")
    assert cold["n_ok"] == cold["n_scen"] == 32
    assert warm["n_ok"] == warm["n_solves"] == 128
    assert steady["n_ok"] == steady["n_solves"] == 128
    assert acc.ci_gate_ok(cold["u0_mean_err"], cold["u0_max_err"]), cold
    assert acc.ci_gate_ok(g["steady_mean"], g["steady_max"]), g
    assert acc.ci_gate_ok(g["warm_mean"], g["warm_max"]), g
    assert acc.ci_gate_ok(jg["warm_mean"], jg["warm_max"]), jg
    assert acc.CI_MAX < jg["exempt_err"] <= limit, jg  # the JAX shortfall
    assert g["exempt_err"] <= limit, g


def test_f32_floor_report_splits_the_error_by_stage(capsys):
    """utils/f32_floor.py on the CPU, rates' 8 cold scenarios at the
    unscaled x0: one line per row of its docstring; the f64 step at the
    oracle's ~1e-8, every f64 row with one stage in f32 below the CI gate's
    max, and the f32 step with either Gram within the CI gate."""
    from sdf_nmpc_tpu_torch.utils import accuracy as acc
    from sdf_nmpc_tpu_torch.utils import f32_floor

    f32_floor.report("rates", "cpu", jitters=(0.0,))
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        label, nums = line.split(": u0 mean ")
        rows[label] = [float(v) for v in nums.split(" max ")]
    f64 = [f"rates f64 step, {s} rounded to f32" for s in f32_floor.STAGES] + [
        "rates f64 step, QP data rounded to f32", "rates f64 step, QP solved in f32"]
    assert list(rows) == ["rates f32 step, x0 (1 +0)", "rates f32 step, f32 Gram, x0 (1 +0)",
                          "rates f64 step", *f64]
    assert rows["rates f64 step"][1] < 1e-7
    assert all(rows[k][1] < acc.CI_MAX for k in f64)
    assert all(acc.ci_gate_ok(*rows[k]) for k in list(rows)[:2])


def test_f32_floor_runs_on_the_card_unless_asked(monkeypatch):
    """The diagnostic's entry point defaults to the card, as every entry
    point of the port: with no CUDA device it raises before any work."""
    import pytest
    import torch

    from sdf_nmpc_tpu_torch.utils import f32_floor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        f32_floor.main(["--model", "rates"])
