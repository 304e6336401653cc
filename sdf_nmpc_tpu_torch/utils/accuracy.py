"""The u0 accuracy workloads, against the repo's goldens.

Own copy of sdf_nmpc_tpu/utils/accuracy.py ``build_scenarios`` (:73) and of
the cold (:356) and warm/steady replay checks (:457): 32 hard random cold
starts for the default att + neural-SDF OCP with the trained 4x256 NeuralDF,
held against ``tests/golden/accuracy_ref_u0.npz`` (a CPU f64/40-iteration
solve), and 16 scenarios x 8 captured warm ticks replayed from
``tests/golden/warm_ref.npz``.  The same 32 cold starts of BASELINE config 1
(``variant='nosdf'``: enable_sdf off, no network) are held against the
independent oracle's ``nosdf_u0`` in ``tests/golden/oracle_u0.npz``.  The
other five quad families (``model=``) run the same OCP: their first 8 cold
scenarios are held against the
independent oracle's ``tests/golden/oracle_u0.npz`` (``cold_reference``)
and their replays read ``warm_ref_<model>.npz`` (``warm_npz_path``).  The
goldens are read with numpy only.

``variant='recfeas'`` turns on recursive feasibility and stability (the
synthetic braking-distance polynomial ``synthetic_bdist_coeffs``, r_tilde
1.0, as the JAX workload builds it, :115-176): its first 8 cold scenarios
are held against the oracle's ``recfeas_u0``.  ``variant='sdf_cost'`` adds
the SDF stage cost row to config 4; no golden holds it (chip_smoke.py holds
it against the port's f64 CPU step).

``solver_over`` (cfg.solver overrides, e.g. ``{"qp_backend": "riccati"}``)
runs the same checks under another solver configuration, and ``N`` another
horizon (T grown with N, so the interval stays 0.075 s, as the JAX
workload's ``N`` override).  With ``dual_warm_start`` the cold solve starts from
the seeded duals of ``init_state``, and the replay carries the QP duals of
each scenario from one captured tick to the next, as a controller does
(each tick replayed from its captured X, U and x0; tick 0, the cold tick,
with the cold budget, so that tick 1 starts from the duals a controller
would hand it).

BASELINE config 3 (``solve_config3_batch``, ``check_config3_accuracy``;
JAX :223-355) puts the trained VAE encoder inside the contract: 8 blocking
scenes rendered by sphere tracing at the sensor's 270 x 480, encoded, the
latent written into the parameters, one cold step, held against the CPU
f64 render -> encode -> solve oracle ``tests/golden/config3_u0.npz``
(max <= 1e-3, every status OK).  The JAX package vmaps one jitted program
over the scenes; the port batches them along the scenario axis.

Gates: the JAX package's CI gate (mean <= 2.5e-4, max <= 2.5e-3,
tests/test_oracle_parity.py:82-83) and the strict contract (max <= 1e-3 on
cold, warm ticks 1..steady_after and steady ticks after them, bench.py:126).
A few warm ticks that the JAX package's own f32 step leaves beyond the CI
gate are named in SHORT_TICKS, each with its own limit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "golden"
REF_NPZ = GOLDEN / "accuracy_ref_u0.npz"
ORACLE_NPZ = GOLDEN / "oracle_u0.npz"
WARM_NPZ = GOLDEN / "warm_ref.npz"
CONFIG3_NPZ = GOLDEN / "config3_u0.npz"
CONFIG3_SCEN = 8
N_SCEN = 32
FAMILY_SCEN = 8  # cold scenarios per family in oracle_u0.npz
WARM_SCEN = 16
LATENT = 128
LAYERS = (256, 256, 256, 256)
CI_MEAN, CI_MAX = 2.5e-4, 2.5e-3
CONTRACT_MAX = 1e-3
# oracle_u0.npz key of each family's cold scenarios
ORACLE_KEYS = {"acc": "acc", "att_tau": "tau", "rates": "rates", "wrench": "wrench",
               "props": "props"}
# The warm replay ticks that the JAX package's own f32 step leaves beyond the
# CI gate: (model, dual_warm_start, scenario, tick) -> the limit the tick is
# held to, the largest f32 reading on it (JAX on the CPU, the port's plain
# path on the CPU, the port on the H100) rounded up in the third digit.
# Every other warm tick is held to the CI gate.  ROADMAP.md §3 records each.
#   att with dual_warm_start, scenario 11, tick 1: JAX 1.3921e-2, plain
#     1.3961e-2, H100 1.3941e-2.
#   props, scenario 14, tick 1 (warm budget): JAX 4.5954e-3, plain
#     5.9527e-4, H100 5.5827e-4.
SHORT_TICKS = {("att", True, 11, 1): 1.4e-2, ("props", False, 14, 1): 4.6e-3}


def build_scenarios(cfg, ocp, layout, latents=None):
    """(x0, p, yref_row, W_row) per scenario: hard random cold starts.
    ``latents`` (N_SCEN, LATENT) replaces the seeded draw (the trained
    checkpoint's encoded scenes); the rng stream is the same either way."""
    from ..ref_gen import Ref

    rng = np.random.default_rng(0)
    N = ocp.N
    out = []
    for i in range(N_SCEN):
        x0 = np.zeros(ocp.nx)
        x0[3] = 1.0
        x0[:3] = rng.normal(size=3) * 0.5
        x0[7:10] = rng.normal(size=3) * 0.5
        if ocp.nx > 10:  # body rates, drawn after the shared fields
            x0[10:] = rng.normal(size=ocp.nx - 10) * 0.2
        p = np.zeros((N + 1, layout.np_total))
        layout.set_flag(p, 1.0)
        layout.set_camera(p, np.zeros(3), np.eye(3))
        layout.set_q_d(p, [1, 0, 0, 0])
        lat_i = rng.normal(size=LATENT) * 0.2  # keep the stream position
        layout.set_latent(p, latents[i] if latents is not None else lat_i)
        ref = Ref(cfg).use_constrained_weights(False)
        ref.p = rng.normal(size=3) * 1.5
        yr, W = ocp.pack_ref(ref)
        out.append((x0, p, yr, W))
    return out


def synthetic_bdist_coeffs(cfg):
    """The deterministic braking-distance polynomial of the recursive-
    feasibility goldens: ~0.3 m and small velocity-dependent terms."""
    from ..math import polynomial_3variate_exponents

    n = polynomial_3variate_exponents(cfg.mpc.braking_dist.degree).shape[0]
    coeffs = np.random.default_rng(1).normal(size=n) * 0.01
    coeffs[0] += 0.3
    return coeffs


def family_config(cfg, model=None):
    """cfg with cfg.mpc.model set.  wrench runs with a torque limit of 2.0,
    as in the JAX accuracy workload: the shipped 0 zeroes its torque inputs
    and leaves nothing but LM regularization to check."""
    if model is None:
        return cfg
    cfg = cfg.replace(mpc=dict(model=model))
    if model == "wrench" and float(cfg.robot.limits.torques) == 0.0:
        cfg = cfg.replace(robot=dict(limits=dict(torques=2.0)))
    return cfg


def build_setup(device="cuda", solver_over=None, model=None, variant="sdf", N=None):
    """(cfg, ocp, layout, latents) of the workload: the trained production
    NeuralDF and its encoded-scene latents from ``weights/``; ``model``: a
    quad family other than the default att.  ``variant``: 'sdf' (BASELINE
    config 4), 'nosdf' (config 1: enable_sdf off, no network, latents
    None: the scenarios keep the seeded draw, which no row reads),
    'recfeas' (config 4 with recursive feasibility and stability) or
    'sdf_cost' (config 4 with the SDF stage cost row).  ``N``: the horizon
    (None: the reference 20), T scaled with it."""
    from ..config import default_config
    from ..nn.weights import load_prod_latents, load_prod_sdf
    from ..ocp import build_ocp
    from ..params import ParamLayout

    cfg = family_config(default_config().replace(nn=dict(size_latent=LATENT)), model)
    if N is not None:
        cfg = cfg.replace(mpc=dict(N=int(N), T=float(cfg.mpc.T) * N / cfg.mpc.N))
    if solver_over:
        cfg = cfg.replace(solver=solver_over)
    if variant == "nosdf":
        cfg = cfg.replace(flags=dict(enable_sdf=False))
        return cfg, build_ocp(cfg, device=device), ParamLayout.from_cfg(cfg), None
    kw = {}
    if variant == "recfeas":
        cfg = cfg.replace(flags=dict(recursive_feasibility=True, stability=True))
        kw = dict(bdist_coeffs=synthetic_bdist_coeffs(cfg), r_tilde=1.0)
    elif variant == "sdf_cost":
        cfg = cfg.replace(flags=dict(sdf_cost=True))
    elif variant != "sdf":
        raise ValueError(f"unknown variant {variant!r}")
    sdf = load_prod_sdf(require_latent=LATENT, require_layers=LAYERS, device=device)
    lat = load_prod_latents()
    if sdf is None or lat is None or lat.shape[0] < N_SCEN:
        raise RuntimeError("the accuracy goldens need the trained NeuralDF in weights/")
    ocp = build_ocp(cfg, sdf=sdf, sdf_max_df=1.0, device=device, **kw)
    return cfg, ocp, ParamLayout.from_cfg(cfg), np.asarray(lat[:N_SCEN], np.float64)


def scenario_inputs(ocp, scen, dtype, device, reps=1):
    """SolveInputs of build_scenarios' scenarios, each repeated ``reps`` times."""
    from ..solver import SolveInputs

    N = ocp.N
    T = lambda a: torch.as_tensor(np.repeat(a, reps, axis=0), dtype=dtype, device=device)
    yrs = np.stack([s[2] for s in scen])
    Ws = np.stack([s[3] for s in scen])
    return SolveInputs(
        x0=T(np.stack([s[0] for s in scen])),
        yref=T(np.tile(yrs[:, None], (1, N, 1))),
        W=T(np.tile(Ws[:, None], (1, N, 1))),
        yrefN=T(yrs[:, : ocp.nyN]),
        WN=T(Ws[:, : ocp.nyN]),
        p=T(np.stack([s[1] for s in scen])),
    )


def _dual_ws(cfg) -> bool:
    return bool(cfg.solver.get("dual_warm_start", False))


def cold_reference(model=None, variant="sdf"):
    """(u0 golden, scenario count) of a family's cold check: att's 32 of
    accuracy_ref_u0.npz, another family's first FAMILY_SCEN against the
    independent oracle's u0 in oracle_u0.npz; BASELINE config 1 ('nosdf',
    att) the oracle's 32 nosdf_u0, 'recfeas' (att) its 8 recfeas_u0."""
    if variant in ("nosdf", "recfeas"):
        if model not in (None, "att"):
            raise ValueError(f"the oracle's {variant} goldens are att's")
        u0 = np.load(ORACLE_NPZ)[f"{variant}_u0"]
        return u0, len(u0)
    if variant != "sdf":
        raise ValueError(f"no golden holds variant {variant!r}")
    if model in (None, "att"):
        return np.load(REF_NPZ)["u0"], N_SCEN
    return np.load(ORACLE_NPZ)[f"{ORACLE_KEYS[model]}_u0"], FAMILY_SCEN


def solve_batch(device="cuda", solver_over=None, variant="sdf", n=None, model=None, N=None):
    """One cold step on the first n (all N_SCEN) scenarios of the workload at
    horizon N (JAX :183-211): (u0 (n, nu), status (n,)) in numpy."""
    from ..solver import init_state, make_rti_step

    cfg, ocp, layout, lat = build_setup(device, solver_over, model, variant, N)
    dtype = torch.float64 if str(cfg.solver.dtype) == "float64" else torch.float32
    inputs = scenario_inputs(ocp, build_scenarios(cfg, ocp, layout, lat)[:n or N_SCEN], dtype,
                             ocp.device)
    state = init_state(ocp, inputs.x0, dtype, dual_warm_start=_dual_ws(cfg))
    res = make_rti_step(ocp, cfg, with_evals=False)(state, inputs)
    return res.u0.double().cpu().numpy(), res.status.cpu().numpy()


def check_accuracy(device="cuda", solver_over=None, model=None, variant="sdf"):
    """Cold-start u0 error against the family's golden (cold_reference);
    ``variant`` 'nosdf' (BASELINE config 1) and 'recfeas' against the
    oracle's nosdf_u0 and recfeas_u0, as the JAX package's
    utils/accuracy.py:118-176 and tests/test_oracle_parity.py hold them."""
    ref, n = cold_reference(model, variant)
    u0, status = solve_batch(device, solver_over, variant, n, model)
    err = np.abs(u0 - ref).max(axis=1)
    return {"u0_max_err": float(err.max()), "u0_mean_err": float(err.mean()),
            "n_ok": int((status == 0).sum()), "n_scen": n}


def _config3_scenes(n: int = CONFIG3_SCEN, device="cuda"):
    """n deterministic blocking scenes (two spheres each: one blocks the
    corridor toward the goal, one is clutter), stacked along a scene axis;
    float32, as the JAX package builds them."""
    from ..sim import Scene

    rng = np.random.default_rng(7)
    scenes = []
    for _ in range(n):
        c1 = [1.6 + rng.uniform(0.0, 1.2), rng.uniform(-0.35, 0.35), rng.uniform(-0.25, 0.25)]
        r1 = rng.uniform(0.3, 0.5)
        c2 = [rng.uniform(2.2, 3.4), rng.uniform(-1.2, 1.2), rng.uniform(-0.5, 0.5)]
        r2 = rng.uniform(0.25, 0.45)
        scenes.append(Scene.make(spheres=[(c1, r1), (c2, r2)], device=device))
    return Scene.stack(scenes)


def config3_images(cfg, dtype, device, n=CONFIG3_SCEN):
    """(n, H, W) range images of the config-3 scenes, rendered in ``dtype``
    from the camera at the origin looking along +x."""
    from ..sim import render_range_image

    H, W = (int(v) for v in cfg.sensor.shape_imgs[-2:])
    scenes = _config3_scenes(CONFIG3_SCEN, device).to(dtype)
    scenes = type(scenes)(*[a[:n] for a in scenes])
    return render_range_image(scenes, torch.zeros(3, dtype=dtype, device=device),
                              torch.eye(3, dtype=dtype, device=device), H, W,
                              float(cfg.sensor.hfov), float(cfg.sensor.vfov),
                              float(cfg.sensor.dmax))


def config3_encoder(cfg, dtype, device):
    """The trained encoder at the sensor's resolution (strict gate), in
    ``dtype`` on ``device``; RuntimeError if weights/ lacks it."""
    from ..nn.weights import load_prod_encoder

    H, W = (int(v) for v in cfg.sensor.shape_imgs[-2:])
    loaded = load_prod_encoder(expect_img=(H, W), strict=True, device=device)
    if loaded is None:
        raise RuntimeError("the config-3 contract needs the trained encoder in weights/ at the "
                           "configured sensor resolution")
    return loaded[0].to(dtype)


def config3_inputs(cfg, ocp, layout, n, dtype, device):
    """(SolveInputs, initial state) of the config-3 scenarios: starts near
    the camera pose, the goal 3.5 m ahead past the blocking sphere, the
    flag on, the camera at the origin; the latent columns still zero."""
    from ..ref_gen import Ref
    from ..solver import SolveInputs, init_state

    rng = np.random.default_rng(3)
    N = ocp.N
    x0s, ps, yrs, Ws = [], [], [], []
    for _ in range(n):
        x0 = np.zeros(ocp.nx)
        x0[3] = 1.0
        x0[:3] = rng.normal(size=3) * 0.2
        x0[7:10] = rng.normal(size=3) * 0.3
        if ocp.nx > 10:
            x0[10:] = rng.normal(size=ocp.nx - 10) * 0.1
        p = np.zeros((N + 1, layout.np_total))
        layout.set_flag(p, 1.0)
        layout.set_camera(p, np.zeros(3), np.eye(3))
        layout.set_q_d(p, [1, 0, 0, 0])
        ref = Ref(cfg).use_constrained_weights(True)
        ref.p = np.array([3.5, 0.0, 0.0])
        yr, Wrow = ocp.pack_ref(ref)
        x0s.append(x0)
        ps.append(p)
        yrs.append(yr)
        Ws.append(Wrow)
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    yrs, Ws = np.stack(yrs), np.stack(Ws)
    inputs = SolveInputs(x0=T(np.stack(x0s)), yref=T(np.tile(yrs[:, None], (1, N, 1))),
                         W=T(np.tile(Ws[:, None], (1, N, 1))), yrefN=T(yrs[:, : ocp.nyN]),
                         WN=T(Ws[:, : ocp.nyN]), p=T(np.stack(ps)))
    return inputs, init_state(ocp, inputs.x0, dtype, dual_warm_start=_dual_ws(cfg))


def solve_config3_batch(dtype_cfg=None, n: int = None, device="cuda"):
    """BASELINE config 3: render the scenes -> encode them with the trained
    encoder -> write each latent into its scenario's parameters -> one cold
    step, batched over the scenarios.  Returns (u0, status) in numpy.
    ``dtype_cfg``: cfg.solver overrides (``dtype`` float64 renders and
    encodes in f64 too)."""
    from ..solver import make_rti_step

    cfg, ocp, layout, _ = build_setup(device, dtype_cfg)
    dtype = torch.float64 if str(cfg.solver.dtype) == "float64" else torch.float32
    n = n or CONFIG3_SCEN
    dev = ocp.device
    enc = config3_encoder(cfg, dtype, dev)
    inputs, state = config3_inputs(cfg, ocp, layout, n, dtype, dev)
    with torch.no_grad():
        latent = enc(config3_images(cfg, dtype, dev, n)[:, None])
    p = inputs.p.clone()
    p[:, :, layout.latent_start:] = latent[:, None, :]
    res = make_rti_step(ocp, cfg, with_evals=False)(state, inputs._replace(p=p))
    return res.u0.double().cpu().numpy(), res.status.cpu().numpy()


def check_config3_accuracy(device="cuda"):
    """The f32 render -> encode -> solve pipeline against the f64 oracle."""
    ref = np.load(CONFIG3_NPZ)["u0"]
    u0, status = solve_config3_batch(device=device)
    err = np.abs(u0 - ref).max(axis=1)
    return {"u0_max_err": float(err.max()), "u0_mean_err": float(err.mean()),
            "n_ok": int((status == 0).sum()), "n_scen": int(u0.shape[0])}


def warm_npz_path(model=None) -> Path:
    """The captured warm states of a family: warm_ref.npz for att,
    warm_ref_<model>.npz for the others."""
    return WARM_NPZ if model in (None, "att") else GOLDEN / f"warm_ref_{model}.npz"


def short_tick(model=None, dual_warm_start=False):
    """((scenario, tick), limit) of the family's named warm tick in
    SHORT_TICKS with or without dual_warm_start, else (None, None)."""
    for (m, dws, scen, tick), limit in SHORT_TICKS.items():
        if (m, dws) == (model or "att", bool(dual_warm_start)):
            return (scen, tick), limit
    return None, None


def check_warm_accuracy(device="cuda", budget="warm", solver_over=None, model=None):
    """Replay every captured tick of the family's warm states with one
    budget; the errors exclude tick 0, the cold tick."""
    from ..solver import SolverState, init_state, make_rti_step

    cap = np.load(warm_npz_path(model))
    cfg, ocp, layout, lat = build_setup(device, solver_over, model)
    dtype = torch.float64 if str(cfg.solver.dtype) == "float64" else torch.float32
    step = make_rti_step(ocp, cfg, budget=budget, with_evals=False)
    scen = build_scenarios(cfg, ocp, layout, lat)[:WARM_SCEN]
    S, T = cap["x0"].shape[:2]
    dev = ocp.device
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    if _dual_ws(cfg):
        # tick by tick: each scenario's duals go on to its next tick
        inputs = scenario_inputs(ocp, scen, dtype, dev)
        duals = init_state(ocp, inputs.x0, dtype, dual_warm_start=True).qp_duals
        cold = make_rti_step(ocp, cfg, budget="cold", with_evals=False)
        u0, status = [], []
        for k in range(T):
            res = (cold if k == 0 else step)(SolverState(X=t(cap["X"][:, k]), U=t(cap["U"][:, k]), qp_duals=duals),
                       inputs._replace(x0=t(cap["x0"][:, k])))
            duals = res.state.qp_duals
            u0.append(res.u0)
            status.append(res.status)
        u0, status = torch.stack(u0, 1).flatten(0, 1), torch.stack(status, 1).flatten()
    else:  # every tick at once
        flat = lambda a: a.reshape((S * T,) + a.shape[2:])
        inputs = scenario_inputs(ocp, scen, dtype, dev, reps=T)._replace(x0=t(flat(cap["x0"])))
        res = step(SolverState(X=t(flat(cap["X"])), U=t(flat(cap["U"]))), inputs)
        u0, status = res.u0, res.status
    u0 = u0.double().cpu().numpy()
    err = np.abs(u0 - cap["u0_ref"].reshape(S * T, -1)).max(axis=1).reshape(S, T)
    warm = err[:, 1:]
    return {
        "u0_max_err": float(warm.max()), "u0_mean_err": float(warm.mean()),
        "n_ok": int((status.cpu().numpy() == 0).sum()),
        "n_ticks": int(warm.size), "n_solves": int(S * T), "err": err,
    }


def replay_gates(warm: dict, steady: dict, steady_after: int = 3, exempt=None) -> dict:
    """Warm-budget errors on ticks 1..steady_after and steady-budget errors on
    the ticks after them, as the controller's schedule serves them.
    ``exempt``: one warm (scenario, tick) left out of the warm readings and
    reported on its own as ``exempt_err``."""
    we = warm["err"][:, 1:steady_after + 1]
    se = steady["err"][:, steady_after + 1:]
    keep = np.ones(we.shape, bool)
    out = {}
    if exempt is not None:
        s, t = exempt
        keep[s, t - 1] = False
        out["exempt_err"] = float(we[s, t - 1])
    return {"warm_max": float(we[keep].max()), "warm_mean": float(we[keep].mean()),
            "steady_max": float(se.max()), "steady_mean": float(se.mean()), **out}


def ci_gate_ok(mean_err: float, max_err: float) -> bool:
    return mean_err <= CI_MEAN and max_err <= CI_MAX
