"""The batched SQP-RTI step of ``sdf_nmpc_tpu_torch`` as the system under
test, with the inputs the harness makes for it and the comparison with the
plain reference (``portbench/reference/rti_step.py``) that decides
``correct``.

The program is reached through its public entry points only:
``config.default_config``, ``nn.NeuralDF``, ``ocp.build_ocp``,
``solver.make_rti_step`` / ``init_state`` / ``SolveInputs``.  The trained
network's weights are read from the raw file by the harness's own reader
and handed, the same arrays, to the program and to the reference.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from portbench.reference.msgpack_tree import msgpack_restore
from portbench.reference.rti_step import RtiReference

LAYERS = ("main1_0", "main1_1", "main2_0", "main2_1", "df")
VREF = (1.0, 0.0, 0.0)  # every robot flies forward at 1 m/s


def load_sdf(conf: dict, root: Path):
    """(flax parameter tree of numpy arrays, latents (n, L)) from the
    configuration's raw weight files."""
    s = conf["sdf"]
    tree = msgpack_restore((root / s["weights"]).read_bytes())
    lat = np.load(root / s["latents"]).astype(np.float64)
    if lat.shape[1] != s["size_latent"]:
        raise ValueError(f"latents of width {lat.shape[1]}, the configuration says "
                         f"{s['size_latent']}")
    return tree, lat


class Scenarios:
    """The scenarios of a run, from the seed, held compactly: starts at rest
    and level at 0.3 N(0, 1) around the origin, the trained latents in turn
    after a seeded permutation, the flag on, the camera at the start, the
    velocity reference ``VREF`` with the constrained weights.  Every number
    is a float32 value (held in float64), so both sides get the same."""

    def __init__(self, conf: dict, B: int, seed: int, latents: np.ndarray):
        o = conf["ocp"]
        self.conf, self.B = conf, B
        f32 = lambda a: np.asarray(a, np.float64).astype(np.float32).astype(np.float64)
        rng = np.random.default_rng(seed)
        x0 = np.zeros((B, o["nx"]))
        x0[:, :3] = 0.3 * rng.standard_normal((B, 3))
        x0[:, 3] = 1.0
        perm = rng.permutation(len(latents))
        self.x0 = f32(x0)
        self.lat_idx = perm[np.arange(B) % len(latents)]
        self.latents = f32(latents)
        w = o["weights_on"]
        # y = (p, q_e z, v, roll, pitch, yaw rate, vertical acceleration)
        self.yr = f32(np.concatenate([o["goal"], [0.0], VREF, [0.0, 0.0, 0.0, 0.0]]))
        self.W = f32(np.concatenate([w["pos"], [w["att"][2]], w["vel"], w["att"][:2],
                                     [w["rates"][2]], [w["acc"]]]))

    def rows(self, idx) -> dict:
        """The inputs of the scenarios ``idx``: numpy float64 arrays."""
        o, pi = self.conf["ocp"], self.conf["params"]
        N, nyN, n = o["N"], o["nyN"], len(idx)
        x0 = self.x0[idx]
        p = np.zeros((n, N + 1, pi["latent"] + self.latents.shape[1]))
        p[..., pi["flag"]] = 1.0
        p[..., pi["W_p_Co"]] = x0[:, None, :3]
        p[..., pi["W_R_Co"]] = np.eye(3).reshape(9)
        p[..., pi["q_d"][0]] = 1.0
        p[..., pi["latent"]:] = self.latents[self.lat_idx[idx]][:, None]
        tile = lambda a, *s: np.broadcast_to(a, s + a.shape).copy()
        return dict(x0=x0, yref=tile(self.yr, n, N), W=tile(self.W, n, N),
                    yrefN=tile(self.yr[:nyN], n), WN=tile(self.W[:nyN], n), p=p)

    def on_device(self, device, idx=None):
        """SolveInputs (float32) of the scenarios ``idx`` (a slice; all by
        default), built on ``device`` in a few large calls."""
        from sdf_nmpc_tpu_torch.solver import SolveInputs

        o, pi = self.conf["ocp"], self.conf["params"]
        idx = slice(None) if idx is None else idx
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                      device=device)
        x0 = t(self.x0[idx])
        n, N, nyN = x0.shape[0], o["N"], o["nyN"]
        lat = t(self.latents)[torch.as_tensor(self.lat_idx[idx], device=device)]
        p = torch.zeros(n, N + 1, pi["latent"] + lat.shape[1], dtype=torch.float32,
                        device=device)
        p[..., pi["flag"]] = 1.0
        i = pi["W_p_Co"][0]
        p[..., i:i + 3] = x0[:, None, :3]
        j = pi["W_R_Co"][0]
        p[..., j:j + 9] = torch.eye(3, device=device).reshape(9)
        p[..., pi["q_d"][0]] = 1.0
        p[..., pi["latent"]:] = lat[:, None]
        yr, W = t(self.yr), t(self.W)
        return SolveInputs(x0=x0, yref=yr.expand(n, N, -1).contiguous(),
                           W=W.expand(n, N, -1).contiguous(),
                           yrefN=yr[:nyN].expand(n, -1).contiguous(),
                           WN=W[:nyN].expand(n, -1).contiguous(), p=p)


def make_inputs(conf: dict, B: int, seed: int, latents: np.ndarray):
    """Every scenario's inputs as numpy float64 arrays (small batches)."""
    return Scenarios(conf, B, seed, latents).rows(np.arange(B))


def program_config(conf: dict, overrides: dict | None = None):
    """The program's config for the configuration file, checked field by
    field against it."""
    from sdf_nmpc_tpu_torch.config import default_config

    s, o = conf["sdf"], conf["ocp"]
    solver = dict(conf["solver"])
    solver.update(overrides or {})
    cfg = default_config().replace(nn=dict(size_latent=s["size_latent"]), solver=solver,
                                   flags=conf["flags"], mpc=dict(uniform_dt=o["uniform_dt"]))
    lim = cfg.robot.limits
    checks = {
        "model": (cfg.mpc.model, o["model"]), "N": (cfg.mpc.N, o["N"]), "T": (cfg.mpc.T, o["T"]),
        "fov_ratio": (cfg.mpc.fov_ratio, o["fov_ratio"]),
        "fov_const_offset": (cfg.mpc.fov_const_offset, o["fov_const_offset"]),
        "bound_margin": (cfg.mpc.bound_margin, o["bound_margin"]),
        "lm_reg": (cfg.mpc.lm_reg, o["lm_reg"]),
        "slack_fov": (list(cfg.mpc.weights.slack_fov), o["slack_fov"]),
        "slack_df": (list(cfg.mpc.weights.slack_df), o["slack_df"]),
        "hfov": (cfg.sensor.hfov, conf["sensor"]["hfov"]),
        "vfov": (cfg.sensor.vfov, conf["sensor"]["vfov"]),
        "size_xy": (cfg.robot.size.xy, conf["robot"]["size_xy"]),
        "sensor_position": (list(cfg.robot.sensor_extrinsics.position),
                            conf["robot"]["sensor_position"]),
        "limits": ([lim.gamma, lim.roll, lim.pitch, lim.wz],
                   [conf["robot"]["limits"][k] for k in ("gamma", "roll", "pitch", "wz")]),
        "uniform_dt": (cfg.mpc.uniform_dt, o["uniform_dt"]),
        **{f"flags.{k}": (cfg.flags[k], v) for k, v in conf["flags"].items()},
    }
    bad = {k: v for k, v in checks.items()
           if (v[0] != v[1] if isinstance(v[0], str)
               else not np.allclose(np.asarray(v[0], float), np.asarray(v[1], float)))}
    if bad:
        raise ValueError(f"the program's config departs from the configuration file: {bad}")
    return cfg


class Program:
    """The program's steps on ``device`` for the configuration ``conf``."""

    def __init__(self, conf: dict, params: dict, device, overrides: dict | None = None):
        from sdf_nmpc_tpu_torch.nn import NeuralDF
        from sdf_nmpc_tpu_torch.ocp import build_ocp
        from sdf_nmpc_tpu_torch.solver import make_rti_step

        s, o = conf["sdf"], conf["ocp"]
        self.device = torch.device(device)
        self.cfg = program_config(conf, overrides)
        net = NeuralDF(size_latent=s["size_latent"], layer_sizes=tuple(s["layer_sizes"]),
                       embed=s["embed"], act=s["act"], w0=s["w0"], nb_freqs=s["nb_freqs"],
                       res=s["res"])
        p = params["params"] if "params" in params else params
        state = {}
        for k in LAYERS:
            state[f"{k}.weight"] = torch.from_numpy(np.array(p[k]["kernel"].T))
            state[f"{k}.bias"] = torch.from_numpy(np.array(p[k]["bias"]))
        net.load_state_dict(state)
        self.ocp = build_ocp(self.cfg, sdf=net.to(self.device), sdf_max_df=o["sdf_max_df"],
                             device=self.device)
        got = dict(nx=self.ocp.nx, nu=self.ocp.nu, ny=self.ocp.ny, nyN=self.ocp.nyN,
                   nh=self.ocp.nh, nhN=self.ocp.nhN, nz=self.ocp.N * self.ocp.nu,
                   nc=self.ocp.N * self.ocp.nh + self.ocp.nhN)
        if any(got[k] != o[k] for k in got):
            raise ValueError(f"the program's OCP has {got}, the configuration {o}")
        self.cold = make_rti_step(self.ocp, self.cfg, budget="cold", with_evals=False)
        self.steady = make_rti_step(self.ocp, self.cfg, budget="steady", with_evals=False)

    def init_state(self, inputs):
        from sdf_nmpc_tpu_torch.solver import init_state

        return init_state(self.ocp, inputs.x0)


def gaps(X, U, ok, X_ref, U_ref, ok_ref) -> dict:
    """Per-scenario gaps of a program step's outputs from the reference's:
    u0 (the command sent), the whole next trajectory (X and U)."""
    X, U = X.double().cpu(), U.double().cpu()
    X_ref, U_ref = X_ref.cpu(), U_ref.cpu()
    u0 = (U[:, 0] - U_ref[:, 0]).abs().amax(-1)
    traj = torch.maximum((X - X_ref).abs().flatten(1).amax(-1),
                         (U - U_ref).abs().flatten(1).amax(-1))
    bad = (~ok.cpu()) | (~ok_ref.cpu())
    return dict(u0=u0, traj=traj, bad=bad)


class Reference:
    """The plain reference of the configuration on ``device`` in float64,
    run on sampled scenarios in blocks of ``block`` rows."""

    def __init__(self, conf: dict, params: dict, device, block: int = 1024):
        self.ref = RtiReference(conf, params, device)
        self.block = block

    def step(self, X, U, inp: dict, budget: str):
        """(X_new, U_new, ok) of the scenarios whose inputs are ``inp``, from
        (X, U) of those rows (None: the cold start from the inputs)."""
        outs = []
        for i in range(0, len(inp["x0"]), self.block):
            r_inp = {k: torch.as_tensor(v[i:i + self.block]) for k, v in inp.items()}
            if X is None:
                Xb, Ub = self.ref.init_state(r_inp["x0"])
            else:
                Xb, Ub = X[i:i + self.block], U[i:i + self.block]
            outs.append(self.ref.step(Xb, Ub, r_inp, budget))
        return tuple(torch.cat([o[k].cpu() for o in outs]) for k in range(3))


class Cell:
    """One cell of an RTI configuration under a traffic mix: the program's
    steady step over ``traffic['scenarios']`` scenarios, driven as a chain
    (``loop: chain``) or tick by tick with u0 read back (``loop: tick``).

    ``wrap``: a function that takes the program's step and returns the step
    the window drives (the harness's tests plant faults with it)."""

    def __init__(self, conf, traffic, seed, device, root, overrides=None, wrap=None,
                 cache=None):
        self.conf, self.traffic, self.seed = conf, traffic, int(seed)
        self.device, self.root = torch.device(device), Path(root)
        self.B = int(traffic["scenarios"])
        self.overrides, self.wrap = overrides, wrap
        self.cache = {} if cache is None else cache

    # -- set-up --
    def setup(self):
        # host clock at each stage of set-up, logged by the harness
        self.marks = getattr(self, "marks", None) or {"entered": time.perf_counter()}
        if "sdf" not in self.cache:
            self.cache["sdf"] = load_sdf(self.conf, self.root)
        self.params, lat = self.cache["sdf"]
        self.scen = Scenarios(self.conf, self.B, self.seed, lat)
        key = ("program", json.dumps(self.overrides, sort_keys=True))
        if key not in self.cache:
            self.cache[key] = Program(self.conf, self.params, self.device, self.overrides)
        self.prog = self.cache[key]
        self.marks["program"] = time.perf_counter()
        self.build()
        self.x = self.inputs_on_device()
        self.cold_inputs()
        rng = np.random.default_rng([self.seed, 1])
        n = min(int(self.traffic["check_rows"]), self.B)
        self.idx = np.sort(rng.choice(self.B, n, replace=False))
        self.res = self.cold_step(self.prog.init_state(self.x), self.x)
        self.cold_out = self.sample(self.res)
        self.marks["cold"] = time.perf_counter()
        self.n_bad = torch.zeros((), dtype=torch.int64, device=self.device)
        warm = (lambda: self.tick(None)) if self.traffic["loop"] == "tick" else self.unit
        for _ in range(int(self.traffic["warm_units"])):
            warm()
        self.marks["warm"] = time.perf_counter()

    def wraps(self, target: str) -> bool:
        """Whether the planted fault (``wrap``) breaks ``target``."""
        return self.wrap is not None and getattr(self.wrap, "target", "step") == target

    def build(self):
        """The step the window drives."""
        self.steady = self.wrap(self.prog.steady) if self.wraps("step") else self.prog.steady

    def inputs_on_device(self):
        return self.scen.on_device(self.device)

    def cold_step(self, state, x):
        return self.prog.cold(state, x)

    def sample(self, res):
        """(X, U, ok) of the sampled scenarios of a result, on the host."""
        rows = torch.as_tensor(self.idx, device=self.device)
        return (res.state.X[rows].cpu(), res.state.U[rows].cpu(), (res.status[rows] == 0).cpu())

    def cold_inputs(self):
        """Inputs the cold step needs beyond the scenarios' (none here)."""

    def start_window(self):
        self.n_bad.zero_()

    # -- the window's units --
    def unit(self) -> float:
        """One step of every scenario and the plant's move; returns the host
        seconds the step call took to return."""
        t0 = time.perf_counter()
        self.res = self.steady(self.res.state, self.x)
        issued = time.perf_counter() - t0
        self.n_bad += (self.res.status != 0).sum()
        self.advance()
        return issued

    def advance(self):
        """The closed loop's plant: every robot moves to the state its step
        predicts for the next node, and its camera frame to where it is."""
        x1 = self.res.state.X[:, 1]
        self.x.x0.copy_(x1)
        i = self.conf["params"]["W_p_Co"][0]
        self.x.p[:, :, i:i + 3] = x1[:, None, :3]

    def tick(self, window):
        issued = self.unit()
        self.u0_host = self.res.u0.to("cpu")
        if window is not None:
            window.issue_s.append(issued)

    def spans(self) -> dict:
        """Timings the cell took in the window, by name (none here)."""
        return {}

    # -- hooks of a cell over several ranks (one rank here) --
    is_root = True

    def fixed_units(self, seconds):
        """A fixed count of units for the window, or None: run by the clock."""
        return None

    def reduce_window(self, wall_s, peak):
        """(the slowest rank's window, the fullest card's peak)."""
        return wall_s, peak

    def reduce_busy(self, busy_s):
        """The device's busy seconds, averaged over the cards."""
        return busy_s

    def finish(self):
        """Stop whatever the cell started, and wait for it."""

    def abort(self):
        """Stop whatever the cell started, after a failure."""

    def failed(self) -> int:
        return int(self.n_bad)

    # -- the comparison with the reference --
    def check_step(self):
        """One more steady step through the window's call, at the full batch;
        keeps the sampled rows' input state and output, then frees the
        program's state."""
        rows = torch.as_tensor(self.idx, device=self.device)
        X_in, U_in = self.res.state.X[rows].cpu(), self.res.state.U[rows].cpu()
        self.last_inp = {k: getattr(self.x, k)[rows].double().cpu().numpy()
                         for k in self.x._fields}
        res = self.steady(self.res.state, self.x)
        self.last = (X_in, U_in, res.state.X[rows].cpu(), res.state.U[rows].cpu(),
                     (res.status[rows] == 0).cpu())
        del res
        self.res = self.x = None

    def cold_rows(self) -> dict:
        """The sampled scenarios' inputs to the cold step."""
        return self.scen.rows(self.idx)

    def numbers(self, ref_device) -> dict:
        """The numbers the limits hold: per-scenario gaps from the f64
        reference of the cold step (set-up) and of the last step."""
        ref = Reference(self.conf, self.params, ref_device)
        Xc, Uc, okc = ref.step(None, None, self.cold_rows(), "cold")
        cold = gaps(*self.cold_out[:2], self.cold_out[2], Xc, Uc, okc)
        X_in, U_in, X_out, U_out, ok = self.last
        Xs, Us, oks = ref.step(X_in, U_in, self.last_inp, "steady")
        last = gaps(X_out, U_out, ok, Xs, Us, oks)
        self.last_ref, self.last_gaps = (Xs, Us, oks), last  # for readings.py --dump
        q = lambda t, p: float(torch.quantile(t, p))
        return {
            "cold_u0_med": q(cold["u0"], 0.5), "cold_u0_max": float(cold["u0"].max()),
            "u0_med": q(last["u0"], 0.5), "u0_p90": q(last["u0"], 0.9),
            "u0_max": float(last["u0"].max()),
            "traj_med": q(last["traj"], 0.5), "traj_p90": q(last["traj"], 0.9),
            "traj_max": float(last["traj"].max()),
            "not_ok": int(cold["bad"].sum() + last["bad"].sum()) + self.failed(),
        }
