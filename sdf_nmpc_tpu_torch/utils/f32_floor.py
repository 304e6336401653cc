"""Where a family's f32 u0 error against the oracle comes from.

    python -m sdf_nmpc_tpu_torch.utils.f32_floor [--model props] [--device cuda]

On the family's cold scenarios (``accuracy.cold_reference``) it prints
the mean and max u0 error of

1. the f32 step as it runs, and with the Gram products H, g formed in f32
   (the JAX package's way; ``solver/sqp.py::gram`` accumulates them in f64),
   each at x0 and at x0 scaled by 1 + 1e-6, 1 - 1e-6 and 1 + 2e-6: the
   spread over these equivalent inputs is the noise of the f32 pipeline;
2. the f64 step, and the f64 step with one stage's outputs rounded to f32
   (linearization, SDF row, condensing, the QP data) or with the QP solved
   in f32: which stage carries the error.

The f32 steps run on ``--device``: the card by default (the kernels), the
CPU when asked (their plain versions).  The f64 rows run on the CPU, the
only f64 path.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..ops import condense_kernel, lin_kernels, sdf_fused
from ..solver import init_state, make_rti_step, sqp
from ..solver.qp import QpData, QpDuals, QpResult
from . import accuracy as acc

JITTER = (0.0, 1e-6, -1e-6, 2e-6)
# stage -> (module, wrapper) whose outputs a row rounds to f32
STAGES = {"linearization": ((lin_kernels, "erk4_sens"), (lin_kernels, "lin_y_sens")),
          "sdf row": ((sdf_fused, "sdf_value_grad"),),
          "condensing": ((condense_kernel, "condense"),)}


def gram_f32(M_rows, w_rows, r_rows, lm, dtype):
    """``sqp.gram`` as the JAX step forms it: in f32."""
    M = M_rows.float()
    eye = torch.eye(M.shape[-1], dtype=torch.float32, device=M.device)
    H = torch.bmm(M.mT * w_rows.float()[:, None, :], M) + lm * eye
    g = torch.bmm(M.mT, r_rows.float()[..., None])[..., 0]
    return H.to(dtype), g.to(dtype)


def _round32(fn):
    def wrapped(*a, **k):
        return tuple(t.float().double() if torch.is_tensor(t) else t for t in fn(*a, **k))
    return wrapped


def _qp_data_rounded(solve):
    return lambda qp, **kw: solve(QpData(*[t.float().double() for t in qp]), **kw)


def _qp_in_f32(solve):
    def wrapped(qp, **kw):
        res = solve(QpData(*[t.float() for t in qp]), **dict(kw, ratio_cap_override=1e8))
        return QpResult(dz=res.dz.double(), kkt_residual=res.kkt_residual.double(),
                        complementarity=res.complementarity.double(),
                        duals=QpDuals(*[d.double() for d in res.duals]))
    return wrapped


def cold_errors(model, device, solver_over=None):
    """errors(jitter, patches=()) -> per-scenario u0 error of one cold step
    of the family, x0 scaled by 1 + jitter, with each (module, name, fn) of
    ``patches`` standing in for module.name during the step."""
    gold, n = acc.cold_reference(model)
    cfg, ocp, layout, lat = acc.build_setup(device, solver_over, model)
    dtype = torch.float64 if str(cfg.solver.dtype) == "float64" else torch.float32
    inputs = acc.scenario_inputs(ocp, acc.build_scenarios(cfg, ocp, layout, lat)[:n], dtype,
                                 ocp.device)
    step = make_rti_step(ocp, cfg, with_evals=False)

    def errors(jitter=0.0, patches=()):
        x0 = inputs.x0 * (1 + jitter)
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        try:
            u0 = step(init_state(ocp, x0, dtype), inputs._replace(x0=x0)).u0
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        return np.abs(u0.double().cpu().numpy() - gold).max(axis=1)

    return errors


def report(model="props", device="cuda", jitters=JITTER):
    """Print the rows of the module docstring, one line each."""
    dev = resolve_device(device)
    line = lambda label, e: print(f"{model} {label}: u0 mean {e.mean():.3e} max {e.max():.3e}",
                                  flush=True)
    f32 = cold_errors(model, dev)
    for label, patches in (("f32 step", ()), ("f32 step, f32 Gram", ((sqp, "gram", gram_f32),))):
        for j in jitters:
            line(f"{label}, x0 (1 {j:+g})", f32(j, patches))
    f64 = cold_errors(model, torch.device("cpu"), {"dtype": "float64"})
    line("f64 step", f64())
    for stage, targets in STAGES.items():
        line(f"f64 step, {stage} rounded to f32",
             f64(patches=[(mod, name, _round32(getattr(mod, name))) for mod, name in targets]))
    line("f64 step, QP data rounded to f32",
         f64(patches=[(sqp, "solve_qp", _qp_data_rounded(sqp.solve_qp))]))
    line("f64 step, QP solved in f32", f64(patches=[(sqp, "solve_qp", _qp_in_f32(sqp.solve_qp))]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="props", choices=["att", *sorted(acc.ORACLE_KEYS)])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    report(args.model, args.device)


if __name__ == "__main__":
    main()
