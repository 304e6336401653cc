"""Braking-distance analysis (counterpart of scripts/find_amax.py), on the
card unless ``--device cpu``:

    python -m sdf_nmpc_tpu_torch.cli.find_amax default grid [--vmax 3 --step 0.05]
    python -m sdf_nmpc_tpu_torch.cli.find_amax default {min_acc,poly_fit,poly_eval,mlp_fit,mlp_eval}

Modes: grid (a_max and the braking distance over the velocity ball, one
vectorized f64 bisection for every direction), min_acc, poly_fit (closed-form
least squares), poly_eval, mlp_fit (Adam on a tanh MLP), mlp_eval.  The
files are the JAX script's, under ``cache_dir()/braking_dist/<cfg.name>`` or
``--out-dir``: ``<vmax>_<step>_vel.npy`` and ``_bdist.npy``,
``bdist_poly_deg<d>_<vmax>.npy`` and ``bdist_mlp.msgpack`` (flax's format:
either package's mlp_eval reads either package's file).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

MODES = ("grid", "min_acc", "poly_fit", "poly_eval", "mlp_fit", "mlp_eval")
MLP_LAYERS = (20, 20, 20)  # the JAX script's surrogate


def run(cfg, mode: str, vmax: float = 3.0, step: float = 0.05, degree: int = 4,
        out_dir=None, device="cuda") -> dict:
    """One mode of the analysis: writes its files, prints the JAX script's
    line, and returns its numbers."""
    import torch

    from .. import cache_dir
    from ..math import polynomial_3variate
    from ..nn.mlp import Mlp, mlp_params_from_flax, mlp_params_to_flax
    from ..nn.weights import msgpack_restore, msgpack_serialize
    from ..theory import braking_grid, eval_surrogate, fit_mlp, fit_poly, min_braking_accel

    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: one of {MODES}")
    path = Path(out_dir or (cache_dir() / "braking_dist" / cfg.name))
    path.mkdir(parents=True, exist_ok=True)
    tag = f"{vmax:g}_{step:g}"
    poly_file = path / f"bdist_poly_deg{degree}_{vmax:g}.npy"
    mlp_file = path / "bdist_mlp.msgpack"

    if mode == "grid":
        vel, bdist, amax = braking_grid(cfg, vmax, step, device=device)
        np.save(path / f"{tag}_vel.npy", vel)
        np.save(path / f"{tag}_bdist.npy", bdist)
        print(f"grid: {len(vel)} velocities; a_min = {amax.min():.3f}, saved to {path}")
        return {"n": len(vel), "a_min": float(amax.min()), "path": path}

    vel = np.load(path / f"{tag}_vel.npy")
    bdist = np.load(path / f"{tag}_bdist.npy")
    if mode == "min_acc":
        amin = min_braking_accel(vel, bdist)
        print(f"amin: {amin:.4f}  (feeds cfg.mpc.stability.a_b_min)")
        return {"a_min": amin}
    if mode == "poly_fit":
        coeffs = fit_poly(vel, bdist, degree=degree)
        np.save(poly_file, coeffs)
        print(f"saved {len(coeffs)} coefficients to {poly_file}")
        return {"coeffs": coeffs, "path": poly_file}
    if mode == "poly_eval":
        poly, _ = polynomial_3variate(degree, np.load(poly_file))
        rmse, max_err = eval_surrogate(poly, vel, bdist)
        print(f"poly deg {degree}: rmse {rmse:.4f}, max error {max_err:.4f}")
        return {"rmse": rmse, "max_err": max_err}
    if mode == "mlp_fit":
        module, loss = fit_mlp(vel, bdist, layer_sizes=MLP_LAYERS, device=device)
        mlp_file.write_bytes(msgpack_serialize(mlp_params_to_flax(module.state_dict())))
        print(f"mlp fit final loss {loss:.6f}, saved to {mlp_file}")
        return {"loss": loss, "path": mlp_file}
    # mlp_eval: in f64, as the JAX script's flax Dense promotes its f32 kernels
    module = Mlp(3, 1, MLP_LAYERS, inner_act=torch.tanh)
    module.load_state_dict(mlp_params_from_flax(msgpack_restore(mlp_file.read_bytes())))
    rmse, max_err = eval_surrogate(module.double().eval(), vel, bdist)
    print(f"mlp: rmse {rmse:.4f}, max error {max_err:.4f}")
    return {"rmse": rmse, "max_err": max_err}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", help="config yaml path (or 'default')")
    ap.add_argument("mode", choices=MODES)
    ap.add_argument("--vmax", type=float, default=3.0)
    ap.add_argument("--step", type=float, default=0.05)
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from .find_rtilde import load_cfg

    return run(load_cfg(args.config), args.mode, args.vmax, args.step, args.degree,
               args.out_dir, args.device)


if __name__ == "__main__":
    main()
