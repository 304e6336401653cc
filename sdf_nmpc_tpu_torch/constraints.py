"""Cost and constraint row builders for ``build_ocp(..., extra_*=...)``.

Counterpart of sdf_nmpc_tpu/constraints.py: each builder returns row tuples,
``(fn, lower, upper, z1, z2)`` for constraints and ``(fn, weight)`` for cost
rows.  Stage fns take (x, u, p), terminal fns (x, p), each -> (...,) over
leading batch axes.  ``slack=None`` makes a row hard (cfg.solver.hard_slack).
"""

from __future__ import annotations

import numpy as np
import torch

from . import math as m
from .ocp import _slack_or_hard, camera_frame_position
from .params import ParamLayout
from .utils.device_consts import kept


def fov_const_normals(cfg, h_const=True, v_const=True, slack=None):
    """Half-space FoV rows: per FoV plane, the flag-gated signed distance of
    the camera to the plane, in [0, dmax] (the upper bound is vacuous)."""
    layout = ParamLayout.from_cfg(cfg)
    _, co_p_c = camera_frame_position(cfg, layout)
    z1, z2 = _slack_or_hard(cfg, slack)
    dmax = float(cfg.sensor.dmax)

    def plane_row(normal):
        # the JAX package holds the normal as a float32 constant
        n = np.asarray(normal / np.linalg.norm(normal), np.float32).astype(np.float64)

        def fn(x, u, p):
            return layout.get_flag(p) * (kept(n, x) * co_p_c(x, p)).sum(-1)

        return (fn, 0.0, dmax, z1, z2)

    th, tv = np.tan(cfg.sensor.hfov), np.tan(cfg.sensor.vfov)
    rows = []
    if h_const:
        rows += [plane_row(np.array([th, -1.0, 0.0])), plane_row(np.array([th, 1.0, 0.0]))]
    if v_const:
        rows += [plane_row(np.array([tv, 0.0, -1.0])), plane_row(np.array([tv, 0.0, 1.0]))]
    return rows


def _euler_of(x, i):
    q = x[..., 3:7]
    return m.quat2euler(q / torch.linalg.vector_norm(q, dim=-1, keepdim=True))[..., i]


def roll_const(cfg, slack=None):
    """Stage and terminal roll bound: (stage_rows, term_rows)."""
    z1, z2 = _slack_or_hard(cfg, slack)
    lim = float(cfg.robot.limits.roll)
    return ([(lambda x, u, p: _euler_of(x, 0), -lim, lim, z1, z2)],
            [(lambda x, p: _euler_of(x, 0), -lim, lim, z1, z2)])


def pitch_const(cfg, slack=None):
    """Stage and terminal pitch bound: (stage_rows, term_rows)."""
    z1, z2 = _slack_or_hard(cfg, slack)
    lim = float(cfg.robot.limits.pitch)
    return ([(lambda x, u, p: _euler_of(x, 1), -lim, lim, z1, z2)],
            [(lambda x, p: _euler_of(x, 1), -lim, lim, z1, z2)])


def vel_const(cfg, stage=True, term=False, slack=None):
    """Per-axis velocity bounds as general rows on x[7:10]: (stage_rows,
    term_rows)."""
    z1, z2 = _slack_or_hard(cfg, slack)
    lim = cfg.robot.limits
    stage_rows, term_rows = [], []
    for i, b in enumerate((float(lim.vx), float(lim.vy), float(lim.vz))):
        if stage:
            stage_rows.append((lambda x, u, p, j=7 + i: x[..., j], -b, b, z1, z2))
        if term:
            term_rows.append((lambda x, p, j=7 + i: x[..., j], -b, b, z1, z2))
    return stage_rows, term_rows


def yxvel_cost(cfg, w_y: float, w_z: float):
    """Stage cost rows on the velocity states x[8] and x[9]: [(fn, weight)]."""
    return [(lambda x, u, p: x[..., 8], float(w_y)), (lambda x, u, p: x[..., 9], float(w_z))]
