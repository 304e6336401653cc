"""Immutable nested config with ``replace()``, and the default values.

The defaults are the JAX package's ``config/default.yaml`` written out as a
Python dict, so ``default_config`` reads no YAML (the GPU host has no YAML
parser); ``load_config`` reads a YAML file where PyYAML is installed.
A tier-1 test holds ``default_config()`` equal to the JAX package's, field for
field, so the two copies cannot drift.  The values are kept exactly as the
YAML loader produces them, including ``qp_ratio_cap``, which YAML 1.1 reads
as the string ``'1.0e8'`` (``solver/sqp.py`` converts it with ``float``).

The TPU-only knobs ``matmul_precision`` and ``qp_matmul_precision`` are kept
so configs carry over, and ignored.  ``sdf_fused_dtype`` is read by the RTI
step: on the card ``f32`` runs kernel 2 in IEEE f32 and ``f32x3`` (the
default; the TPU's three-pass bf16 emulation of f32) as 3xTF32 on the
tensor cores, ``bf16`` with every product of bf16-rounded operands on the
bf16 tensor cores and ``mixed`` with the primal rows in IEEE f32 and the
tangent rows in bf16; on the CPU every mode runs the exact plain version.
Every other product is IEEE f32.
"""

from __future__ import annotations

import math as _pymath
from typing import Any, Mapping


def _normalize(value: Any) -> Any:
    if isinstance(value, dict):
        return FrozenConfig(value)
    if isinstance(value, (list, tuple)):
        return tuple(_normalize(v) for v in value)
    if isinstance(value, str) and value in ("None", "none", "null", "Null"):
        return None
    return value


def _freeze(obj):
    if isinstance(obj, FrozenConfig):
        return _freeze(obj._data)
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, tuple):
        return tuple(_freeze(v) for v in obj)
    return obj


def _thaw(obj):
    if isinstance(obj, FrozenConfig):
        return obj.to_dict()
    if isinstance(obj, tuple):
        return [_thaw(v) for v in obj]
    return obj


class FrozenConfig(Mapping):
    """Immutable, hashable, attribute-accessible nested mapping."""

    __slots__ = ("_data", "_hash")

    def __init__(self, data: Mapping[str, Any]):
        object.__setattr__(self, "_data", {k: _normalize(v) for k, v in data.items()})
        object.__setattr__(self, "_hash", None)

    def __getitem__(self, key):
        return self._data[key]

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __getattr__(self, key):
        try:
            return self._data[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        raise AttributeError("FrozenConfig is immutable; use .replace()")

    def __hash__(self):
        if self._hash is None:
            object.__setattr__(self, "_hash", hash(_freeze(self._data)))
        return self._hash

    def __eq__(self, other):
        return isinstance(other, FrozenConfig) and self._data == other._data

    def __repr__(self):
        return f"FrozenConfig({self._data!r})"

    def replace(self, **updates) -> "FrozenConfig":
        """Return a new config with top-level keys replaced (nested via dicts)."""
        merged = dict(self._data)
        for k, v in updates.items():
            if isinstance(v, Mapping) and isinstance(merged.get(k), FrozenConfig):
                merged[k] = merged[k].replace(**v)
            else:
                merged[k] = v
        return FrozenConfig(merged)

    def to_dict(self) -> dict:
        return {k: _thaw(v) for k, v in self._data.items()}


_WEIGHTS = {
    "set_const_off": {"pos": [10, 10, 10], "vel": [3, 3, 3], "att": [50, 50, 50],
                      "rates": [0, 0, 3], "acc": 0.05},
    "set_const_on": {"pos": [0, 0, 5], "vel": [3, 3, 3], "att": [50, 50, 10],
                     "rates": [0, 0, 3], "acc": 0.05},
    "slack_df": [200, 50],
    "slack_fov": [20, 0],
    "slack_brake": None,
}

DEFAULTS = {
    "name": "default",
    "ref": {"yaw_mode": "align", "align_yaw_offset": 0,
            "stop_and_turn": {"enable": False, "dang_min": 1},
            "yaw_align_dmin": 0.1, "vref": 3, "wzref": 1, "zref": 2},
    "mission": {"control_interface": "TRPYr", "timeout_ref": 0.5, "timeout_img": 1,
                "stop_and_go": False,
                "wps": [[1, 0, 2, 1.5], [2, 0, 2, -1.5], [3, 0, 2, 1.5]],
                "wp_tol": 0.8, "joystick_lp_alpha": 0.9},
    "flags": {"simulation": True, "enable_sdf": True, "sdf_cost": False,
              "sdf_constraint": True, "vfov_constraint": True,
              "recursive_feasibility": False, "stability": False},
    "nn": {"size_latent": 128, "vae_weights": "vae.msgpack", "sdf_weights": "sdf.msgpack"},
    "mpc": {
        "model": "att",
        "weights": _WEIGHTS,
        "N": 20, "T": 1.5, "bound_margin": 0.15, "control_loop_time": 10,
        "uniform_dt": True, "nb_short_nodes": 2, "lm_reg": 10, "shift": 0,
        "fov_const_offset": 0.05, "fov_ratio": 0.9, "allow_dead_reck": False,
        "max_solver_fail": 3,
        "p_idx": {"flag": 0, "W_p_Co": [1, 2, 3],
                  "W_R_Co": [4, 5, 6, 7, 8, 9, 10, 11, 12],
                  "q_d": [13, 14, 15, 16], "latent": 17},
        "braking_dist": {"degree": 4, "coeff_file": "braking_dist/bdist_poly_deg4.npy"},
        "stability": {"a_b_min": 6.32},
    },
    "solver": {
        "qp_backend": "auto", "qp_iters": "auto", "qp_iters_warm": "auto",
        "qp_stiff_iters_warm": 8, "qp_iters_steady": "auto",
        "qp_stiff_iters_steady": "auto", "steady_after": 3, "sqp_iters": 1,
        "hard_slack": [1000, 10000], "dtype": "float32", "barrier_init": 0.1,
        "box_margin": 1e-06, "ir_steps": 0, "qp_stiff_k": "auto",
        "qp_stiff_iters": "auto", "qp_ratio_cap": "1.0e8", "kkt_tol": None,
        "chol_impl": "auto", "lin_impl": "auto", "fused_sdf": True,
        "sdf_fused_dtype": "f32x3", "matmul_precision": "high",
        "qp_matmul_precision": "highest",
    },
    "robot": {
        "mass": 1.46, "inertia": [0.017, 0.018, 0.028],
        "alloc": {"cf": 0.02246, "ct": 0.00020673,
                  "motors": [[0.09, -0.09, -0.005, 0, 0, -1],
                             [-0.09, 0.09, -0.005, 0, 0, -1],
                             [0.09, 0.09, -0.005, 0, 0, 1],
                             [-0.09, -0.09, -0.005, 0, 0, 1]]},
        "sensor_extrinsics": {"position": [0.180, 0, -0.025], "orientation": [0, 0, 0]},
        "size": {"xy": 0.22, "z": 0.1125},
        "limits": {"roll": 0.7, "pitch": 0.7, "vx": 3, "vy": 3, "vz": 3, "wx": 2,
                   "wy": 2, "wz": 3, "ax": 4, "ay": 4, "az": 3, "gamma": 20,
                   "torques": 0, "wp": 25},
    },
    "sensor": {"hfov": 0.7592, "vfov": 0.4903, "aspect_ratio": 1.778, "dmax": 5,
               "shape_imgs": [1, 270, 480], "is_depth": True, "is_spherical": False,
               "is_normalized": False, "mm_resolution": 1000, "dtype": "float32"},
}


def get_vfov(hfov: float, aspect_ratio: float, is_spherical: bool) -> float:
    """Half vertical fov from half horizontal fov and aspect ratio."""
    if is_spherical:
        return hfov / aspect_ratio
    return _pymath.atan(_pymath.tan(hfov) / aspect_ratio)


def _euler2rot_tuple(euler) -> tuple:
    """Z1Y2X3 rotation matrix as nested tuples (hashable)."""
    r, p, y = float(euler[0]), float(euler[1]), float(euler[2])
    cr, sr = _pymath.cos(r), _pymath.sin(r)
    cp, sp = _pymath.cos(p), _pymath.sin(p)
    cy, sy = _pymath.cos(y), _pymath.sin(y)
    return (
        (cp * cy, sr * sp * cy - cr * sy, cr * sp * cy + sr * sy),
        (cp * sy, sr * sp * sy + cr * cy, cr * sp * sy - sr * cy),
        (-sp, sr * cp, cr * cp),
    )


def make_config(raw: Mapping) -> FrozenConfig:
    """Validate the sensor fov and attach the derived sensor extrinsics
    ``sensor.B_p_C`` (3,) and ``sensor.B_R_C`` (3, 3)."""
    cfg = FrozenConfig(raw)
    vfov = get_vfov(cfg.sensor.hfov, cfg.sensor.aspect_ratio, cfg.sensor.is_spherical)
    if abs(vfov - cfg.sensor.vfov) >= 0.1:
        raise ValueError("sensor vfov is inconsistent with hfov and aspect_ratio")
    b_p_c = tuple(float(v) for v in cfg.robot.sensor_extrinsics.position)
    b_r_c = _euler2rot_tuple(cfg.robot.sensor_extrinsics.orientation)
    return cfg.replace(sensor=dict(B_p_C=b_p_c, B_R_C=b_r_c))


def load_config(config_file) -> FrozenConfig:
    """Read a YAML config (the JAX package's ``config/*.yaml`` format) and
    validate and complete it as ``make_config`` does.  PyYAML is imported
    here: a host without it raises ImportError and can build the config
    from a dict with ``make_config``."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "load_config reads YAML with PyYAML, which is not installed; build the config "
            "from a dict with make_config(raw) instead") from e
    with open(config_file, "r") as f:
        return make_config(yaml.safe_load(f))


def default_config() -> FrozenConfig:
    return make_config(DEFAULTS)


def sensor_extrinsics(cfg):
    """(B_p_C (3,), B_R_C (3, 3)) as float64 numpy arrays."""
    import numpy as np

    return (np.array(cfg.sensor.B_p_C, dtype=np.float64),
            np.array(cfg.sensor.B_R_C, dtype=np.float64))
