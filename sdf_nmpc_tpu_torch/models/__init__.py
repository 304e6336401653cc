"""Dynamics model registry: the six quad families of the JAX package."""

from .base import GRAVITY, ModelSpec, terminal_gate_enabled
from . import quad_acc, quad_att, quad_att_tau, quad_props, quad_rates, quad_wrench

_REGISTRY = {
    "acc": quad_acc.make_model,
    "att": quad_att.make_model,
    "att_tau": quad_att_tau.make_model,
    "rates": quad_rates.make_model,
    "wrench": quad_wrench.make_model,
    "props": quad_props.make_model,
}


def available_models():
    return sorted(_REGISTRY)


def make_model(cfg) -> ModelSpec:
    """Build the ModelSpec selected by cfg.mpc.model."""
    key = cfg.mpc.model
    if key not in _REGISTRY:
        raise ValueError(f"unknown mpc model {key!r}; available: {available_models()}")
    return _REGISTRY[key](cfg)


__all__ = ["GRAVITY", "ModelSpec", "available_models", "make_model", "terminal_gate_enabled"]
