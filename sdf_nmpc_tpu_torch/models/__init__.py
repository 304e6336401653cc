"""Dynamics model registry.  The port carries the ``att`` family; the other
five quad families are queued in ROADMAP.md (section 1, item 9)."""

from .base import GRAVITY, ModelSpec, terminal_gate_enabled
from . import quad_att

_PORTED = {"att": quad_att.make_model}
_QUEUED = ("acc", "att_tau", "rates", "wrench", "props")


def make_model(cfg) -> ModelSpec:
    """Build the ModelSpec selected by cfg.mpc.model."""
    key = cfg.mpc.model
    if key in _QUEUED:
        raise NotImplementedError(
            f"mpc model {key!r} is not ported yet; it is queued in ROADMAP.md "
            "section 1 item 9 (other quad families)"
        )
    if key not in _PORTED:
        raise ValueError(f"unknown mpc model {key!r}; ported: {sorted(_PORTED)}")
    return _PORTED[key](cfg)


__all__ = ["GRAVITY", "ModelSpec", "make_model", "terminal_gate_enabled"]
