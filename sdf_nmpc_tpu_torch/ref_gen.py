"""Single-node reference (``Ref``): pose/velocity targets plus the active
tracking weights.  ``RefGen``/``Waypoint`` come with the ``Nmpc`` facade
(ROADMAP.md section 1 item 7)."""

from __future__ import annotations

import numpy as np


class Ref:
    """Single-node reference: pose/velocity targets + active tracking weights."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.p = np.zeros(3)
        self.q = np.array([1.0, 0.0, 0.0, 0.0])
        self.v = np.zeros(3)
        self.wz = 0.0
        self.use_constrained_weights(False)

    def use_constrained_weights(self, constrained: bool):
        """Select set_const_on when constraints are active, else set_const_off."""
        ws = (self.cfg.mpc.weights.set_const_on if constrained
              else self.cfg.mpc.weights.set_const_off)
        self.Wp = np.asarray(ws.pos, dtype=float)
        self.Wq = np.asarray(ws.att, dtype=float)
        self.Wv = np.asarray(ws.vel, dtype=float)
        self.Ww = np.asarray(ws.rates, dtype=float)
        self.Wa = float(ws.acc)
        return self

    @classmethod
    def from_state(cls, cfg, x):
        """Ref tracking the given state."""
        ref = cls(cfg)
        ref.p = np.asarray(x[:3], dtype=float)
        ref.q = np.asarray(x[3:7], dtype=float)
        ref.v = np.asarray(x[7:10], dtype=float)
        ref.wz = float(x[12]) if len(x) > 12 else 0.0
        return ref
