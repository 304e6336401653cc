"""Runtime parameter-vector ("p") layout.

``[flag(1) | W_p_Co(3) | W_R_Co(9) | q_d(4) | latent(L)]``, the layout the
JAX package shares with the reference.  W_R_Co is stored row-major, so
``reshape(3, 3)`` is direct: no CasADi-style transpose.

The getters take p with any leading batch axes, ``(..., np_total)``.  An
index run that is contiguous, as every run of the layout above, is read as a
basic slice (a view: no copy, no launch); another run is gathered with an
index tensor kept on p's device (``utils/device_consts.py``).  Neither copies
a host value to the card, so neither waits for the work queued there.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .utils.device_consts import kept


@functools.cache
def _as_slice(idx: tuple):
    """``slice(a, b)`` when idx is the run a, a+1, ..., b-1, else None."""
    a = idx[0]
    return slice(a, a + len(idx)) if idx == tuple(range(a, a + len(idx))) else None


def _take(p, idx: tuple):
    """``p[..., list(idx)]``, without a host-to-device copy of idx."""
    run = _as_slice(idx)
    if run is not None:
        return p[..., run]
    return torch.index_select(p, -1, kept(idx, p, torch.long))


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """Index layout of the flat runtime parameter vector."""

    flag: int
    W_p_Co: tuple
    W_R_Co: tuple
    q_d: tuple
    latent_start: int
    size_latent: int

    @property
    def np_total(self) -> int:
        return self.latent_start + self.size_latent

    @classmethod
    def from_cfg(cls, cfg) -> "ParamLayout":
        pi = cfg.mpc.p_idx
        return cls(
            flag=int(pi.flag),
            W_p_Co=tuple(pi.W_p_Co),
            W_R_Co=tuple(pi.W_R_Co),
            q_d=tuple(pi.q_d),
            latent_start=int(pi.latent),
            size_latent=int(cfg.nn.size_latent),
        )

    # -- tensor getters (p: (..., np_total)) --
    def get_flag(self, p):
        return p[..., self.flag]

    def get_W_p_Co(self, p):
        return _take(p, self.W_p_Co)

    def get_W_R_Co(self, p):
        """(..., 3, 3) camera-to-world rotation; stored row-major in p."""
        return _take(p, self.W_R_Co).reshape(p.shape[:-1] + (3, 3))

    def get_q_d(self, p):
        return _take(p, self.q_d)

    def get_latent(self, p):
        return p[..., self.latent_start:]

    # -- host-side setters (p_mat: (..., np_total) numpy, mutated in place) --
    def set_flag(self, p_mat: np.ndarray, flag: float):
        p_mat[..., self.flag] = float(flag)

    def set_camera(self, p_mat: np.ndarray, W_p_Co, W_R_Co):
        p_mat[..., list(self.W_p_Co)] = np.asarray(W_p_Co).reshape(-1)
        p_mat[..., list(self.W_R_Co)] = np.asarray(W_R_Co).reshape(9)  # row-major

    def set_q_d(self, p_mat: np.ndarray, q_d):
        p_mat[..., list(self.q_d)] = np.asarray(q_d).reshape(-1)

    def set_latent(self, p_mat: np.ndarray, latent):
        p_mat[..., self.latent_start:] = np.asarray(latent).reshape(-1)
