"""Positional embeddings with off-axis projections.

The NeRF-style feature vector ``[x, sin(2^i A x), cos(2^i A x)]`` for i in
0..nb_freqs-1, with projection directions A drawn from platonic solids:
'none' (identity axes), 'cube' (6), 'octohedron' (8), 'dodecahedron' (12),
'icosahedron' (20).  nb_embeddings = nb_freqs * n_dirs * 2 + 3.  The cosine
half is computed as ``sin(xb + pi/2)``, as the JAX module computes it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device_consts import kept

_PHI = (1 + np.sqrt(5.0)) / 2


def _dirs(proj: str) -> np.ndarray:
    """(3, n_dirs) unit projection directions."""
    if proj == "none":
        d = np.eye(3)
    elif proj == "cube":
        d = np.array(
            [[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1]],
            dtype=np.float64,
        ).T
    elif proj == "octohedron":  # reference spelling kept for config compat
        d = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
            dtype=np.float64,
        ).T
    elif proj == "dodecahedron":
        d = np.array(
            [
                [0, -1, -_PHI], [0, 1, -_PHI], [0, -1, _PHI], [0, 1, _PHI],
                [-1, 0, -_PHI], [1, 0, -_PHI], [-1, 0, _PHI], [1, 0, _PHI],
                [-1, -_PHI, 0], [1, -_PHI, 0], [-1, _PHI, 0], [1, _PHI, 0],
            ],
            dtype=np.float64,
        ).T
    elif proj == "icosahedron":
        h = 1 / _PHI
        d = np.array(
            [
                [1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1],
                [-1, 1, 1], [-1, 1, -1], [-1, -1, 1], [-1, -1, -1],
                [0, _PHI, h], [0, _PHI, -h], [0, -_PHI, h], [0, -_PHI, -h],
                [h, 0, _PHI], [h, 0, -_PHI], [-h, 0, _PHI], [-h, 0, -_PHI],
                [_PHI, h, 0], [_PHI, -h, 0], [-_PHI, h, 0], [-_PHI, -h, 0],
            ],
            dtype=np.float64,
        ).T
    else:
        raise ValueError(f"unknown off-axis projection mode {proj!r}")
    if proj != "none":
        d = d / np.linalg.norm(d, axis=0)
    return d


class PositionEmbedding:
    """Static positional-embedding table + apply: (..., 3) -> (..., nb_embeddings)."""

    def __init__(self, nb_freqs: int = 10, proj: str = "none"):
        self.nb_freqs = nb_freqs
        self.proj = proj
        self.dirs = _dirs(proj)  # (3, n_dirs)
        self.freq_bands = 2.0 ** np.arange(nb_freqs)
        self.nb_embeddings = nb_freqs * self.dirs.shape[-1] * 2 + 3

    def __call__(self, x):
        dirs, freqs = kept(self.dirs, x), kept(self.freq_bands, x)
        proj = x @ dirs  # (..., n_dirs)
        xb = (proj[..., None] * freqs).reshape(*proj.shape[:-1], -1)
        emb = torch.sin(torch.cat([xb, xb + 0.5 * np.pi], dim=-1))
        return torch.cat([x, emb], dim=-1)


_EMBED_MODES = {"pos": "none", "cube": "cube", "oct": "octohedron",
                "dod": "dodecahedron", "ico": "icosahedron"}


def embedding_for(embed: str, nb_freqs: int):
    """(apply_fn_or_None, nb_embeddings) for the NeuralDF ``embed`` keyword."""
    if embed == "none":
        return None, 3
    if embed in _EMBED_MODES:
        pe = PositionEmbedding(nb_freqs, proj=_EMBED_MODES[embed])
        return pe, pe.nb_embeddings
    raise ValueError(f"unknown embedding {embed!r}")
