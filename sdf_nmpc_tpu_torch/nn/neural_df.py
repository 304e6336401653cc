"""Neural (truncated, signed) distance-field MLP as an ``nn.Module``.

Input ``[pos(3) | latent]``; positional embedding on the position; two hidden
blocks ('main1', 'main2') with a mid-network residual re-concatenation of the
embeddings and/or latent ('res' mode full/state/latent/none); scalar df head.
Activations: sine (SIREN, w0), relu, softplus; in training mode, dropout
(``dropout_rate``, flax's: scaled by 1 / keep) after each hidden activation.
Layer names follow the flax module, so ``nn/weights.py`` carries trained
parameters across by name.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .activation import sine
from .dropout import dropout
from .embeddings import embedding_for


class NeuralDF(nn.Module):
    def __init__(
        self,
        nb_states: int = 3,
        size_latent: int = 128,
        signed: bool = True,
        max_df: float = 1.0,
        res: str = "full",
        w0: float = 1.0,
        embed: str = "pos",
        act: str = "sin",
        layer_sizes: Sequence[int] = (256, 256, 256, 256),
        nb_freqs: int = 5,
        dropout_rate: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if act not in ("sin", "relu", "softplus"):
            raise ValueError(f"unknown activation {act!r}")
        if res not in ("full", "state", "latent", "none"):
            raise ValueError(f"unknown residual mode {res!r}")
        self.nb_states = nb_states
        self.size_latent = size_latent
        self.signed = signed
        self.max_df = max_df
        self.res = res
        self.w0 = float(w0)
        self.embed = embed
        self.act = act
        self.layer_sizes = tuple(int(s) for s in layer_sizes)
        self.nb_freqs = nb_freqs
        self.dropout_rate = float(dropout_rate)
        self.embed_fn, self.nb_embeddings = embedding_for(embed, nb_freqs)

        ls = self.layer_sizes
        in1 = self.nb_embeddings + size_latent
        in3 = ls[1] + (self.nb_embeddings if res in ("full", "state") else 0) + (
            size_latent if res in ("full", "latent") else 0)
        self.main1_0 = nn.Linear(in1, ls[0])
        self.main1_1 = nn.Linear(ls[0], ls[1])
        self.main2_0 = nn.Linear(in3, ls[2])
        self.main2_1 = nn.Linear(ls[2], ls[3])
        self.df = nn.Linear(ls[3], 1)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """SIREN init U(+-sqrt(6/fan_in)/w0) for the hidden layers under 'sin',
        LeCun normal otherwise and for the head; zero biases (the flax
        module's initializers)."""
        for lin in (self.main1_0, self.main1_1, self.main2_0, self.main2_1, self.df):
            fan_in = lin.in_features
            if self.act == "sin" and lin is not self.df:
                bound = float(np.sqrt(6.0 / fan_in) / self.w0)
                lin.weight.uniform_(-bound, bound, generator=generator)
            else:
                lin.weight.normal_(0.0, float(np.sqrt(1.0 / fan_in)), generator=generator)
            lin.bias.zero_()

    def _act(self, z):
        if self.act == "sin":
            return sine(z, self.w0)
        if self.act == "relu":
            return torch.relu(z)
        return nn.functional.softplus(z)

    def forward(self, x, generator: Optional[torch.Generator] = None, shared_mask: bool = False):
        """x: (..., 3 + size_latent) -> (..., 1) truncated distance.

        In training mode with ``dropout_rate`` > 0 each hidden activation is
        dropped with masks drawn from ``generator``: one per row, or with
        ``shared_mask`` one (1, width) mask per layer shared by every row
        (what the JAX package's input gradient, a vmap of ``jax.grad`` under
        one unbatched dropout key, draws)."""
        drop = self.training and self.dropout_rate > 0.0

        def act(z):
            h = self._act(z)
            if not drop:
                return h
            shape = (1,) * (h.dim() - 1) + h.shape[-1:] if shared_mask else None
            return dropout(h, self.dropout_rate, generator, shape)

        state = x[..., :3]
        latent = x[..., 3:]
        emb = self.embed_fn(state) if self.embed_fn is not None else state
        h = torch.cat([emb, latent], dim=-1)
        h = act(self.main1_0(h))
        h = act(self.main1_1(h))
        if self.res in ("full", "state"):
            h = torch.cat([h, emb], dim=-1)
        if self.res in ("full", "latent"):
            h = torch.cat([h, latent], dim=-1)
        h = act(self.main2_0(h))
        h = act(self.main2_1(h))
        return self.df(h)
