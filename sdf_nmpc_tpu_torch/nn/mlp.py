"""Generic MLP: the braking-distance surrogate's network (theory/braking.py).

Counterpart of sdf_nmpc_tpu/nn/mlp.py ``Mlp``: Dense layers of
``layer_sizes``, each followed by ``inner_act`` and dropout (off at eval),
then a Dense head of ``size_out`` and ``out_act``.  Layers are named
``Dense_0``, ``Dense_1``, ... as flax names them, so ``mlp_params_from_flax``
carries a flax parameter tree across by name (``mlp_params_to_flax`` back).
torch needs the input width,
which flax infers at init: ``size_in``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn


class Mlp(nn.Module):
    def __init__(self, size_in: int, size_out: int, layer_sizes: Sequence[int],
                 inner_act: Callable = torch.relu, out_act: Optional[Callable] = None,
                 dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.inner_act, self.out_act = inner_act, out_act
        self.dropout = nn.Dropout(dropout_rate)
        widths = [int(size_in), *(int(n) for n in layer_sizes), int(size_out)]
        self.n_dense = len(widths) - 1
        for i in range(self.n_dense):
            layer = nn.Linear(widths[i], widths[i + 1])
            if generator is not None:  # torch's default init, drawn from the generator
                bound = 1.0 / np.sqrt(widths[i])
                with torch.no_grad():
                    layer.weight.uniform_(-bound, bound, generator=generator)
                    layer.bias.uniform_(-bound, bound, generator=generator)
            setattr(self, f"Dense_{i}", layer)

    def forward(self, x):
        for i in range(self.n_dense - 1):
            x = self.dropout(self.inner_act(getattr(self, f"Dense_{i}")(x)))
        x = getattr(self, f"Dense_{self.n_dense - 1}")(x)
        return x if self.out_act is None else self.out_act(x)


def mlp_params_from_flax(tree) -> dict:
    """Mlp state dict from a flax ``Mlp`` parameter tree of numpy arrays
    (``{'params': {'Dense_i': {'kernel', 'bias'}}}`` or the inner dict): a
    flax kernel is (in, out), a torch weight (out, in)."""
    p = tree["params"] if "params" in tree else tree
    state = {}
    for name, layer in p.items():
        state[f"{name}.weight"] = torch.from_numpy(np.array(np.asarray(layer["kernel"]).T,
                                                            order="C"))
        state[f"{name}.bias"] = torch.from_numpy(np.array(layer["bias"], order="C"))
    return state


def mlp_params_to_flax(state: dict) -> dict:
    """Flax ``Mlp`` variables ``{'params': {'Dense_i': {'kernel', 'bias'}}}``
    (numpy) of an Mlp state dict: the inverse of ``mlp_params_from_flax``."""
    to_np = lambda t: t.detach().cpu().numpy()
    layers = sorted({key.rsplit(".", 1)[0] for key in state}, key=lambda n: int(n.split("_")[1]))
    return {"params": {name: {"kernel": np.ascontiguousarray(to_np(state[f"{name}.weight"]).T),
                              "bias": to_np(state[f"{name}.bias"])} for name in layers}}
