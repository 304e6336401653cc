"""The reference's TorchScript weights onto the port's modules.

Counterpart of sdf_nmpc_tpu/nn/torch_import.py (:25-197), which maps the
reference archives (the NeuralDF ``sdf_90_25664.pt``, the ResNet VAE
``vae.pt``) onto flax trees.  The port's modules are torch modules in the
reference's own layouts (OIHW convolutions, (in, out, kh, kw) transposed
convolutions, NCHW flatten order of the heads), so importing is a renaming
of state-dict keys: no transpose, flip or permutation.

  * NeuralDF: layers.main1.{0,3}, layers.main2.{0,3}, layers.df.0
  * Mlp:      layers.{0,3,6,...}
  * Encoder:  layers.resnet.{0 conv, 3..6 ResBlock}, layers.mean, layers.logvar
  * Decoder:  layers.resnet.{0 Linear, 4..7 ResBlockDeconv, 8 ConvTranspose2d}

A ResBlock keeps Identity placeholders when batch norm is off, so its
Sequential indices are [0 conv, 1 bn, 2 relu, 3 conv, 4 bn] either way,
its shortcut [0 conv, 1 bn].
"""

from __future__ import annotations

import torch

_BN_KEYS = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def _copy(sd, src, dst, out, keys=("weight", "bias")):
    for k in keys:
        if f"{src}.{k}" in sd:
            out[f"{dst}.{k}"] = sd[f"{src}.{k}"].detach().cpu().clone()


def import_neural_df(state_dict) -> dict:
    """The port's ``NeuralDF`` state dict from a reference NeuralDF's."""
    sd, out = dict(state_dict), {}
    for dst, src in (("main1_0", "layers.main1.0"), ("main1_1", "layers.main1.3"),
                     ("main2_0", "layers.main2.0"), ("main2_1", "layers.main2.3"),
                     ("df", "layers.df.0")):
        _copy(sd, src, dst, out)
    return out


def import_mlp(state_dict, n_hidden: int) -> dict:
    """The port's ``Mlp`` state dict from a reference Mlp's (Linear layers
    at Sequential indices 0, 3, 6, ...)."""
    sd, out = dict(state_dict), {}
    for i in range(n_hidden + 1):
        _copy(sd, f"layers.{3 * i}", f"Dense_{i}", out)
    return out


def _block(sd, src, dst, conv, use_batchnorm, stride, out):
    """One (de)convolution ResBlock: main convolutions at Sequential
    indices 0 and 3, their norms at 1 and 4, the shortcut at shortcut.{0,1}."""
    pairs = [(f"{src}.layers.0", f"{src}.layers.1"), (f"{src}.layers.3", f"{src}.layers.4")]
    if stride != 1:
        pairs.append((f"{src}.shortcut.0", f"{src}.shortcut.1"))
    for j, (c, bn) in enumerate(pairs):
        _copy(sd, c, f"{dst}.{conv}_{j}", out)
        if use_batchnorm:
            _copy(sd, bn, f"{dst}.BatchNorm_{j}", out, _BN_KEYS)


def import_encoder(state_dict, use_batchnorm=True) -> dict:
    """The port's ``Encoder`` state dict from a reference Encoder's (keys
    may carry the ``encoder.`` prefix of a whole-VAE archive)."""
    sd = {k.removeprefix("encoder."): v for k, v in dict(state_dict).items()}
    out = {}
    _copy(sd, "layers.resnet.0", "Conv_0", out)
    for i, (idx, stride) in enumerate(zip((3, 4, 5, 6), (2, 2, 2, 1))):
        _block(sd, f"layers.resnet.{idx}", f"ResBlock_{i}", "Conv", use_batchnorm, stride, out)
    _copy(sd, "layers.mean", "mean", out)
    _copy(sd, "layers.logvar", "logvar", out)
    return out


def import_decoder(state_dict, use_batchnorm=True) -> dict:
    """The port's ``Decoder`` state dict from a reference Decoder's (keys
    may carry the ``decoder.`` prefix)."""
    sd = {k.removeprefix("decoder."): v for k, v in dict(state_dict).items()}
    out = {}
    _copy(sd, "layers.resnet.0", "Dense_0", out)
    for i, idx in enumerate((4, 5, 6, 7)):
        _block(sd, f"layers.resnet.{idx}", f"ResBlockDeconv_{i}", "ConvTransposeTorch",
               use_batchnorm, 2, out)
    _copy(sd, "layers.resnet.8", "ConvTransposeTorch_0", out)
    return out


def load_torchscript_state_dict(path):
    """A TorchScript archive's state dict, on the CPU."""
    return torch.jit.load(str(path), map_location="cpu").state_dict()
