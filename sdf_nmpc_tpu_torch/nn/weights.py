"""Shipped-weights loading: the trained NeuralDF and the trained VAE encoder
of ``<repo>/weights/``.

``weights/sdf.msgpack`` is a flax ``msgpack_serialize`` tree.  The GPU host
has neither flax nor msgpack, so this module carries its own reader of that
format: standard msgpack, where ext type 1 packs an array as a nested msgpack
tuple ``(shape, dtype name, C-order bytes)``, ext type 3 a numpy scalar the
same way, and arrays above 1 GiB arrive as ``__msgpack_chunked_array__``
dicts.  ``params_from_jax`` turns the flax tree (numpy leaves) into the port's
``NeuralDF`` state dict: a flax Dense ``kernel`` is (in, out), a torch Linear
``weight`` is (out, in).  ``encoder_from_jax`` and ``decoder_from_jax`` do
the same for the VAE (``nn/vae.py``): convolution kernels HWIO -> OIHW, the
transposed convolutions' flipped (kh, kw, in, out) kernels -> torch's
unflipped (in, out, kh, kw), BatchNorm scale / bias / batch_stats -> weight
/ bias / running statistics, and the head rows from flax's (h, w, c) flatten
order to torch's (c, h, w); ``vae_from_jax`` the whole Vae.
``opt_state_from_jax`` carries optax's AdamW state across to torch's.
"""

from __future__ import annotations

import json
import struct
import warnings
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from .neural_df import NeuralDF

WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "weights"

_LAYERS = ("main1_0", "main1_1", "main2_0", "main2_1", "df")


class _Reader:
    """Minimal msgpack decoder (the subset flax writes, plus every scalar type)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def _take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return bytes(out)

    def _unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self._take(struct.calcsize(">" + fmt)))[0]

    def _str(self, n: int):
        b = self._take(n)
        return b if self.raw else b.decode("utf-8")

    def _ext(self, n: int):
        code = self._unpack("b")
        payload = self._take(n)
        if code in (1, 3):  # ndarray, numpy scalar
            shape, dtype_name, buf = _Reader(payload, raw=True).read()
            dtype_name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
            arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(tuple(shape))
            return arr[()] if code == 3 else arr
        if code == 2:  # native complex
            re, im = _Reader(payload).read()
            return complex(re, im)
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
            0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
            0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
            0xDC: ("H", "array"), 0xDD: ("I", "array"),
            0xDE: ("H", "map"), 0xDF: ("I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self._unpack(fmt)
            if kind == "bin":
                return self._take(n)
            if kind == "ext":
                return self._ext(n)
            if kind == "str":
                return self._str(n)
            if kind == "array":
                return [self.read() for _ in range(n)]
            return self._map(n)
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in scalars:
            return self._unpack(scalars[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """Python tree (dicts, lists, numpy leaves) of flax msgpack bytes."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def params_from_jax(tree) -> dict:
    """NeuralDF state dict from a flax parameter tree of numpy arrays
    (``{'params': {...}}`` or the inner dict)."""
    p = tree["params"] if "params" in tree else tree
    state = {}
    for name in _LAYERS:
        kernel = np.asarray(p[name]["kernel"])
        state[f"{name}.weight"] = torch.from_numpy(np.array(kernel.T, order="C"))
        state[f"{name}.bias"] = torch.from_numpy(np.array(p[name]["bias"], order="C"))
    return state


def _meta(d: Path):
    f = d / "meta.json"
    return json.loads(f.read_text()) if f.exists() else None


def load_prod_sdf(weights_dir=None, require_latent=None, require_layers=None,
                  device="cuda") -> NeuralDF | None:
    """The trained NeuralDF on ``device``, or None if the artifacts are absent
    or the architecture does not match the requested sizes."""
    dev = resolve_device(device)
    d = Path(weights_dir) if weights_dir else WEIGHTS_DIR
    meta = _meta(d)
    if meta is None or not (d / "sdf.msgpack").exists():
        return None
    if require_latent is not None and meta["size_latent"] != require_latent:
        return None
    if require_layers is not None and tuple(meta["layer_sizes"]) != tuple(require_layers):
        return None
    module = NeuralDF(
        size_latent=meta["size_latent"],
        layer_sizes=tuple(meta["layer_sizes"]),
        embed=meta.get("embed", "oct"),
        act=meta.get("act", "sin"),
        w0=meta.get("w0", 8.0),
    )
    module.load_state_dict(params_from_jax(msgpack_restore((d / "sdf.msgpack").read_bytes())))
    return module.to(dev)


def load_prod_latents(weights_dir=None):
    """(n, L) encoded scene latents from training (numpy), or None."""
    d = Path(weights_dir) if weights_dir else WEIGHTS_DIR
    f = d / "latents.npy"
    return np.load(f) if f.exists() else None


def meta_img_shape(meta) -> tuple[int, int] | None:
    """(H, W) the encoder was trained at, parsed from meta['img'] 'HxW'."""
    img = (meta or {}).get("img")
    if not img:
        return None
    h, w = str(img).lower().split("x")
    return int(h), int(w)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def vae_state_from_jax(variables, heads=(), side="in", chw=(0, 0, 0)) -> dict:
    """Port state dict of a flax tree of the VAE's layers (numpy leaves;
    ``params`` and ``batch_stats``).  ``heads``: the Dense layers that meet
    a (C, H, W) = ``chw`` map in flax's (h, w, c) order, on their input
    (``side`` 'in', the encoder heads) or output ('out', the decoder's first
    layer)."""
    C, H, W = chw
    state = {}
    for path, a in _flat(variables.get("params", {})):
        layer, leaf = ".".join(path[:-1]), path[-1]
        head = path[-2] in heads
        if leaf == "kernel" and a.ndim == 4 and path[-2].startswith("ConvTransposeTorch"):
            a = a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]  # (in, out, kh, kw), unflipped
        elif leaf == "kernel" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif leaf == "kernel":
            if head and side == "in":  # rows (h, w, c) -> (c, h, w)
                a = a.reshape(H * W, C, -1).transpose(1, 0, 2).reshape(C * H * W, -1)
            elif head:  # columns
                a = a.reshape(-1, H * W, C).transpose(0, 2, 1).reshape(-1, C * H * W)
            a = a.T
        elif leaf == "bias" and head and side == "out":
            a = a.reshape(H * W, C).T.reshape(-1)
        elif leaf not in ("bias", "scale"):
            raise ValueError(f"unknown VAE parameter {'/'.join(path)}")
        state[f"{layer}.{'bias' if leaf == 'bias' else 'weight'}"] = torch.from_numpy(
            np.array(a, order="C"))
    for path, a in _flat(variables.get("batch_stats", {})):
        layer, leaf = ".".join(path[:-1]), path[-1]
        state[f"{layer}.running_{leaf}"] = torch.from_numpy(np.array(a, order="C"))
        state[f"{layer}.num_batches_tracked"] = torch.tensor(0)
    return state


def encoder_from_jax(variables) -> dict:
    """``Encoder`` state dict from a flax Encoder tree of numpy arrays
    (``{'params': ..., 'batch_stats': ...}``); the heads read a 512 x 2 x 2
    pooled map."""
    return vae_state_from_jax(variables, ("mean", "logvar"), "in", (512, 2, 2))


def decoder_from_jax(variables, unflatten_hw=(8, 15)) -> dict:
    """``Decoder`` state dict from a flax Decoder tree of numpy arrays; its
    first Dense layer feeds a 512 x unflatten_hw map."""
    return vae_state_from_jax(variables, ("Dense_0",), "out", (512, *unflatten_hw))


def vae_from_jax(variables, unflatten_hw=(8, 15)) -> dict:
    """``Vae`` state dict from a flax Vae tree of numpy arrays (``params``
    with 'encoder' and 'decoder', and their ``batch_stats``)."""
    state = {}
    for part, convert in (("encoder", encoder_from_jax),
                          ("decoder", lambda v: decoder_from_jax(v, unflatten_hw))):
        sub = {k: variables[k][part] for k in ("params", "batch_stats") if k in variables}
        state.update({f"{part}.{k}": v for k, v in convert(sub).items()})
    return state


def opt_state_from_jax(optimizer, module, opt_state, to_state):
    """Carry optax's ``inject_hyperparams(adamw)`` state into a torch AdamW
    over ``module``'s parameters, in place.  ``opt_state`` is that state as
    a tree of numpy leaves (flax's state dict: ``hyperparams`` and
    ``inner_state``, whose first entry holds Adam's ``count``, ``mu`` and
    ``nu``); ``to_state`` maps a flax parameter tree to the module's state
    dict (``params_from_jax``, ``vae_from_jax``).  mu and nu cross as the
    parameters do (transposes, flips and row permutations commute with
    Adam's elementwise update); count becomes every parameter's ``step``,
    and the learning rate, weight decay, betas and eps the groups'."""
    adam = opt_state["inner_state"]["0"]
    step = float(np.asarray(adam["count"]))
    mu, nu = to_state(adam["mu"]), to_state(adam["nu"])
    hyper = {k: float(np.asarray(v)) for k, v in opt_state["hyperparams"].items()}
    for group in optimizer.param_groups:
        group["lr"] = hyper["learning_rate"]
        group["weight_decay"] = hyper.get("weight_decay", group["weight_decay"])
        group["betas"] = (hyper.get("b1", group["betas"][0]), hyper.get("b2", group["betas"][1]))
        group["eps"] = hyper.get("eps", group["eps"])
    for name, p in module.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[name].to(dtype=p.dtype, device=p.device).clone(),
            "exp_avg_sq": nu[name].to(dtype=p.dtype, device=p.device).clone(),
        }
    return optimizer


def load_prod_encoder(weights_dir=None, expect_img=None, strict=False, device="cuda"):
    """(Encoder in eval mode on ``device``, meta) for the trained VAE
    encoder, or None if absent.  ``batchnorm`` comes from the meta.

    expect_img: the (H, W) the caller will feed.  The adaptive pooling runs
    any shape, but one away from the trained resolution (meta['img']) is out
    of distribution: on a mismatch this warns, and under ``strict`` returns
    None."""
    from .vae import Encoder

    dev = resolve_device(device)
    d = Path(weights_dir) if weights_dir else WEIGHTS_DIR
    meta = _meta(d)
    if meta is None or not (d / "vae_encoder.msgpack").exists():
        return None
    if expect_img is not None:
        trained = meta_img_shape(meta)
        if trained is not None and tuple(expect_img) != trained:
            msg = (f"prod VAE encoder was trained at {trained[0]}x{trained[1]} but caller feeds "
                   f"{tuple(expect_img)[0]}x{tuple(expect_img)[1]}: latents will be out of the "
                   "training distribution; resize inputs to the trained resolution")
            if strict:
                warnings.warn(msg + " (strict: returning None)")
                return None
            warnings.warn(msg)
    module = Encoder(1, meta["size_latent"], dropout_rate=0.0,
                     batchnorm=bool(meta.get("batchnorm", False)))
    module.load_state_dict(encoder_from_jax(msgpack_restore(
        (d / "vae_encoder.msgpack").read_bytes())))
    return module.eval().to(dev), meta
