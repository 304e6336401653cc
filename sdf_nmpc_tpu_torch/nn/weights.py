"""Shipped-weights loading: the trained NeuralDF and the trained VAE encoder
of ``<repo>/weights/``.

``weights/sdf.msgpack`` is a flax ``msgpack_serialize`` tree.  The GPU host
has neither flax nor msgpack, so this module carries its own reader of that
format: standard msgpack, where ext type 1 packs an array as a nested msgpack
tuple ``(shape, dtype name, C-order bytes)``, ext type 3 a numpy scalar the
same way, and arrays above 1 GiB arrive as ``__msgpack_chunked_array__``
dicts; ``msgpack_serialize`` writes the same format (flax's
``serialization.to_bytes`` reads it back).  ``params_from_jax`` turns the
flax tree (numpy leaves) into the port's
``NeuralDF`` state dict: a flax Dense ``kernel`` is (in, out), a torch Linear
``weight`` is (out, in).  ``encoder_from_jax`` and ``decoder_from_jax`` do
the same for the VAE (``nn/vae.py``): convolution kernels HWIO -> OIHW, the
transposed convolutions' flipped (kh, kw, in, out) kernels -> torch's
unflipped (in, out, kh, kw), BatchNorm scale / bias / batch_stats -> weight
/ bias / running statistics, and the head rows from flax's (h, w, c) flatten
order to torch's (c, h, w); ``vae_from_jax`` the whole Vae.
``opt_state_from_jax`` carries optax's AdamW state across to torch's.
``params_to_jax``, ``encoder_to_jax`` and ``decoder_to_jax`` go the other
way, for the artifacts the training pipelines write.  ``load_prod_sdf``,
``load_prod_encoder`` and ``load_prod_decoder`` read the trained networks.
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


class _Writer:
    """Minimal msgpack encoder: what flax's ``msgpack_serialize`` writes for
    a tree of dicts, lists, scalars, strings and numpy arrays."""

    def __init__(self):
        self.out = bytearray()

    def _head(self, n: int, fix: int, fix_max: int, codes):
        if fix is not None and n <= fix_max:
            self.out.append(fix | n)
        elif n < 1 << 8 and codes[0] is not None:
            self.out += struct.pack(">BB", codes[0], n)
        elif n < 1 << 16:
            self.out += struct.pack(">BH", codes[1], n)
        else:
            self.out += struct.pack(">BI", codes[2], n)

    def _int(self, v: int):
        if 0 <= v <= 0x7F or -32 <= v < 0:
            self.out += struct.pack(">b" if v < 0 else ">B", v)
            return
        kinds = ((">BB", 0xCC, 0, 1 << 8), (">BH", 0xCD, 0, 1 << 16), (">BI", 0xCE, 0, 1 << 32),
                 (">BQ", 0xCF, 0, 1 << 64)) if v > 0 else (
                 (">Bb", 0xD0, -(1 << 7), 1), (">Bh", 0xD1, -(1 << 15), 1),
                 (">Bi", 0xD2, -(1 << 31), 1), (">Bq", 0xD3, -(1 << 63), 1))
        for fmt, code, lo, hi in kinds:
            if lo <= v < hi:
                self.out += struct.pack(fmt, code, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")

    def _ext(self, code: int, payload: bytes):
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            self.out.append(fixext[n])
        else:
            self._head(n, None, 0, (0xC7, 0xC8, 0xC9))
        self.out += struct.pack(">b", code) + payload

    def write(self, v):
        if v is None or isinstance(v, bool):
            self.out.append({None: 0xC0, False: 0xC2, True: 0xC3}[v])
        elif isinstance(v, int):
            self._int(v)
        elif isinstance(v, float):
            self.out += struct.pack(">Bd", 0xCB, v)
        elif isinstance(v, str):
            b = v.encode("utf-8")
            self._head(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
            self.out += b
        elif isinstance(v, (bytes, bytearray)):
            self._head(len(v), None, 0, (0xC4, 0xC5, 0xC6))
            self.out += v
        elif isinstance(v, dict):
            self._head(len(v), 0x80, 15, (None, 0xDE, 0xDF))
            for k, x in v.items():
                self.write(k)
                self.write(x)
        elif isinstance(v, (list, tuple)):
            self._head(len(v), 0x90, 15, (None, 0xDC, 0xDD))
            for x in v:
                self.write(x)
        elif isinstance(v, (np.ndarray, np.generic)):
            a = np.asarray(v)
            if a.nbytes > _MAX_CHUNK:
                raise ValueError(f"an array of {a.nbytes} bytes needs flax's chunked layout")
            payload = _Writer()
            payload.write([list(a.shape), a.dtype.name, np.ascontiguousarray(a).tobytes()])
            self._ext(3 if isinstance(v, np.generic) else 1, bytes(payload.out))
        else:
            raise TypeError(f"cannot write {type(v).__name__} as flax msgpack")


_MAX_CHUNK = 2 ** 30 - 2  # flax's MAX_CHUNK_SIZE: larger arrays are split, not written here


def msgpack_serialize(tree) -> bytes:
    """Flax msgpack bytes of a tree of dicts (string keys) and arrays
    (numpy or torch; torch tensors are taken to the CPU), as flax's
    ``serialization.to_bytes`` writes it."""

    def plain(t):
        if isinstance(t, dict):
            return {str(k): plain(v) for k, v in t.items()}
        if isinstance(t, torch.Tensor):
            return t.detach().cpu().numpy()
        return t

    w = _Writer()
    w.write(plain(tree))
    return bytes(w.out)


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


def params_to_jax(state: dict) -> dict:
    """Flax variables ``{'params': ...}`` (numpy) of a NeuralDF state dict:
    the inverse of ``params_from_jax``."""
    to_np = lambda t: t.detach().cpu().numpy()
    return {"params": {name: {"kernel": np.ascontiguousarray(to_np(state[f"{name}.weight"]).T),
                              "bias": to_np(state[f"{name}.bias"])} for name in _LAYERS}}


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


def _nest(tree: dict, path, leaf):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def vae_state_to_jax(state: dict, heads=(), side="in", chw=(0, 0, 0)) -> dict:
    """Flax tree (``params``, and ``batch_stats`` with batch norm; numpy
    leaves) of a port VAE part's state dict: the inverse of
    ``vae_state_from_jax``."""
    C, H, W = chw
    out: dict = {"params": {}}
    for key, t in state.items():
        layer, leaf = key.rsplit(".", 1)
        path = tuple(layer.split("."))
        a = t.detach().cpu().numpy()
        norm = f"{layer}.running_mean" in state
        if leaf in ("running_mean", "running_var"):
            _nest(out.setdefault("batch_stats", {}), path + (leaf[len("running_"):],), a)
            continue
        if leaf == "num_batches_tracked":
            continue
        head = path[-1] in heads
        if leaf == "weight" and norm:
            name = "scale"
        elif leaf == "weight" and a.ndim == 4 and path[-1].startswith("ConvTransposeTorch"):
            a, name = a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1), "kernel"
        elif leaf == "weight" and a.ndim == 4:
            a, name = a.transpose(2, 3, 1, 0), "kernel"  # OIHW -> HWIO
        elif leaf == "weight":
            a, name = a.T, "kernel"
            if head and side == "in":  # rows (c, h, w) -> (h, w, c)
                a = a.reshape(C, H * W, -1).transpose(1, 0, 2).reshape(H * W * C, -1)
            elif head:  # columns
                a = a.reshape(-1, C, H * W).transpose(0, 2, 1).reshape(-1, H * W * C)
        elif leaf == "bias":
            name = "bias"
            if head and side == "out":
                a = a.reshape(C, H * W).T.reshape(-1)
        else:
            raise ValueError(f"unknown VAE state entry {key}")
        _nest(out["params"], path + (name,), np.ascontiguousarray(a))
    return out


def encoder_to_jax(state: dict) -> dict:
    """Flax Encoder tree of an ``Encoder`` state dict (inverse of
    ``encoder_from_jax``)."""
    return vae_state_to_jax(state, ("mean", "logvar"), "in", (512, 2, 2))


def decoder_to_jax(state: dict, unflatten_hw=(8, 15)) -> dict:
    """Flax Decoder tree of a ``Decoder`` state dict (inverse of
    ``decoder_from_jax``)."""
    return vae_state_to_jax(state, ("Dense_0",), "out", (512, *unflatten_hw))


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


def load_prod_decoder(weights_dir=None, device="cuda"):
    """The trained VAE decoder (``weights/vae_decoder.msgpack``, flax's
    tree) in eval mode on ``device``, or None if absent; its image shape
    and batch norm from the meta."""
    from .vae import Decoder

    dev = resolve_device(device)
    d = Path(weights_dir) if weights_dir else WEIGHTS_DIR
    meta = _meta(d)
    if meta is None or not (d / "vae_decoder.msgpack").exists():
        return None
    module = Decoder(1, meta["size_latent"], (1, *meta_img_shape(meta)), dropout_rate=0.0,
                     batchnorm=bool(meta.get("batchnorm", False)))
    module.load_state_dict(decoder_from_jax(msgpack_restore(
        (d / "vae_decoder.msgpack").read_bytes())))
    return module.eval().to(dev)

