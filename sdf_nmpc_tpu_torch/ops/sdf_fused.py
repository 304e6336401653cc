"""Kernel 2: NeuralDF value + position gradient (``sdf_value_grad``).

Counterpart of sdf_nmpc_tpu/ops/sdf_fused.py ``_kernel`` (:154) in its four
modes, with the host prep of ``pack_neural_df_params`` (:44) and
``_embed_with_tangents`` (:103).  One pass evaluates the stacked rows

    rows = [primal; tangent_x; tangent_y; tangent_z]

through every dense layer: Z = rows @ W, H = act(Z_p + b), dH = act'(Z_p + b)
* Z_t, with the res='full' re-concat of the input rows applied to primal and
tangent rows alike.  The embedding and its analytic tangent basis are
computed here on the host side (``embed_with_tangents``): emb = [x, sin(xb),
cos(xb)] with xb = (x @ dirs) kron freqs, demb_k = [e_k, cos(xb) J_k,
-sin(xb) J_k].  It uses cos(xb) where the plain module computes
sin(xb + pi/2); in f32 the two differ for large |xb|, so this path mirrors
the JAX kernel path and ``NeuralDF.forward`` mirrors ``module.apply``.

``sdf_value_grad`` takes the solver's ``sdf_fused_dtype`` as ``mode``, the
four modes of the JAX kernel (``MODES``):

- ``f32`` (the JAX kernel's HIGHEST products): on a CUDA tensor it launches
  ``csrc/sdf_fused.cu``, IEEE f32 on the CUDA cores;
- ``f32x3`` (the solver's default; the JAX kernel's ``_dot3``, a bf16x3 split
  on the MXU): on a CUDA tensor it launches ``csrc/sdf_fused_x3.cu``, the
  tensor-core counterpart, a 3xTF32 split whose plain version is
  ``sdf_value_grad_x3_plain`` (the same rounding and grouping in torch f32
  matmuls);
- ``bf16`` (every product, the head's included, of bf16-rounded operands)
  and ``mixed`` (the primal rows exact, the tangent rows so): on a CUDA
  tensor they launch ``csrc/sdf_fused_bf16.cu`` on the bf16 tensor cores,
  whose plain versions are ``sdf_value_grad_bf16_plain`` and
  ``sdf_value_grad_mixed_plain``;
- on a CPU tensor, every mode runs the exact plain version
  ``sdf_value_grad_plain``, as the JAX package runs its autodiff path off the
  TPU (``make_fused_sdf_vg`` returns None there), so no CPU result depends
  on the mode.  ``PLAIN`` maps each mode to its plain version.
"""

from __future__ import annotations

import torch

from ..nn.embeddings import PositionEmbedding
from ..utils.device_consts import kept
from . import _lib

MODES = ("f32", "f32x3", "bf16", "mixed")
_ACT_CODES = {"sin": 0, "relu": 1, "softplus": 2}
_HID = 256  # the kernels' padded hidden width
_KC = 16  # every kernel's chunk rows (weights) and columns (inputs)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_neural_df_params(module, dtype=None) -> dict:
    """The NeuralDF's dense weights in (in, out) layout, plus layout metadata.
    ``dtype`` casts the weights (default: the module's own)."""
    if module.res != "full":
        raise NotImplementedError("the fused value+grad path supports res='full'")
    cast = (lambda t: t.detach().to(dtype)) if dtype is not None else (lambda t: t.detach())
    layers = (module.main1_0, module.main1_1, module.main2_0, module.main2_1, module.df)
    packed = {}
    for i, lin in enumerate(layers, start=1):
        packed[f"W{i}"] = cast(lin.weight).t().contiguous()
        packed[f"b{i}"] = cast(lin.bias).contiguous()
    packed.update(
        nemb=module.nb_embeddings, L=module.size_latent,
        in1=module.nb_embeddings + module.size_latent, sizes=module.layer_sizes,
        w0=float(module.w0), act=module.act, embed_fn=module.embed_fn,
    )
    return packed


def embed_with_tangents(embed_fn, pos):
    """(emb (P, nemb), demb (P, 3, nemb)): embedding and its tangent basis."""
    P = pos.shape[0]
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device).expand(P, 3, 3)
    if embed_fn is None:
        return pos, eye
    if not isinstance(embed_fn, PositionEmbedding):
        raise TypeError(f"unsupported embedding {type(embed_fn).__name__}")
    dirs, freqs = kept(embed_fn.dirs, pos), kept(embed_fn.freq_bands, pos)  # (3, nd), (nf,)
    proj = pos @ dirs  # (P, nd)
    xb = (proj[..., None] * freqs).reshape(P, -1)  # (P, nd*nf)
    s, c = torch.sin(xb), torch.cos(xb)
    emb = torch.cat([pos, s, c], dim=-1)
    J = (dirs[:, :, None] * freqs).reshape(3, -1)  # (3, nd*nf)
    demb = torch.cat([eye, c[:, None, :] * J, -s[:, None, :] * J], dim=-1)
    return emb, demb


def _act_pair(z, act: str, w0: float):
    """(act(z), act'(z))."""
    if act == "sin":
        return torch.sin(w0 * z), w0 * torch.cos(w0 * z)
    if act == "relu":
        return torch.clamp(z, min=0.0), (z > 0).to(z.dtype)
    if act == "softplus":
        return torch.nn.functional.softplus(z), torch.sigmoid(z)
    raise ValueError(act)


def _value_grad(packed, pos, latent, mm, mm_t=None, head=None):
    """The stacked-tangent pass with ``mm(A, i)`` for the products of dense
    layer i (1-4) on the primal rows and ``mm_t(A, i)`` on the tangent rows
    (default: ``mm``); ``head(A, tangent)`` for the head's products (default:
    exact f32)."""
    mm_t = mm_t or mm
    head = head or (lambda A, tangent: A @ packed["W5"])
    emb, demb = embed_with_tangents(packed["embed_fn"], pos)
    P0 = torch.cat([emb, latent], dim=-1)  # (P, in1)
    T0 = torch.cat([demb, demb.new_zeros(demb.shape[:2] + (latent.shape[-1],))], dim=-1)
    act, w0 = packed["act"], packed["w0"]

    def dense_pair(Pr, T, i):
        h, hp = _act_pair(mm(Pr, i) + packed[f"b{i}"], act, w0)
        return h, hp[:, None, :] * mm_t(T, i)

    H, T = dense_pair(P0, T0, 1)
    H, T = dense_pair(H, T, 2)
    H, T = dense_pair(torch.cat([H, P0], -1), torch.cat([T, T0], -1), 3)
    H, T = dense_pair(H, T, 4)
    df = head(H, False) + packed["b5"]
    return df[:, 0], head(T, True)[..., 0]


def sdf_value_grad_plain(packed, pos, latent):
    """pos (P, 3), latent (P, L) -> (df (P,), grad (P, 3)), exact products."""
    return _value_grad(packed, pos, latent, lambda A, i: A @ packed[f"W{i}"])


def tf32_round(x):
    """x (float32) rounded to TF32, 10 mantissa bits, to nearest with ties
    away from zero: the rounding of ``cvt.rna.tf32.f32``."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32(x):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _x3_split(packed, i):
    """(W_hi, W_lo) of dense layer i (cached on ``packed``)."""
    cache = packed.setdefault("_x3_plain", {})
    if i not in cache:
        cache[i] = _split_tf32(packed[f"W{i}"].to(torch.float32))
    return cache[i]


def sdf_value_grad_x3_plain(packed, pos, latent):
    """pos (P, 3), latent (P, L) f32 -> (df (P,), grad (P, 3)) in the
    kernel's 3xTF32 numerics: each product of dense layers 1-4 is
    A_hi W_hi + (A_hi W_lo + A_lo W_hi) with hi = tf32(a), lo = tf32(a - hi),
    the grouping of the JAX kernel's ``_dot3`` (which the kernel keeps
    8-deep step by step), in f32 matmuls; bias, activation and head in
    f32."""
    def mm3(A, i):
        hi, lo = _split_tf32(A)
        w_hi, w_lo = _x3_split(packed, i)
        return hi @ w_hi + (hi @ w_lo + lo @ w_hi)

    return _value_grad(packed, pos, latent, mm3)


def bf16_round(x):
    """x rounded to bfloat16 to nearest even (``cvt.rn.bf16x2.f32``, JAX's
    ``astype``), in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _bf16_weight(packed, i):
    """W_i (i = 1-5) rounded to bf16 (cached on ``packed``)."""
    cache = packed.setdefault("_bf16_plain", {})
    if i not in cache:
        cache[i] = bf16_round(packed[f"W{i}"])
    return cache[i]


def sdf_value_grad_bf16_plain(packed, pos, latent):
    """pos (P, 3), latent (P, L) f32 -> (df (P,), grad (P, 3)) in the bf16
    mode's numerics: both operands of every product, the head's included,
    rounded to bf16 (nearest even), then f32 matmuls; bias, activation and
    act' in f32."""
    mm = lambda A, i: bf16_round(A) @ _bf16_weight(packed, i)
    return _value_grad(packed, pos, latent, mm, head=lambda A, tangent: mm(A, 5))


def sdf_value_grad_mixed_plain(packed, pos, latent):
    """As ``sdf_value_grad_bf16_plain`` for the tangent rows only: the primal
    rows' products, the head's included, are exact f32."""
    exact = lambda A, i: A @ packed[f"W{i}"]
    rounded = lambda A, i: bf16_round(A) @ _bf16_weight(packed, i)
    return _value_grad(packed, pos, latent, exact, mm_t=rounded,
                       head=lambda A, tangent: (rounded if tangent else exact)(A, 5))


PLAIN = {"f32": sdf_value_grad_plain, "f32x3": sdf_value_grad_x3_plain,
         "bf16": sdf_value_grad_bf16_plain, "mixed": sdf_value_grad_mixed_plain}


def _kernel_weights(packed) -> dict:
    """sdf_fused.cu's weights, zero-padded (cached on ``packed``): hidden
    widths to 256, the input width to a multiple of the chunk's 16 columns,
    and W3's rows split as [h (256) | input rows (in1p)].  Zero pads are
    inert."""
    if "_kernel" in packed:
        return packed["_kernel"]
    if any(s > _HID for s in packed["sizes"]):
        raise ValueError(f"the sdf kernel takes hidden widths <= {_HID}, got {packed['sizes']}")
    in1, in1p = packed["in1"], _round_up(packed["in1"], _KC)
    s1 = packed["sizes"][1]
    dev = packed["W1"].device

    def pad(w, rows, cols):
        out = torch.zeros(rows, cols, dtype=torch.float32, device=dev)
        out[: w.shape[0], : w.shape[1]] = w
        return out

    def padb(b):
        out = torch.zeros(_HID, dtype=torch.float32, device=dev)
        out[: b.shape[0]] = b
        return out

    W3 = torch.zeros(_HID + in1p, _HID, dtype=torch.float32, device=dev)
    W3[:s1, : packed["W3"].shape[1]] = packed["W3"][:s1]
    W3[_HID : _HID + in1, : packed["W3"].shape[1]] = packed["W3"][s1:]
    kw = dict(
        W1=pad(packed["W1"], in1p, _HID), b1=padb(packed["b1"]),
        W2=pad(packed["W2"], _HID, _HID), b2=padb(packed["b2"]),
        W3=W3, b3=padb(packed["b3"]),
        W4=pad(packed["W4"], _HID, _HID), b4=padb(packed["b4"]),
        w5=padb(packed["W5"][:, 0]), b5=packed["b5"].to(torch.float32).contiguous(),
        in1p=in1p,
    )
    packed["_kernel"] = kw
    return kw


def _sdf_value_grad_cuda(packed, pos, latent):
    with _lib.launch("sdf_fused"):
        P = pos.shape[0]
        kw = _kernel_weights(packed)
        emb, demb = embed_with_tangents(packed["embed_fn"], pos)
        emb, demb = emb.contiguous(), demb.contiguous()
        weights = [kw[k] for k in ("W1", "b1", "W2", "b2", "W3", "b3", "W4", "b4", "w5", "b5")]
        _lib.require_cuda_f32("sdf_value_grad", pos, latent, emb, demb, *weights)
        _lib.require_shape("sdf_value_grad pos", pos, (P, 3))
        _lib.require_shape("sdf_value_grad latent", latent, (P, packed["L"]))
        df = torch.empty(P, dtype=torch.float32, device=pos.device)
        grad = torch.empty(P, 3, dtype=torch.float32, device=pos.device)
        err = _lib.library().sdf_fused_launch(
            *[t.data_ptr() for t in (emb, demb, latent, *weights, df, grad)],
            P, packed["nemb"], packed["L"], kw["in1p"], _ACT_CODES[packed["act"]],
            packed["w0"], _lib.stream_ptr())
        _lib.check(err, "sdf_value_grad")
        return df, grad


def sdf_fused_geometry() -> dict:
    """The f32 kernel's launch on the current card: threads per block,
    dynamic shared bytes per block, resident blocks per SM."""
    return _lib.geometry("sdf_fused_geometry")


def _chunk_sequence(packed):
    """(W (16 n_chunks, 256), nxe, nxl): the four dense layers as the tensor-
    core kernels read them, one sequence of 16-row chunks zero-padded to width
    256, the input rows of layers 1 and 3 as [embedding, padded to a multiple
    of 16 (nxe chunks) | latent, likewise (nxl chunks)]."""
    if any(s > _HID for s in packed["sizes"]):
        raise ValueError(f"the sdf kernel takes hidden widths <= {_HID}, got {packed['sizes']}")
    nemb, L, s1 = packed["nemb"], packed["L"], packed["sizes"][1]
    ke, kl = _round_up(nemb, _KC), _round_up(L, _KC)
    dev = packed["W1"].device

    def block(w, rows):
        out = torch.zeros(rows, _HID, dtype=torch.float32, device=dev)
        out[: w.shape[0], : w.shape[1]] = w
        return out

    def inputs(w):  # rows [embedding | latent] at their padded offsets
        return torch.cat([block(w[:nemb], ke), block(w[nemb:], kl)])

    W = torch.cat([inputs(packed["W1"]), block(packed["W2"], _HID),
                   block(packed["W3"][:s1], _HID), inputs(packed["W3"][s1:]),
                   block(packed["W4"], _HID)])
    return W, ke // _KC, kl // _KC


def _head_weights(packed) -> dict:
    """The biases as (4, 256), the head padded to 256 and its bias."""
    dev = packed["W1"].device

    def pad(v):
        out = torch.zeros(_HID, dtype=torch.float32, device=dev)
        out[: v.shape[0]] = v
        return out

    return dict(bias=torch.stack([pad(packed[f"b{i}"]) for i in range(1, 5)]),
                w5=pad(packed["W5"][:, 0]), b5=packed["b5"].to(torch.float32).contiguous())


def _x3_weights(packed) -> dict:
    """sdf_fused_x3.cu's weights (cached on ``packed``): ``_chunk_sequence``
    split once into W_hi = tf32(W) and W_lo = tf32(W - W_hi) (the split of
    ``sdf_value_grad_x3_plain``), and ``_head_weights``.

    ``W`` (n_chunks, 256 * 32) is the chunks as the kernel reads them: per
    output column n, 32 words, per 8-row block kb at slot kb ^ (n % 2) and
    per lane t of a quad [hi(t), hi(t + 4), lo(t), lo(t + 4)] (rows of the
    block), so that one 16-byte load gives a lane its B fragments."""
    if "_x3" in packed:
        return packed["_x3"]
    W, nxe, nxl = _chunk_sequence(packed)
    hi, lo = (t.view(-1, 2, 2, 4, _HID) for t in _split_tf32(W))  # chunk, kb, row // 4, row % 4, n
    lanes = torch.stack([hi[:, :, 0], hi[:, :, 1], lo[:, :, 0], lo[:, :, 1]], -1)
    lanes = lanes.permute(0, 3, 1, 2, 4)  # chunk, n, kb, t, 4
    lanes[:, 1::2] = lanes[:, 1::2].flip(2)  # odd columns: the 8-row blocks swap slots
    kw = dict(W=lanes.reshape(lanes.shape[0], -1).contiguous(), nxe=nxe, nxl=nxl,
              **_head_weights(packed))
    packed["_x3"] = kw
    return kw


# the rows of a 16-row chunk in the order sdf_fused_bf16.cu reads them per
# column: lane t of a quad takes rows (2t, 2t + 1, 2t + 8, 2t + 9)
_BF16_ROWS = (0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15)


def _bf16_weights(packed) -> dict:
    """sdf_fused_bf16.cu's weights (cached on ``packed``): ``_chunk_sequence``
    rounded to bf16 as ``Wb`` (n_chunks, 256, 16), per output column the 16
    rows in ``_BF16_ROWS`` order, so that one 8-byte load gives a lane its B
    fragment; the same chunks in f32, row-major, as ``Wf`` (n_chunks, 16, 256)
    for the mixed mode's primal products; ``_head_weights`` and the head
    rounded to bf16, ``w5r``."""
    if "_bf16" in packed:
        return packed["_bf16"]
    W, nxe, nxl = _chunk_sequence(packed)
    Wf = W.view(-1, _KC, _HID)
    Wb = Wf.to(torch.bfloat16)[:, list(_BF16_ROWS)].transpose(1, 2).contiguous()
    head = _head_weights(packed)
    kw = dict(Wb=Wb, Wf=Wf.contiguous(), nxe=nxe, nxl=nxl, w5r=bf16_round(head["w5"]), **head)
    packed["_bf16"] = kw
    return kw


def _sdf_value_grad_x3_cuda(packed, pos, latent):
    with _lib.launch("sdf_fused_x3"):
        P = pos.shape[0]
        kw = _x3_weights(packed)
        emb, demb = embed_with_tangents(packed["embed_fn"], pos)
        emb, demb = emb.contiguous(), demb.contiguous()
        weights = [kw[k] for k in ("W", "bias", "w5", "b5")]
        _lib.require_cuda_f32("sdf_value_grad", pos, latent, emb, demb, *weights)
        _lib.require_shape("sdf_value_grad pos", pos, (P, 3))
        _lib.require_shape("sdf_value_grad latent", latent, (P, packed["L"]))
        df = torch.empty(P, dtype=torch.float32, device=pos.device)
        grad = torch.empty(P, 3, dtype=torch.float32, device=pos.device)
        err = _lib.library().sdf_fused_x3_launch(
            *[t.data_ptr() for t in (emb, demb, latent, *weights, df, grad)],
            P, packed["nemb"], packed["L"], kw["nxe"], kw["nxl"], _ACT_CODES[packed["act"]],
            packed["w0"], _lib.stream_ptr())
        _lib.check(err, "sdf_value_grad (f32x3)")
        return df, grad


def sdf_fused_x3_geometry() -> dict:
    """The f32x3 kernel's launch on the current card: threads per block,
    dynamic shared bytes per block, resident blocks per SM."""
    return _lib.geometry("sdf_fused_x3_geometry")


def _sdf_value_grad_bf16_cuda(packed, pos, latent, mode):
    with _lib.launch(f"sdf_fused_{mode}"):
        P = pos.shape[0]
        mixed = mode == "mixed"
        kw = _bf16_weights(packed)
        emb, demb = embed_with_tangents(packed["embed_fn"], pos)
        emb, demb = emb.contiguous(), demb.contiguous()
        Wb, Wf = kw["Wb"], kw["Wf"] if mixed else None
        f32 = [kw[k] for k in ("bias", "w5", "w5r", "b5")] + ([Wf] if mixed else [])
        _lib.require_cuda_f32(f"sdf_value_grad ({mode})", pos, latent, emb, demb, *f32)
        if Wb.device != pos.device or Wb.dtype != torch.bfloat16 or not Wb.is_contiguous():
            raise ValueError(f"sdf_value_grad ({mode}): the bf16 weights are not a contiguous "
                             f"bfloat16 tensor on {pos.device}")
        _lib.require_shape("sdf_value_grad pos", pos, (P, 3))
        _lib.require_shape("sdf_value_grad latent", latent, (P, packed["L"]))
        df = torch.empty(P, dtype=torch.float32, device=pos.device)
        grad = torch.empty(P, 3, dtype=torch.float32, device=pos.device)
        err = _lib.library().sdf_fused_bf16_launch(
            emb.data_ptr(), demb.data_ptr(), latent.data_ptr(), Wb.data_ptr(),
            Wf.data_ptr() if mixed else None,
            *[kw[k].data_ptr() for k in ("bias", "w5", "w5r", "b5")], df.data_ptr(),
            grad.data_ptr(),
            P, packed["nemb"], packed["L"], kw["nxe"], kw["nxl"], int(mixed),
            _ACT_CODES[packed["act"]], packed["w0"], _lib.stream_ptr())
        _lib.check(err, f"sdf_value_grad ({mode})")
        return df, grad


def sdf_fused_bf16_geometry(mode, packed) -> dict:
    """The bf16 or mixed kernel's launch for ``packed``'s network on the
    current card (its shared memory holds the tile's input rows): threads per
    block, dynamic shared bytes per block, resident blocks per SM."""
    return _lib.geometry("sdf_fused_bf16_geometry", int(mode == "mixed"), packed["nemb"],
                         packed["L"])


def sdf_value_grad(packed, pos, latent, mode="f32"):
    """pos (P, 3), latent (P, L) -> (df (P,), grad (P, 3)).  On CUDA tensors
    the kernel of ``mode`` (``f32``: sdf_fused.cu, ``f32x3``: sdf_fused_x3.cu,
    ``bf16`` and ``mixed``: sdf_fused_bf16.cu); on CPU tensors the exact plain
    version, whatever the mode."""
    if mode not in MODES:
        raise ValueError(f"sdf_value_grad mode {mode!r}: one of {MODES}")
    if pos.is_cuda:
        if mode == "f32x3":
            return _sdf_value_grad_x3_cuda(packed, pos, latent)
        if mode in ("bf16", "mixed"):
            return _sdf_value_grad_bf16_cuda(packed, pos, latent, mode)
        return _sdf_value_grad_cuda(packed, pos, latent)
    return sdf_value_grad_plain(packed, pos, latent)
