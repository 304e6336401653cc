"""Kernel 2 (sdf_value_grad): the plain stacked-tangent version against the
JAX Pallas kernel (interpret mode, f32) and the JAX autodiff oracle (f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_net, one_torch_thread, port_net, t32, t64  # noqa: F401  (fixtures)

RNG = np.random.default_rng(17)


def _points(B, L):
    return RNG.normal(size=(B, 3)), RNG.normal(size=(B, L)) * 0.3


@pytest.mark.parametrize("embed,act", [("pos", "sin"), ("oct", "sin"), ("pos", "relu"),
                                       ("ico", "softplus")])
def test_plain_f32_matches_pallas_kernel_interpret(embed, act):
    """The JAX kernel tests' tolerances (tests/test_ops.py): value 2e-4,
    gradient 2e-3; both sides compute the embedding tangents as cos(xb)."""
    from sdf_nmpc_tpu.ops import make_fused_sdf
    from sdf_nmpc_tpu_torch.ops.sdf_fused import pack_neural_df_params, sdf_value_grad

    module, variables = jax_net(embed=embed, act=act, w0=2.0, seed=1)
    fused = jax.jit(make_fused_sdf(module, variables, tile=8, interpret=True, dtype="f32"))
    net = port_net(module, variables, dtype=torch.float32)
    pos, lat = (a.astype(np.float32) for a in _points(13, 16))
    df_j, gr_j = fused(jnp.asarray(pos), jnp.asarray(lat))
    df_t, gr_t = sdf_value_grad(pack_neural_df_params(net), t32(pos), t32(lat))
    np.testing.assert_allclose(df_t.numpy(), np.asarray(df_j), atol=2e-4)
    np.testing.assert_allclose(gr_t.numpy(), np.asarray(gr_j), atol=2e-3)


@pytest.mark.parametrize("embed,act", [("oct", "sin"), ("none", "sin"), ("cube", "relu"),
                                       ("dod", "softplus")])
def test_plain_f64_matches_jax_autodiff(embed, act):
    """f64 against vmap(value_and_grad(module.apply)): the analytic stacked
    tangents equal reverse-mode AD; the embedding's cos(xb) against the
    module's sin(xb + pi/2) differs at 1e-16 |xb| in f64, hence 1e-10."""
    from sdf_nmpc_tpu.ops import reference_value_and_grad
    from sdf_nmpc_tpu_torch.ops.sdf_fused import pack_neural_df_params, sdf_value_grad

    module, variables = jax_net(embed=embed, act=act, w0=3.0, seed=6)
    v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    pos, lat = _points(20, 16)
    df_j, gr_j = jax.jit(reference_value_and_grad(module, v64))(jnp.asarray(pos),
                                                                 jnp.asarray(lat))
    net = port_net(module, variables)
    df_t, gr_t = sdf_value_grad(pack_neural_df_params(net), t64(pos), t64(lat))
    np.testing.assert_allclose(df_t.numpy(), np.asarray(df_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(gr_t.numpy(), np.asarray(gr_j), rtol=1e-10, atol=1e-10)


def test_kernel_weight_layout_is_inert_padding():
    """The CUDA kernel's padded weights (hidden width 256, the input width
    padded to its 16-column chunks, W3 rows split as [h | input]) reproduce
    the unpadded products exactly."""
    from sdf_nmpc_tpu_torch.ops.sdf_fused import _kernel_weights, pack_neural_df_params

    module, variables = jax_net(embed="oct", act="sin", w0=2.0, seed=1)
    packed = pack_neural_df_params(port_net(module, variables, dtype=torch.float32))
    kw = _kernel_weights(packed)
    in1, in1p, s1 = packed["in1"], kw["in1p"], packed["sizes"][1]
    assert in1p % 16 == 0 and in1p - in1 < 16 and kw["W3"].shape == (256 + in1p, 256)
    h = torch.randn(5, s1)
    x0 = torch.randn(5, in1)
    want = torch.cat([h, x0], -1) @ packed["W3"]
    hp = torch.zeros(5, 256)
    hp[:, :s1] = h
    xp = torch.zeros(5, in1p)
    xp[:, :in1] = x0
    got = (torch.cat([hp, xp], -1) @ kw["W3"])[:, : want.shape[1]]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)



@pytest.mark.parametrize("embed,act", [("pos", "sin"), ("oct", "sin"), ("pos", "relu"),
                                       ("ico", "softplus")])
def test_plain_x3_matches_pallas_kernel_interpret_f32x3(embed, act):
    """The 3xTF32 plain version against the JAX kernel in its f32x3 mode
    (bf16x3 on the MXU; in interpret mode on the CPU), at the f32 test's
    tolerances: value 2e-4, gradient 2e-3.  Measured 2.3e-5 / 1.3e-4 at most
    here: the JAX mode's bf16 parts carry 16 bits of each operand, the TF32
    parts about 22."""
    from sdf_nmpc_tpu.ops import make_fused_sdf
    from sdf_nmpc_tpu_torch.ops.sdf_fused import pack_neural_df_params, sdf_value_grad_x3_plain

    module, variables = jax_net(embed=embed, act=act, w0=2.0, seed=1)
    fused = jax.jit(make_fused_sdf(module, variables, tile=8, interpret=True, dtype="f32x3"))
    net = port_net(module, variables, dtype=torch.float32)
    pos, lat = (a.astype(np.float32) for a in _points(13, 16))
    df_j, gr_j = fused(jnp.asarray(pos), jnp.asarray(lat))
    df_t, gr_t = sdf_value_grad_x3_plain(pack_neural_df_params(net), t32(pos), t32(lat))
    np.testing.assert_allclose(df_t.numpy(), np.asarray(df_j), atol=2e-4)
    np.testing.assert_allclose(gr_t.numpy(), np.asarray(gr_j), atol=2e-3)


@pytest.mark.parametrize("embed,act", [("pos", "sin"), ("oct", "sin"), ("pos", "relu"),
                                       ("ico", "softplus"), ("none", "sin"), ("cube", "relu"),
                                       ("dod", "softplus")])
def test_plain_x3_error_against_f64_autodiff(embed, act):
    """Both f32 plain versions against vmap(value_and_grad(module.apply)) in
    f64 on the same (f32) inputs and weights.  The 3xTF32 split carries each
    operand to 2^-22 and drops a lo*lo term of 2^-22, two to four f32
    roundings (2^-24) per product beside the same f32 accumulation, so its
    largest error is held to 4 times the IEEE plain version's (+ 1e-7).
    Measured at most 1.5 times here (the JAX f32x3 mode: 20-60 times)."""
    from sdf_nmpc_tpu.ops import reference_value_and_grad
    from sdf_nmpc_tpu_torch.ops.sdf_fused import (
        pack_neural_df_params,
        sdf_value_grad_plain,
        sdf_value_grad_x3_plain,
    )

    module, variables = jax_net(embed=embed, act=act, w0=2.0, seed=1)
    net = port_net(module, variables, dtype=torch.float32)
    packed = pack_neural_df_params(net)
    pos, lat = (a.astype(np.float32) for a in _points(64, 16))
    v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32), jnp.float64), variables)
    ref = jax.jit(reference_value_and_grad(module, v64))(jnp.asarray(pos, jnp.float64),
                                                         jnp.asarray(lat, jnp.float64))
    x3 = sdf_value_grad_x3_plain(packed, t32(pos), t32(lat))
    f32 = sdf_value_grad_plain(packed, t32(pos), t32(lat))
    for name, a, b, r in zip(("value", "gradient"), x3, f32, ref):
        r = np.asarray(r)
        e_x3 = np.abs(a.double().numpy() - r).max()
        e_f32 = np.abs(b.double().numpy() - r).max()
        assert e_x3 <= 4 * e_f32 + 1e-7, (name, e_x3, e_f32)


@pytest.mark.parametrize("mode", ["f32", "f32x3", "bf16", "mixed"])
def test_cpu_route_is_the_exact_plain_version(mode):
    """On CPU tensors every mode returns the exact plain version bit for
    bit, as the JAX package runs its autodiff path off the TPU; a mode the
    JAX package does not have raises."""
    from sdf_nmpc_tpu_torch.ops.sdf_fused import (
        pack_neural_df_params,
        sdf_value_grad,
        sdf_value_grad_plain,
    )

    module, variables = jax_net(embed="oct", act="sin", w0=2.0, seed=1)
    packed = pack_neural_df_params(port_net(module, variables, dtype=torch.float32))
    pos, lat = (t32(a) for a in _points(9, 16))
    for got, want in zip(sdf_value_grad(packed, pos, lat, mode=mode),
                         sdf_value_grad_plain(packed, pos, lat)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="mode"):
        sdf_value_grad(packed, pos, lat, mode="f16")


@pytest.mark.parametrize("mode", ["bf16", "mixed"])
@pytest.mark.parametrize("embed,act", [("pos", "sin"), ("oct", "sin"), ("pos", "relu"),
                                       ("ico", "softplus")])
def test_plain_bf16_modes_match_pallas_kernel_interpret(mode, embed, act):
    """The bf16 and mixed plain versions against the JAX kernel in the same
    mode (interpret mode on the CPU, tile 8), f32, 64 points.  Direct, for
    each output of bf16 products (bf16: value and gradient; mixed: the
    gradient): the median within 1e-6 and the max within the JAX kernel's
    own largest distance to the f64 oracle; mixed's value (exact f32 rows)
    within 2e-4, the f32 test's tolerance.  A bf16 output is
    held so because a one-ulp difference of an f32 sum can round a
    next-layer input to the neighbouring bf16 value (2^-8 relative), which
    sin(w0 z) carries to the output: measured up to 1.8e-3 (value) and
    2.6e-2 (gradient) on one point, against the mode's own distance to f64
    of 8e-3 and 6e-2.  And the plain version's largest distance to the f64
    autodiff oracle (on the same f32 inputs and weights) at most 2 times the
    JAX kernel's own (measured 1.0 times)."""
    from sdf_nmpc_tpu.ops import make_fused_sdf, reference_value_and_grad
    from sdf_nmpc_tpu_torch.ops.sdf_fused import PLAIN, pack_neural_df_params

    module, variables = jax_net(embed=embed, act=act, w0=2.0, seed=1)
    fused = jax.jit(make_fused_sdf(module, variables, tile=8, interpret=True, dtype=mode))
    packed = pack_neural_df_params(port_net(module, variables, dtype=torch.float32))
    rng = np.random.default_rng(29)
    pos = rng.normal(size=(64, 3)).astype(np.float32)
    lat = (rng.normal(size=(64, 16)) * 0.3).astype(np.float32)
    v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32), jnp.float64), variables)
    ref = [np.asarray(r) for r in jax.jit(reference_value_and_grad(module, v64))(
        jnp.asarray(pos, jnp.float64), jnp.asarray(lat, jnp.float64))]
    jax_out = [np.asarray(o, np.float64) for o in fused(jnp.asarray(pos), jnp.asarray(lat))]
    plain = [o.double().numpy() for o in PLAIN[mode](packed, t32(pos), t32(lat))]
    for i, (p, j, r) in enumerate(zip(plain, jax_out, ref)):
        d, own = np.abs(p - j), np.abs(j - r).max()
        if mode == "mixed" and i == 0:
            np.testing.assert_allclose(p, j, atol=2e-4)
        else:
            assert np.median(d) <= 1e-6 and d.max() <= own, (np.median(d), d.max(), own)
        assert np.abs(p - r).max() <= 2 * own


def test_bf16_round_is_nearest_even():
    """bf16_round against a float64 reference: the nearest multiple of
    2^(e - 7), ties to the even neighbour, over random magnitudes and the
    exact ties; its low 16 bits are zero."""
    from sdf_nmpc_tpu_torch.ops.sdf_fused import bf16_round

    x = RNG.normal(size=4000) * 10.0 ** RNG.uniform(-6, 6, size=4000)
    m, e = np.frexp(x.astype(np.float32).astype(np.float64))  # |m| in [0.5, 1)
    ties = np.ldexp(np.sign(m) * (np.floor(np.abs(m) * 2 ** 8) + 0.5) / 2 ** 8, e)
    x = np.concatenate([x, ties]).astype(np.float32)
    m, e = np.frexp(x.astype(np.float64))
    q = np.abs(m) * 2 ** 8
    r = np.where(q - np.floor(q) == 0.5, 2 * np.round(q / 2), np.floor(q + 0.5))
    want = np.ldexp(np.sign(m) * r / 2 ** 8, e)
    got = bf16_round(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy().astype(np.float64), want)
    assert not (got.view(torch.int32) & 0xFFFF).any()


def test_tf32_round_is_nearest_ties_away():
    """tf32_round against a float64 reference: the nearest multiple of
    2^(e - 10), ties away from zero, over random magnitudes and the exact
    ties; its low 13 bits are zero."""
    from sdf_nmpc_tpu_torch.ops.sdf_fused import tf32_round

    x = RNG.normal(size=4000) * 10.0 ** RNG.uniform(-6, 6, size=4000)
    m, e = np.frexp(x.astype(np.float32).astype(np.float64))  # |m| in [0.5, 1)
    ties = np.ldexp(np.sign(m) * (np.floor(np.abs(m) * 2 ** 11) + 0.5) / 2 ** 11, e)
    x = np.concatenate([x, ties]).astype(np.float32)
    m, e = np.frexp(x.astype(np.float64))
    want = np.ldexp(np.sign(m) * np.floor(np.abs(m) * 2 ** 11 + 0.5) / 2 ** 11, e)
    got = tf32_round(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy().astype(np.float64), want)
    assert not (got.view(torch.int32) & 0x1FFF).any()


def test_x3_kernel_weight_layout_reproduces_the_plain_x3():
    """The f32x3 kernel's weights, read at the places the kernel reads its B
    fragments (column n, 8-row block kb at slot kb ^ (n % 2), lane t:
    [hi(t), hi(t + 4), lo(t), lo(t + 4)]), and walked in its
    chunk order (layer 1: the embedding chunks, all four row groups, then
    the latent chunks, primal rows only; layers 2 and 4: 16 activation
    chunks; layer 3: 16 activation chunks then the input chunks again), give
    the plain 3xTF32 version's value and gradient: the layout is inert
    padding and the split is the plain version's."""
    from sdf_nmpc_tpu_torch.ops.sdf_fused import (
        _act_pair,
        _split_tf32,
        _x3_weights,
        embed_with_tangents,
        pack_neural_df_params,
        sdf_value_grad_x3_plain,
    )

    module, variables = jax_net(embed="oct", act="sin", w0=2.0, seed=1)
    packed = pack_neural_df_params(port_net(module, variables, dtype=torch.float32))
    kw = _x3_weights(packed)
    n_chunks = kw["W"].shape[0]
    c, n, kb, t = np.meshgrid(np.arange(n_chunks), np.arange(256), np.arange(2), np.arange(4),
                              indexing="ij")
    at = c * 256 * 32 + n * 32 + (kb ^ (n % 2)) * 16 + 4 * t  # the kernel's 16-byte load
    flat, rows = kw["W"].reshape(-1), 16 * c + 8 * kb + t
    w_hi, w_lo = torch.zeros(16 * n_chunks, 256), torch.zeros(16 * n_chunks, 256)
    for word, (w, dr) in enumerate([(w_hi, 0), (w_hi, 4), (w_lo, 0), (w_lo, 4)]):
        w[torch.as_tensor(rows + dr), torch.as_tensor(n)] = flat[torch.as_tensor(at + word)]
    pos, lat = (t32(a) for a in _points(11, 16))
    P, nemb, L, KC = pos.shape[0], packed["nemb"], packed["L"], 16
    ke, kl = kw["nxe"] * KC, kw["nxl"] * KC
    emb, demb = embed_with_tangents(packed["embed_fn"], pos)
    X = torch.zeros(4, P, ke + kl)  # row groups [primal, d/dx, d/dy, d/dz]
    X[0, :, :nemb], X[0, :, ke:ke + L] = emb, lat
    X[1:, :, :nemb] = demb.transpose(0, 1)

    def layer(acc, A, n_chunks, c0, all_groups):
        """acc += chunks c0 .. c0 + n_chunks - 1 of A's columns times the
        weight chunks of the same index; returns the next chunk."""
        for j in range(n_chunks):
            c = c0 + j
            wh, wl = w_hi[KC * c:KC * (c + 1)], w_lo[KC * c:KC * (c + 1)]
            g = 4 if all_groups(j) else 1
            hi, lo = _split_tf32(A[:g, :, KC * j:KC * (j + 1)])
            acc[:g] += hi @ wh + (hi @ wl + lo @ wh)
        return c0 + n_chunks

    def epilogue(acc, i):
        h, hp = _act_pair(acc[0] + kw["bias"][i], packed["act"], packed["w0"])
        return torch.cat([h[None], hp[None] * acc[1:]])

    nx, emb_chunk = kw["nxe"] + kw["nxl"], lambda j: j < kw["nxe"]
    every = lambda j: True
    acc, c = torch.zeros(4, P, 256), 0
    c = layer(acc, X, nx, c, emb_chunk)
    H = epilogue(acc, 0)
    acc = torch.zeros(4, P, 256)
    c = layer(acc, H, 16, c, every)
    H = epilogue(acc, 1)
    acc = torch.zeros(4, P, 256)
    c = layer(acc, H, 16, c, every)
    c = layer(acc, X, nx, c, emb_chunk)
    H = epilogue(acc, 2)
    acc = torch.zeros(4, P, 256)
    c = layer(acc, H, 16, c, every)
    assert c == n_chunks
    H = epilogue(acc, 3)
    out = H @ kw["w5"]
    df, grad = out[0] + kw["b5"], out[1:].T
    df_p, grad_p = sdf_value_grad_x3_plain(packed, pos, lat)
    torch.testing.assert_close(df, df_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(grad, grad_p, atol=1e-4, rtol=0)
