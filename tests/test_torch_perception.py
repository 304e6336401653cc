"""The port's perception front end against the JAX package on the CPU:
perception/preprocessing.py, data/points.py ``pixel_grid``, sim/scenes.py
and perception/vae_runtime.py, and the trained encoder's loader gate.  The
same seeded numpy inputs on both sides; f64 at 1e-10 unless noted."""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vae import _init, _perturbed
from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)

RNG = np.random.default_rng(31)
TOL = dict(rtol=1e-10, atol=1e-10)
HFOV, VFOV = 0.7592, 0.4903


def _img(h=30, w=48, zeros=True):
    """A dmax-normalized image with a share of invalid (0) pixels."""
    x = RNG.uniform(0.05, 1.0, size=(h, w))
    if zeros:
        x[RNG.uniform(size=x.shape) < 0.2] = 0.0
    return x


def _both(name, *args, **kw):
    """(port result, JAX result) of the preprocessing function ``name`` on
    the same f64 arrays."""
    from sdf_nmpc_tpu.perception import preprocessing as J
    from sdf_nmpc_tpu_torch.perception import preprocessing as T

    got = getattr(T, name)(*[torch.as_tensor(a) if isinstance(a, np.ndarray) and a.ndim >= 2
                             else a for a in args], **kw)
    want = getattr(J, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) and a.ndim >= 2
                              else a for a in args], **kw)
    return np.asarray(got), np.asarray(want)


@pytest.mark.parametrize("name,args", [
    ("depth2range", (HFOV, VFOV)), ("range2depth", (HFOV, VFOV)), ("clip_distance", (5.0,)),
    ("clip_distance", (5.0, 2.0))])
def test_projection_and_clip_match_jax(name, args):
    x = _img() * (5000.0 if name == "clip_distance" else 1.0)
    got, want = _both(name, x, *args)
    np.testing.assert_allclose(got, want, **TOL)


def test_depth2range_map_is_jaxs():
    from sdf_nmpc_tpu.perception.preprocessing import depth2range_map as J
    from sdf_nmpc_tpu_torch.perception.preprocessing import depth2range_map as T

    np.testing.assert_array_equal(T(27, 48, HFOV, VFOV), J(27, 48, HFOV, VFOV))


@pytest.mark.parametrize("src", [(30, 48), (61, 97), (270, 480), (17, 29)])
def test_reshape_resize_matches_jax(src):
    """Equal size (a reshape), shrinking from 61 x 97 and 270 x 480
    (antialiased), growing from 17 x 29."""
    got, want = _both("reshape_resize", _img(*src), (1, 30, 48))
    assert got.shape == want.shape == (1, 1, 30, 48)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("ignore_zeros", [False, True])
@pytest.mark.parametrize("name,kernel", [("dilate", None), ("erode", None),
                                         ("dilate", "disk"), ("erode", "disk"),
                                         ("erode", "rect")])
def test_morphology_matches_jax(name, kernel, ignore_zeros):
    from sdf_nmpc_tpu_torch.perception.preprocessing import disk_kernel

    k = {None: None, "disk": disk_kernel(2), "rect": np.ones((2, 4))}[kernel]
    got, want = _both(name, _img(), k, ignore_zeros=ignore_zeros)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name,kw", [("morph_open", {}), ("morph_close", {}),
                                     ("remove_close_outliers", {}),
                                     ("remove_close_outliers", dict(kernel_size=5,
                                                                    min_range=0.3))])
def test_composite_morphology_matches_jax(name, kw):
    x = _img()
    x[RNG.uniform(size=x.shape) < 0.05] = 0.04  # close-in outliers
    got, want = _both(name, x, **kw)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("radius", [1, 3])
def test_disk_kernel_is_jaxs(radius):
    from sdf_nmpc_tpu.perception.preprocessing import disk_kernel as J
    from sdf_nmpc_tpu_torch.perception.preprocessing import disk_kernel as T

    np.testing.assert_array_equal(T(radius), J(radius))


@pytest.mark.parametrize("src", [(30, 48), (61, 97)])
@pytest.mark.parametrize("sensor", [dict(is_depth=True, is_normalized=False),
                                    dict(is_depth=False, is_normalized=False),
                                    dict(is_depth=True, is_normalized=True)])
def test_image_pipeline_matches_jax(sensor, src):
    """float32 on both sides (the pipeline casts): 1e-5 of (1 + the largest
    value), the rule of the f32 VAE runtime, covers the resize's f32 sums in
    another order (a few 1e-6 from 61 x 97; the f64 resize is held at 1e-10
    above); a raw frame in sensor units (mm) unless normalized."""
    from sdf_nmpc_tpu.config import default_config as jcfg
    from sdf_nmpc_tpu.perception import make_image_pipeline as J
    from sdf_nmpc_tpu_torch.config import default_config as tcfg
    from sdf_nmpc_tpu_torch.perception import make_image_pipeline as T

    upd = dict(sensor=dict(shape_imgs=[1, 30, 48], **sensor))
    raw = _img(*src) * (1.0 if sensor["is_normalized"] else 6000.0)
    got = T(tcfg().replace(**upd), device="cpu")(raw)
    want = np.asarray(J(jcfg().replace(**upd))(raw))
    assert got.dtype == torch.float32 and got.shape == want.shape == (1, 1, 30, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * (1 + np.abs(want).max()))


@pytest.mark.parametrize("spherical", [False, True])
def test_pixel_grid_is_jaxs(spherical):
    from sdf_nmpc_tpu.data.points import pixel_grid as J
    from sdf_nmpc_tpu_torch.data.points import pixel_grid as T

    got, want = T(27, 48, HFOV, VFOV, spherical), J(27, 48, HFOV, VFOV, spherical)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


SPHERES = [([2.0, 0.1, 0.0], 0.4), ([3.0, -0.8, 0.3], 0.3)]
BOXES = [([2.5, 0.5, -1.0], [3.0, 1.5, 1.0]), ([-1.0, -2.0, -0.5], [0.0, -1.5, 0.5])]


def _scenes(spheres, boxes):
    from sdf_nmpc_tpu.sim import Scene as JScene
    from sdf_nmpc_tpu_torch.sim import Scene

    js = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), JScene.make(spheres, boxes))
    return js, Scene.make(spheres, boxes, device="cpu").to(torch.float64)


@pytest.mark.parametrize("spheres,boxes", [(SPHERES, ()), ((), BOXES), (SPHERES, BOXES)])
def test_scene_sdf_matches_jax(spheres, boxes):
    from sdf_nmpc_tpu.sim import scene_sdf as J
    from sdf_nmpc_tpu_torch.sim import make_scene_sdf_fn, scene_sdf

    js, ts = _scenes(spheres, boxes)
    p = RNG.normal(size=(64, 3)) * 2.0  # inside and outside of every primitive
    p[:4] = [[2.0, 0.1, 0.1], [2.7, 1.0, 0.0], [-0.5, -1.7, 0.0], [2.9, -0.8, 0.3]]
    want = np.asarray(jax.vmap(lambda q: J(js, q))(jnp.asarray(p)))
    got = scene_sdf(ts, torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (want < 0).any() and (want > 0).any()
    trunc = make_scene_sdf_fn(ts, max_df=0.5)(torch.as_tensor(p), None).numpy()
    np.testing.assert_allclose(trunc, np.minimum(want, 0.5), **TOL)


@pytest.mark.parametrize("spherical", [False, True])
def test_render_range_image_matches_jax(spherical):
    """27 x 48, 48 sphere-tracing steps, from a rotated, offset camera;
    and a batch of two scenes at once."""
    from sdf_nmpc_tpu.sim import render_range_image as J
    from sdf_nmpc_tpu_torch.sim import Scene, render_range_image

    js, ts = _scenes(SPHERES, BOXES)
    c, s = np.cos(0.2), np.sin(0.2)
    R, pos = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]), np.array([0.1, -0.2, 0.05])
    want = np.asarray(J(js, jnp.asarray(pos), jnp.asarray(R), 27, 48, HFOV, VFOV, 5.0,
                        is_spherical=spherical))
    got = render_range_image(ts, torch.as_tensor(pos), torch.as_tensor(R), 27, 48, HFOV, VFOV,
                             5.0, is_spherical=spherical).numpy()
    assert got.shape == (27, 48) and 0.0 < got.min() and got.max() == 1.0
    np.testing.assert_allclose(got, want, **TOL)
    batch = render_range_image(Scene.stack([ts, ts]), torch.as_tensor(pos), torch.as_tensor(R),
                               27, 48, HFOV, VFOV, 5.0, is_spherical=spherical).numpy()
    np.testing.assert_array_equal(batch, np.stack([got, got]))


def _runtimes(batchnorm=True):
    """(JAX VaeRuntime, port VaeRuntime) on a 30 x 48 sensor, latent 8,
    a seeded encoder and decoder."""
    from sdf_nmpc_tpu.config import default_config as jcfg
    from sdf_nmpc_tpu.nn import Decoder as JDec
    from sdf_nmpc_tpu.nn import Encoder as JEnc
    from sdf_nmpc_tpu.perception import VaeRuntime as JRuntime
    from sdf_nmpc_tpu_torch.config import default_config as tcfg
    from sdf_nmpc_tpu_torch.nn.vae import Decoder, Encoder
    from sdf_nmpc_tpu_torch.nn.weights import decoder_from_jax, encoder_from_jax
    from sdf_nmpc_tpu_torch.perception import VaeRuntime

    upd = dict(sensor=dict(shape_imgs=[1, 30, 48]), nn=dict(size_latent=8))
    ev = _perturbed(_init(JEnc(1, 8, 0.0, batchnorm), 0, jnp.zeros((1, 30, 48, 1)),
                          with_logvar=True), 0)
    dv = _perturbed(_init(JDec(1, 8, (1, 30, 48), 0.0, batchnorm), 1, jnp.zeros((1, 8))), 1)
    f32 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), t)
    jrt = JRuntime(jcfg().replace(**upd), f32(ev), f32(dv), batchnorm=batchnorm)
    enc, dec = Encoder(1, 8, 0.0, batchnorm), Decoder(1, 8, (1, 30, 48), 0.0, batchnorm)
    enc.load_state_dict(encoder_from_jax(ev))
    dec.load_state_dict(decoder_from_jax(dv))
    return jrt, VaeRuntime(tcfg().replace(**upd), enc, dec, device="cpu")


def test_vae_runtime_matches_jax():
    """f32 (the pipeline casts): latent and decoded image within 1e-5 of
    (1 + their largest magnitude)."""
    jrt, trt = _runtimes()
    raw = RNG.uniform(0, 6000, size=(30, 48)).astype(np.float32)  # mm depth
    for rt in (jrt, trt):
        rt.set_img(raw)
    got, want = trt.encode(), jrt.encode()
    assert got.shape == want.shape == (1, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * (1 + np.abs(want).max()))
    gimg, wimg = trt.decode(), jrt.decode()
    assert gimg.shape == wimg.shape == (30, 48)
    np.testing.assert_allclose(gimg, wimg, rtol=0, atol=1e-5 * (1 + np.abs(wimg).max()))
    z = RNG.normal(size=8)
    for rt in (jrt, trt):
        rt.set_latent(z)
    np.testing.assert_allclose(trt.decode(), jrt.decode(), rtol=0, atol=2e-5)


def test_vae_runtime_without_decoder_refuses_decode():
    from sdf_nmpc_tpu_torch.config import default_config
    from sdf_nmpc_tpu_torch.nn.vae import Encoder
    from sdf_nmpc_tpu_torch.perception import VaeRuntime

    cfg = default_config().replace(sensor=dict(shape_imgs=[1, 30, 48]), nn=dict(size_latent=8))
    rt = VaeRuntime(cfg, Encoder(1, 8, 0.0, generator=torch.Generator().manual_seed(0)),
                    device="cpu")
    rt.set_latent(np.zeros(8))
    with pytest.raises(RuntimeError, match="decoder"):
        rt.decode()


def _small_weights(tmp_path, batchnorm):
    """A weights dir holding a seeded 8-latent encoder trained 'at' 30 x 48."""
    from flax import serialization

    from sdf_nmpc_tpu.nn import Encoder as JEnc

    jm = JEnc(1, 8, 0.0, batchnorm)
    v = _perturbed(_init(jm, 2, jnp.zeros((1, 30, 48, 1)), with_logvar=True), 2)
    v = jax.tree.map(lambda a: np.asarray(a, np.float32), v)
    (tmp_path / "vae_encoder.msgpack").write_bytes(serialization.to_bytes(v))
    (tmp_path / "meta.json").write_text(json.dumps(dict(size_latent=8, img="30x48",
                                                         batchnorm=batchnorm)))
    return jm, v


@pytest.mark.parametrize("batchnorm", [True, False])
def test_load_prod_encoder_gate_and_meta(tmp_path, batchnorm):
    """batchnorm comes from the meta; a mismatched expect_img warns, and
    under strict returns None; the loaded encoder is the flax one."""
    from sdf_nmpc_tpu_torch.nn.weights import load_prod_encoder

    jm, v = _small_weights(tmp_path, batchnorm)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        enc, meta = load_prod_encoder(tmp_path, expect_img=(30, 48), strict=True, device="cpu")
    assert meta["img"] == "30x48"
    assert any(n.startswith("ResBlock_0.BatchNorm") for n, _ in enc.named_modules()) == batchnorm
    x = RNG.uniform(size=(2, 30, 48, 1)).astype(np.float32)
    with torch.no_grad():
        got = enc(torch.as_tensor(x.transpose(0, 3, 1, 2).copy())).numpy()
    want = np.asarray(jm.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * (1 + np.abs(want).max()))
    with pytest.warns(UserWarning, match="trained at 30x48"):
        assert load_prod_encoder(tmp_path, expect_img=(27, 48), device="cpu") is not None
    with pytest.warns(UserWarning, match="strict"):
        assert load_prod_encoder(tmp_path, expect_img=(27, 48), strict=True,
                                 device="cpu") is None
    assert load_prod_encoder(tmp_path / "absent", device="cpu") is None
