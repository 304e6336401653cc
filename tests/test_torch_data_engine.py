"""The port's GT data engine (data/points.py, collision.py, df_computer.py,
pos_sampler.py, augment.py) against the JAX package's, f64 on the CPU.

The kernel bodies are called directly with f64 arrays (the JAX classes cast
to f32): labels and argmins equal, values within 1e-12.  The samplers and
the augmenter are fed the draws that the JAX package's own key splits give
(reproduced here from the same keys): points and images within 1e-12."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import one_torch_thread, t64  # noqa: F401  (autouse: one torch thread)

from sdf_nmpc_tpu.data import augment as jaug
from sdf_nmpc_tpu.data import collision as jcol
from sdf_nmpc_tpu.data import df_computer as jdf
from sdf_nmpc_tpu.data import points as jpts
from sdf_nmpc_tpu.data import pos_sampler as jps
from sdf_nmpc_tpu.training import df as jtrain
from sdf_nmpc_tpu_torch.data import augment as taug
from sdf_nmpc_tpu_torch.data import collision as tcol
from sdf_nmpc_tpu_torch.data import df_computer as tdf
from sdf_nmpc_tpu_torch.data import points as tpts
from sdf_nmpc_tpu_torch.data import pos_sampler as tps
from sdf_nmpc_tpu_torch.training import df as ttrain

DMAX, HFOV, VFOV = 5.0, 0.7592, 0.4903
H, W = 30, 50  # divisible by the UDF's 5 x 5 pool
OMNI = dict(hfov=np.pi, vfov=np.pi / 6)
TOL = dict(rtol=0, atol=1e-12)


def scene_images(n, hfov=HFOV, vfov=VFOV, is_spherical=False, h=H, w=W, seed=0):
    """(n, h, w) f64 range images of random spheres in front of a wall
    (the port's renderer), a few pixels set invalid (0)."""
    from sdf_nmpc_tpu_torch.sim.scenes import Scene, render_range_image

    rng = np.random.default_rng(seed)
    scenes = [Scene.make(spheres=[(rng.uniform([0.8, -1.5, -0.6], [4.0, 1.5, 0.6]),
                                   rng.uniform(0.2, 0.7)) for _ in range(3)],
                         boxes=[([rng.uniform(2.0, 4.5), -9, -9], [9, 9, 9])], device="cpu")
              for _ in range(n)]
    R = torch.eye(3, dtype=torch.float64)
    if is_spherical:  # look around: a ring of the same scene behind the camera
        scenes = [Scene.make(spheres=[(rng.uniform([-2, -2, -0.5], [2, 2, 0.5]), 0.4)] * 2,
                             boxes=[([-9, -9, -9], [9, 9, -1.0])], device="cpu")
                  for _ in range(n)]
    imgs = render_range_image(Scene.stack(scenes).to(torch.float64), np.zeros(3), R, h, w,
                              hfov, vfov, DMAX, is_spherical=is_spherical).numpy()
    imgs[:, rng.integers(0, h, 12), rng.integers(0, w, 12)] = 0.0
    return imgs


def geometry(outside, is_depth, is_spherical=False, safe_ball=0.2):
    fov = OMNI if is_spherical else dict(hfov=HFOV, vfov=VFOV)
    return dict(dmax=DMAX, **fov, safe_ball=safe_ball, is_depth=is_depth,
                is_spherical=is_spherical, outside=tcol.OUTSIDE[outside])


def query_points(n, seed, lo=(-1.0, -4.0, -4.0), hi=(6.0, 4.0, 4.0)):
    return np.random.default_rng(seed).uniform(lo, hi, size=(n, 3))


# ---------------------------------------------------------------- collision

CASES = [(o, d, False) for o in tcol.OUTSIDE for d in (False, True)] + [
    (o, False, True) for o in tcol.OUTSIDE]


@pytest.mark.parametrize("outside,is_depth,is_spherical", CASES)
def test_check_image_points_impl_matches_jax(outside, is_depth, is_spherical):
    geo = geometry(outside, is_depth, is_spherical)
    imgs = scene_images(3, geo["hfov"], geo["vfov"], is_spherical)
    lo = (-6.0, -6.0, -4.0) if is_spherical else (-1.0, -4.0, -4.0)
    pts = query_points(900, 1, lo=lo)
    p2i = np.repeat(np.arange(3), 300)
    want = jax.jit(partial(jcol.check_image_points_impl, **geo))(
        jnp.asarray(imgs), jnp.asarray(pts), jnp.asarray(p2i))
    got = tcol.check_image_points_impl(t64(imgs), t64(pts), torch.as_tensor(p2i), **geo)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < len(pts)  # both labels occur


def test_colchecker_api_default_index_and_margins():
    """ColChecker splits the points evenly over the images; the margins
    are the decisions' distances to their boundaries."""
    imgs = scene_images(2)
    pts = query_points(40, 2)
    cc = tcol.ColChecker(DMAX, HFOV, VFOV, 0.2, outside="col", device="cpu",
                         dtype=torch.float64)
    got = cc.check_image_points(imgs, pts)
    want = tcol.check_image_points_impl(t64(imgs), t64(pts), torch.arange(2).repeat_interleave(20),
                                        **geometry("col", False))
    assert torch.equal(got, want)
    m = cc.label_margins(imgs, pts)
    assert set(m) == {"metres", "pixels", "radians"} and all((v >= 0).all() for v in m.values())


# ------------------------------------------------------------------- the DF


def test_minpool_ignore_zeros_matches_jax():
    imgs = scene_images(2)
    imgs[0, :5, :5] = 0.0  # an all-zero block
    want = jdf.minpool_ignore_zeros(jnp.asarray(imgs), 5)
    got = tdf.minpool_ignore_zeros(t64(imgs), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[0, 0, 0] == 0.0) and (got.numpy() > 0).sum() > 0


@pytest.mark.parametrize("is_depth,is_spherical", [(False, False), (True, False), (False, True)])
def test_udf_impl_matches_jax(is_depth, is_spherical):
    fov = OMNI if is_spherical else dict(hfov=HFOV, vfov=VFOV)
    imgs = scene_images(2, **fov, is_spherical=is_spherical)
    pooled = np.asarray(jdf.minpool_ignore_zeros(jnp.asarray(imgs), 5))
    pts = query_points(60, 3, lo=(0.0, -2.0, -1.0), hi=(4.5, 2.0, 1.0))
    p2i = np.repeat(np.arange(2), 30)
    kw = dict(dmax=DMAX, **fov, is_depth=is_depth, is_spherical=is_spherical, max_df=1.0)
    want = jax.jit(partial(jdf._udf_impl, **kw))(jnp.asarray(pooled), jnp.asarray(pts),
                                                 jnp.asarray(p2i))
    got = tdf._udf_impl(t64(pooled), t64(pts), torch.as_tensor(p2i), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert 0 < (got[0].numpy() < 1.0).sum() < len(pts)


class _F64Check:
    """The JAX collision checker without its f32 cast (its kernel body in
    f64), for the JAX package's _sdf_chunk."""

    def __init__(self, geo):
        self.geo = geo

    def check_image_points(self, imgs, points, p_to_i):
        return jcol.check_image_points_impl(imgs, points, p_to_i, **self.geo)


@pytest.mark.parametrize("is_depth,is_spherical", [(False, False), (True, False), (False, True)])
def test_sdf_chunk_matches_jax(is_depth, is_spherical):
    geo = geometry("extrapolate", is_depth, is_spherical, safe_ball=0.0)
    imgs = scene_images(2, geo["hfov"], geo["vfov"], is_spherical)
    pts = query_points(24, 4, lo=(-2.0 if is_spherical else 0.5, -2.0, -1.0),
                       hi=(4.5, 2.0, 1.0))
    p2i = np.repeat(np.arange(2), 12)
    occupied = tcol.check_image_points_impl(t64(imgs), t64(pts), torch.as_tensor(p2i), **geo)
    dists, grid = tdf.generate_dist_grid()
    jd, jg = jdf.generate_dist_grid()
    np.testing.assert_array_equal(dists, jd)
    np.testing.assert_array_equal(grid, jg)
    grid64, dists64 = grid.astype(np.float64), dists.astype(np.float64)
    md, am = jax.jit(partial(jdf._sdf_chunk, colcheck=_F64Check(geo), grid=jnp.asarray(grid64),
                             distances=jnp.asarray(dists64), max_df=1.0))(
        jnp.asarray(imgs), jnp.asarray(pts), jnp.asarray(p2i), jnp.asarray(occupied.numpy()))
    got_md, got_am = tdf._sdf_chunk(t64(imgs), t64(pts), torch.as_tensor(p2i), occupied,
                                    check=geo, grid=t64(grid64), distances=t64(dists64),
                                    max_df=1.0)
    np.testing.assert_array_equal(got_am.numpy(), np.asarray(am))
    np.testing.assert_allclose(got_md.numpy(), np.asarray(md), **TOL)
    assert 0 < occupied.sum() < len(pts) and (got_md.numpy() < 1.0).any()


def test_df_computer_chunks_as_one_pass():
    """DfComputer (f64, chunks of 7 points) against the JAX package's
    get_sdf / get_udf arithmetic in one pass: the chunking changes
    nothing, the clamping and saturated gradients as the JAX package's."""
    imgs = scene_images(2)
    pts = query_points(30, 5, lo=(0.3, -1.5, -0.8), hi=(4.5, 1.5, 0.8))
    p2i = np.repeat(np.arange(2), 15)
    geo = geometry("extrapolate", False, safe_ball=0.0)
    sign_bool = jcol.check_image_points_impl(jnp.asarray(imgs), jnp.asarray(pts),
                                             jnp.asarray(p2i), **geo)
    dists, grid = (a.astype(np.float64) for a in jdf.generate_dist_grid())
    md, am = jdf._sdf_chunk(jnp.asarray(imgs), jnp.asarray(pts), jnp.asarray(p2i), sign_bool,
                            colcheck=_F64Check(geo), grid=jnp.asarray(grid),
                            distances=jnp.asarray(dists), max_df=1.0)
    # sdf_nmpc_tpu/data/df_computer.py:130-137, in f64
    sign = 1 - 2 * sign_bool.astype(jnp.float64)
    dirs = jnp.asarray(grid)[am]
    want_sdf = jnp.clip(sign * md, -0.3, 1.0)
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    sat = (want_sdf == -0.3) | (want_sdf == 1.0)
    want_grad = -sign[:, None] * jnp.where(sat[:, None], 0.0, dirs)
    dfc = tdf.DfComputer(True, DMAX, HFOV, VFOV, 2.0, batch_size=7, device="cpu",
                         dtype=torch.float64)
    sdf, grad = dfc.get_df(imgs, pts)
    np.testing.assert_allclose(sdf.numpy(), np.asarray(want_sdf), **TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), **TOL)
    assert (sdf.numpy() > 0).any() and (sdf.numpy() == -0.3).any()  # a saturated gradient

    pooled = jdf.minpool_ignore_zeros(jnp.asarray(imgs), 5)
    want = jdf._udf_impl(pooled, jnp.asarray(pts), jnp.asarray(p2i), dmax=DMAX, hfov=HFOV,
                         vfov=VFOV, is_depth=False, is_spherical=False, max_df=1.0)
    udf = tdf.DfComputer(False, DMAX, HFOV, VFOV, 1.0, batch_size=7, device="cpu",
                         dtype=torch.float64)
    for g, w in zip(udf.get_df(imgs, pts), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ------------------------------------------------------------------ points


@pytest.mark.parametrize("is_depth,is_spherical,downsamp", [
    (False, False, 1), (True, False, 5), (False, True, 5)])
def test_imgs2points_matches_jax(is_depth, is_spherical, downsamp):
    fov = OMNI if is_spherical else dict(hfov=HFOV, vfov=VFOV)
    imgs = scene_images(2, **fov, is_spherical=is_spherical)
    args = (DMAX, fov["hfov"], fov["vfov"], is_depth, is_spherical, downsamp)
    np.testing.assert_allclose(tpts.imgs2points(t64(imgs), *args).numpy(),
                               np.asarray(jpts.imgs2points(jnp.asarray(imgs), *args)), **TOL)
    np.testing.assert_allclose(tpts.imgs2points(t64(imgs[0]), *args).numpy(),
                               np.asarray(jpts.imgs2points(jnp.asarray(imgs[0]), *args)), **TOL)
    for g, w in zip(tpts.imgs2points_masked(t64(imgs), *args),
                    jpts.imgs2points_masked(jnp.asarray(imgs), *args)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    got = tpts.imgs2points(t64(imgs), *args, remove_d0=True, remove_dmax=True)
    want = jpts.imgs2points(jnp.asarray(imgs), *args, remove_d0=True, remove_dmax=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------- samplers


def _u(key, n):
    return jax.random.uniform(key, (n,), jnp.float64)


def _draws3(key, n):
    """Three uniform draws by the JAX samplers' split(key, 3)."""
    return [t64(_u(k, n)) for k in jax.random.split(key, 3)]


def _margin_draws(key, n_total):
    n = n_total // 5
    keys = jax.random.split(key, 15)
    return [t64(_u(k, n if i < 12 else n_total - 4 * n)) for i, k in enumerate(keys)]


def _obs_draws(key, imgs, n, mode):
    ksel, knoise = jax.random.split(key)
    M = (imgs.shape[-2] // 5) * (imgs.shape[-1] // 5)
    B = imgs.shape[0] if imgs.ndim == 3 else 1
    idx = (torch.as_tensor(np.asarray(jax.random.randint(ksel, (n,), 0, M)))
           if mode == "random" else None)
    return idx, t64(jax.random.normal(knoise, (B, n, 3), jnp.float64))


def samplers():
    return (jps.PosSampler(DMAX, HFOV, VFOV, margin=40),
            tps.PosSampler(DMAX, HFOV, VFOV, margin=40, device="cpu", dtype=torch.float64))


@pytest.mark.parametrize("add_margin", [False, True])
def test_samplers_match_jax_draws(add_margin):
    js, ts = samplers()
    key = jax.random.PRNGKey(7)
    n = 203
    cases = [
        (js.sample_pos_in_box(key, n, add_margin), ts.box_from_draws(*_draws3(key, n),
                                                                     add_margin)),
        (js.sample_pos_in_ball(key, n, 0.75, add_margin),
         ts.ball_from_draws(*_draws3(key, n), 0.75, add_margin)),
        (js.sample_pos_in_frustrum(key, n, add_margin),
         ts.frustrum_from_draws(*_draws3(key, n), add_margin)),
        (js.sample_pos_in_frustrum_margin(key, n),
         ts.frustrum_margin_from_draws(_margin_draws(key, n))),
    ]
    for want, got in cases:
        assert got.shape == (n, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    norm = ts.normalize(t64(np.asarray(js.sample_pos_in_box(key, 5))))
    np.testing.assert_allclose(norm.numpy(), np.asarray(js.normalize(js.sample_pos_in_box(key, 5))),
                               **TOL)


@pytest.mark.parametrize("mode,batch", [("random", True), ("closest", True), ("random", False)])
def test_around_obs_matches_jax_draws(mode, batch):
    js, ts = samplers()
    imgs = scene_images(3)
    imgs = imgs if batch else imgs[0]
    key = jax.random.PRNGKey(11)
    want = js.sample_pos_around_obs(key, jnp.asarray(imgs), 37, mode=mode, std=0.1)
    got = ts.around_obs_from_draws(t64(imgs), *_obs_draws(key, imgs, 37, mode), mode, 0.1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sample_points_mixes_as_jax():
    """train_df's point mix: the four samplers' points in the JAX
    package's order and grouping per image, each sampler fed the draws of
    its own key of split(key, 4)."""
    js, ts = samplers()
    key = jax.random.PRNGKey(5)
    kf, kb, ko, km = jax.random.split(key, 4)
    imgs = scene_images(3)

    class Replay(tps.PosSampler):
        def sample_pos_in_frustrum(self, generator, n, add_margin=False):
            return self.frustrum_from_draws(*_draws3(kf, n), add_margin)

        def sample_pos_in_ball(self, generator, n, ball_size, add_margin=False):
            return self.ball_from_draws(*_draws3(kb, n), ball_size, add_margin)

        def sample_pos_in_frustrum_margin(self, generator, n):
            return self.frustrum_margin_from_draws(_margin_draws(km, n))

        def sample_pos_around_obs(self, generator, imgs, n, mode="closest", std=0.2):
            return self.around_obs_from_draws(imgs, *_obs_draws(ko, imgs, n, mode), mode, std)

    counts = jtrain.DfTrainConfig(points_per_img=60).point_counts()
    want = jtrain.sample_points(key, js, jnp.asarray(imgs), counts, 0.75)
    replay = Replay(DMAX, HFOV, VFOV, margin=40, device="cpu", dtype=torch.float64)
    got = ttrain.sample_points(None, replay, t64(imgs), counts, 0.75)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    drawn = ttrain.sample_points(torch.Generator().manual_seed(0), ts, t64(imgs), counts, 0.75)
    assert drawn.shape == (3 * 60, 3) and torch.isfinite(drawn).all()


def test_grids_match_jax():
    js, ts = samplers()
    for name, args in (("grid_frustrum_slice", (100, 10.0)), ("grid_frustrum", (1000,)),
                       ("grid_sphere", (1000,)), ("grid_sphere_fixed_step", (1.0, True))):
        want = np.asarray(getattr(js, name)(*args))
        got = getattr(ts, name)(*args).numpy()
        np.testing.assert_array_equal(got, want.astype(np.float64))


# --------------------------------------------------------------- augmenter


def jax_augment_draws(aug, key):
    """The variates the JAX ImageAugmenter draws for one image from key
    (sdf_nmpc_tpu/data/augment.py:49-126), as the port's draws (batch 1)."""
    C, Hh, Ww = aug.shape
    keys = jax.random.split(key, 10)
    U = lambda k: float(jax.random.uniform(k))
    kdo, kn, kmask = jax.random.split(keys[8], 3)
    kbdo, *kb = jax.random.split(keys[9], 1 + 4 * aug.nb_box_erase_max)
    boxes = [kb[4 * b:4 * b + 4] for b in range(aug.nb_box_erase_max)]
    d = {
        "flip_h": U(keys[0]) < aug.proba_flip, "flip_v": U(keys[1]) < aug.proba_flip,
        "translate": U(keys[2]) < aug.proba_translate,
        "shift": int(jax.random.randint(keys[3], (), 0, Ww)),
        "rotate": U(keys[4]) < aug.proba_rotate,
        "angle": float(jax.random.uniform(keys[5], (), minval=-aug.max_rot, maxval=aug.max_rot)),
        "noise_on": U(keys[6]) < aug.proba_noise,
        "noise": np.asarray(jax.random.normal(keys[7], aug.shape)),
        "pix_on": U(kdo) < aug.proba_erase_pixels,
        "pix_n": int(jax.random.randint(kn, (), aug.nb_pix_erase_min, aug.nb_pix_erase_max)),
        "pix_u": np.asarray(jax.random.uniform(kmask, aug.shape)),
        "box_on": U(kbdo) < aug.proba_erase_boxes,
        "box_scale": [float(jax.random.uniform(k[0], (), minval=aug.boxes_scale_range[0],
                                               maxval=aug.boxes_scale_range[1])) for k in boxes],
        "box_ratio": [float(jax.random.uniform(k[1], (), minval=aug.boxes_ratio_range[0],
                                               maxval=aug.boxes_ratio_range[1])) for k in boxes],
        "box_y0": [int(jax.random.randint(k[2], (), 0, Hh)) for k in boxes],
        "box_x0": [int(jax.random.randint(k[3], (), 0, Ww)) for k in boxes],
    }
    return {k: torch.as_tensor(np.asarray(v))[None] for k, v in d.items()}


@pytest.mark.parametrize("outlier_rm", [False, True])
def test_augmenter_matches_jax_draws(outlier_rm):
    flags = dict(noise=True, flip=True, translate=True, rotate=True, erase=True,
                 outlier_rm=outlier_rm)
    jaug_ = jaug.ImageAugmenter((1, H, W), **flags)
    taug_ = taug.ImageAugmenter((1, H, W), **flags)
    imgs = scene_images(6, seed=3)
    imgs[:, 3, 4:9] = 0.05  # close outliers beside invalid pixels
    fn = jax.jit(jaug_.__call__)
    seen = set()
    for i in range(6):
        key = jax.random.PRNGKey(100 + i)
        want = fn(key, jnp.asarray(imgs[i][None]))
        draws = jax_augment_draws(jaug_, key)
        got = taug_.apply(t64(imgs[i][None, None]), draws)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[0].numpy(), np.asarray(w), **TOL)
        seen |= {k for k in ("flip_h", "rotate", "pix_on", "box_on") if bool(draws[k])}
    assert {"flip_h", "rotate"} <= seen  # the draws exercise the branches


def test_rotate_matches_jax_map_coordinates():
    img = scene_images(1)[0][None]
    for deg in (-4.3, 0.0, 2.9):
        want = jaug._rotate_image(jnp.asarray(img), jnp.deg2rad(jnp.float64(deg)), 0.0)
        got = taug.rotate_images(t64(img)[None], torch.deg2rad(torch.tensor([deg],
                                                                           dtype=torch.float64)),
                                 0.0)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TOL)


def test_augmenter_draws_batch():
    """The generator-fed wrapper: shapes, determinism per seed, labels."""
    aug = taug.ImageAugmenter((1, H, W), noise=True, flip=True, translate=True, rotate=True,
                              erase=True, outlier_rm=True)
    imgs = t64(scene_images(4))[:, None]
    a1, l1 = aug(imgs, torch.Generator().manual_seed(3))
    a2, _ = aug(imgs, torch.Generator().manual_seed(3))
    a3, _ = aug(imgs, torch.Generator().manual_seed(4))
    assert a1.shape == l1.shape == imgs.shape
    assert torch.equal(a1, a2) and not torch.equal(a1, a3)
    single, _ = aug(imgs[0], torch.Generator().manual_seed(3))
    assert single.shape == imgs[0].shape
