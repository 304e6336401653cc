"""The port's HDF5 dataset pipeline (data/h5.py) against the JAX package's:
write -> merge -> load -> batches, as tests/test_h5.py; the merged file
equal to the JAX package's bit for bit, the loaded images and labels
(clip, depth -> range, the collision-mapping erosion) equal to its."""

import numpy as np
import pytest
import torch
from _torch_port import one_torch_thread  # noqa: F401  (autouse: one torch thread)

from sdf_nmpc_tpu.data import h5 as jh5
from sdf_nmpc_tpu_torch.data import h5 as th5

h5py = pytest.importorskip("h5py")


def _write_source(path, n, H=30, W=50, seed=0, is_depth=True, hfov=0.7592):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(200.0, 5000.0, size=(n, 1, H, W)).astype(np.float32)  # millimetres
    imgs[:, :, rng.integers(0, H, 20), rng.integers(0, W, 20)] = 0.0  # invalid pixels
    with h5py.File(path, "w") as f:
        f.create_dataset("images", data=imgs)
        f.attrs["hfov"] = hfov
        f.attrs["vfov"] = 0.4903
        f.attrs["aspect_ratio"] = 1.778
        f.attrs["is_depth"] = is_depth
        f.attrs["is_spherical"] = False
    return imgs


def test_merge_and_load_match_jax(tmp_path):
    _write_source(tmp_path / "a.h5", 10, seed=1)
    _write_source(tmp_path / "b.h5", 6, seed=2)
    srcs = [tmp_path / "a.h5", tmp_path / "b.h5"]
    th5.merge_h5(srcs, tmp_path / "m.h5", ratio_test=0.25, seed=3)
    jh5.merge_h5(srcs, tmp_path / "jm.h5", ratio_test=0.25, seed=3)
    with h5py.File(tmp_path / "m.h5", "r") as f, h5py.File(tmp_path / "jm.h5", "r") as g:
        for split in ("train", "test"):
            np.testing.assert_array_equal(f[split]["images"][()], g[split]["images"][()])
        assert dict(f.attrs) == dict(g.attrs)
        n_train, n_test = f["train"]["images"].shape[0], f["test"]["images"].shape[0]
    assert n_train + n_test == 16 and n_test == round(10 * 0.25) + round(6 * 0.25)

    (train_ds, valid_ds), meta = th5.train_dataset_from_h5(str(tmp_path), "m.h5", dmax=5.0,
                                                           train_valid_ratio=0.8, device="cpu")
    (jtrain, jvalid), jmeta = jh5.train_dataset_from_h5(str(tmp_path), "m.h5", dmax=5.0,
                                                        train_valid_ratio=0.8)
    assert meta == jmeta and train_ds.idx == jtrain.idx and valid_ds.idx == jvalid.idx
    assert len(train_ds) + len(valid_ds) == n_train
    batches = list(train_ds.batches(4, generator=torch.Generator().manual_seed(0), shuffle=True))
    assert sum(b[0].shape[0] for b in batches) == len(train_ds)
    assert batches[0][0].shape[1:] == (1, 30, 50) and float(batches[0][0].max()) <= 1.0

    # no augmentation: the preprocessed images and labels equal the JAX
    # package's to 2 f32 ulps (torch divides by a scalar as a product by its
    # reciprocal)
    for col_map in (False, True):
        ds, _ = th5.test_dataset_from_h5(str(tmp_path), "m.h5", dmax=5.0, col_map=col_map,
                                         device="cpu")
        jds, _ = jh5.test_dataset_from_h5(str(tmp_path), "m.h5", dmax=5.0, col_map=col_map)
        assert len(ds) == len(jds) == n_test
        for (img, label), (jimg, jlabel) in zip(ds.batches(3), jds.batches(3)):
            np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=0, atol=2.5e-7)
            np.testing.assert_allclose(label.numpy(), np.asarray(jlabel), rtol=0, atol=2.5e-7)
            assert (label.numpy() < img.numpy() - 1e-3).any() == col_map  # eroded
        img, label = ds[1]
        np.testing.assert_allclose(img.numpy(), np.asarray(jds[1][0]), rtol=0, atol=2.5e-7)


def test_augmented_batches_are_seeded(tmp_path):
    """train_dataset_from_h5's augmenter (vae=True: rotate, outlier
    removal) draws from the dataset's generator: the same seed gives the
    same batches, augmented ones differ from the plain images."""
    _write_source(tmp_path / "a.h5", 8, seed=4, is_depth=False)
    th5.merge_h5([tmp_path / "a.h5"], tmp_path / "m.h5", ratio_test=0.25)
    runs = []
    for _ in range(2):
        (ds, _), _ = th5.train_dataset_from_h5(str(tmp_path), "m.h5", dmax=5.0, vae=True,
                                               col_map=True, device="cpu")
        runs.append(list(ds.batches(3, torch.Generator().manual_seed(1), shuffle=True)))
    for (a, la), (b, lb) in zip(*runs):
        assert torch.equal(a, b) and torch.equal(la, lb)
    plain = th5.test_dataset_from_h5(str(tmp_path), "m.h5", dmax=5.0, device="cpu")[0]
    assert plain.augment is None
    (ds, _), _ = th5.train_dataset_from_h5(str(tmp_path), "m.h5", dmax=5.0, device="cpu")
    ds.set_augment_idx(range(len(ds)))
    raw = ds.preprocess(ds._raw([0]))
    assert not torch.equal(ds[0][0], raw[0])  # noise at least


def test_merge_attr_mismatch_rejected(tmp_path):
    _write_source(tmp_path / "a.h5", 4, seed=1)
    _write_source(tmp_path / "b.h5", 4, seed=2)  # the same attributes: fine
    th5.merge_h5([tmp_path / "a.h5", tmp_path / "b.h5"], tmp_path / "ok.h5")
    _write_source(tmp_path / "c.h5", 2, seed=3, hfov=0.5)
    with pytest.raises(ValueError, match="hfov"):
        th5.merge_h5([tmp_path / "a.h5", tmp_path / "c.h5"], tmp_path / "m.h5")


def test_shuffle_needs_a_generator():
    """The port's batches shuffle by a torch generator and refuse without one."""
    ds = th5.ImageDataset(np.zeros((3, 1, 5, 5), np.float32), range(3), lambda x: x,
                          device="cpu")
    with pytest.raises(ValueError, match="generator"):
        next(ds.batches(2, shuffle=True))
    assert [b[0].shape[0] for b in ds.batches(2)] == [2, 1]
