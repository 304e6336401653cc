"""Image datasets: in-memory arrays or HDF5 files.

Counterpart of sdf_nmpc_tpu/data/h5.py (reference sdf_nmpc/utils/data.py
and scripts/neural_nets/create_h5.py):

  * ``ImageDataset``: images from an array or an h5 dataset, preprocessed,
    optionally augmented, the label image optionally collision-mapped
    (eroded); ``batches`` hands out (image, label) batches on the device;
  * ``train_dataset_from_h5`` / ``test_dataset_from_h5``: the metadata and a
    seeded train / valid split (seed-pinned, so a resumed run sees the same
    split);
  * ``merge_h5``: several h5 sources into one file with a train / test split
    per source, their attributes checked for agreement.

h5py is imported inside the functions that read or write h5 files: the GPU
host has none.  The port writes its own datasets as .npz files of the same
layout (``write_image_dataset``; arrays ``train/images``, ``test/images``
and ``attrs/<name>``), and every reader here takes either kind.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..perception.preprocessing import clip_distance, depth2range, disk_kernel, erode
from .augment import ImageAugmenter


class ImageDataset:
    """Index-addressable dataset of (augmented image, label image) pairs,
    each (1, H, W); ``batches`` gives (B, 1, H, W) pairs.  ``data``: an
    array, a tensor (on any device) or an h5 dataset of (N, 1, H, W) or
    (N, H, W) images."""

    def __init__(self, data, idx, preprocess, augment: Optional[ImageAugmenter] = None,
                 col_mapping=None, seed=0, device="cuda"):
        self.imgs = data
        self.idx = list(idx)
        self.preprocess = preprocess
        self.augment = augment
        # membership is tested on a dataset position against this set of
        # source indices, as the JAX package does (sdf_nmpc_tpu/data/h5.py:58)
        self.augment_idx = set(self.idx)
        self.col_mapping = col_mapping
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def set_augment_idx(self, augment_idx):
        self.augment_idx = set(int(i) for i in augment_idx)

    def __len__(self):
        return len(self.idx)

    def _raw(self, positions):
        """(B, 1, H, W) float32 source images on the device."""
        rows = [self.imgs[self.idx[int(j)]] for j in positions]
        if isinstance(self.imgs, torch.Tensor):  # images already in memory, maybe on the card
            raw = torch.stack(rows).to(device=self.device, dtype=torch.float32)
        else:
            raw = torch.as_tensor(np.stack([np.asarray(r, np.float32) for r in rows]),
                                  device=self.device)
        return raw[:, None] if raw.dim() == 3 else raw

    def _pairs(self, raw, positions):
        """preprocess -> augment (the positions in augment_idx) -> collision
        map -> label masked to the image's valid pixels."""
        img = self.preprocess(raw)
        label = img
        aug = [self.augment is not None and int(j) in self.augment_idx for j in positions]
        if any(aug):
            a_img, a_label = self.augment(img, self.generator)
            m = torch.as_tensor(aug, device=self.device)[:, None, None, None]
            img = torch.where(m, a_img, img)
            label = torch.where(m, a_label, label)
        if self.col_mapping is not None:
            label = self.col_mapping(label)
        return img, torch.where(img > 0, label, torch.zeros_like(label))

    def __getitem__(self, i):
        img, label = self._pairs(self._raw([i]), [i])
        return img[0], label[0]

    def batches(self, batch_size, generator=None, shuffle=False):
        """(img, label) batches in order, or shuffled by ``generator``."""
        order = np.arange(len(self))
        if shuffle:
            if generator is None:
                raise ValueError("shuffle needs a generator")
            order = torch.randperm(len(self), generator=generator,
                                   device=generator.device).cpu().numpy()
        for i in range(0, len(order), batch_size):
            sel = order[i:i + batch_size]
            yield self._pairs(self._raw(sel), sel)


class _NpzDataset:
    """The h5 file's interface (groups of ``images``, ``attrs``) over an .npz."""

    def __init__(self, path):
        with np.load(path) as z:
            self.groups = {k.split("/")[0]: {"images": z[k]} for k in z.files
                           if k.endswith("/images")}
            self.attrs = {k.split("/", 1)[1]: z[k][()] for k in z.files if k.startswith("attrs/")}

    def __getitem__(self, group):
        return self.groups[group]


def open_image_dataset(path):
    """An h5py File of an image dataset, or its .npz counterpart."""
    if str(path).endswith(".npz"):
        return _NpzDataset(path)
    import h5py

    return h5py.File(path, "r")


def write_image_dataset(path, train, test, attrs: dict):
    """Train and test image arrays (N, 1, H, W) and the sensor attributes
    (hfov, vfov, aspect_ratio, is_depth, is_spherical) as an .npz file in
    the h5 file's layout."""
    np.savez(path, **{"train/images": train, "test/images": test},
             **{f"attrs/{k}": np.asarray(v) for k, v in attrs.items()})
    return path


def _prepare_dataset(h5file, train, dmax, vae, col_map):
    """(data, metadata, preprocess, augment, col_mapping) (reference
    data.py:153-189)."""
    data = h5file["train" if train else "test"]["images"]
    metadata = {
        "dmax": dmax,
        "hfov": float(h5file.attrs["hfov"]),
        "vfov": float(h5file.attrs["vfov"]),
        "aspect_ratio": float(h5file.attrs["aspect_ratio"]),
        "is_spherical": bool(h5file.attrs["is_spherical"]),
        "is_depth": False,  # converted to range by the preprocessing
        "nb_imgs": data.shape[0],
        "shape_imgs": list(data.shape[1:]),
    }
    augment = ImageAugmenter(metadata["shape_imgs"], noise=True, flip=True, translate=True,
                             rotate=vae, erase=True, outlier_rm=vae)
    is_depth = bool(h5file.attrs["is_depth"])
    hfov, vfov = metadata["hfov"], metadata["vfov"]

    def preprocess(img):
        x = clip_distance(img.to(torch.float32), dmax, mm_resolution=1)
        return depth2range(x, hfov, vfov) if is_depth else x

    col_mapping = None
    if col_map:
        kernel = disk_kernel(10)  # a 10-pixel disk (reference data.py:181-185)
        col_mapping = lambda img: erode(img, kernel, ignore_zeros=True)
    return data, metadata, preprocess, augment, col_mapping


def test_dataset_from_h5(path_to_data, dataset, dmax, vae=False, col_map=False, device="cuda"):
    h5file = open_image_dataset(os.path.join(path_to_data, dataset))
    data, metadata, preprocess, _, col_mapping = _prepare_dataset(h5file, False, dmax, vae,
                                                                  col_map)
    ds = ImageDataset(data, range(metadata["nb_imgs"]), preprocess, None, col_mapping,
                      device=device)
    return ds, metadata


def train_dataset_from_h5(path_to_data, dataset, dmax, train_valid_ratio=0.8, vae=False,
                          col_map=False, seed=42, device="cuda"):
    """((train_ds, valid_ds), metadata); the split is seed-pinned for resume."""
    h5file = open_image_dataset(os.path.join(path_to_data, dataset))
    data, metadata, preprocess, augment, col_mapping = _prepare_dataset(h5file, True, dmax, vae,
                                                                        col_map)
    n = metadata["nb_imgs"]
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int(round(train_valid_ratio * n))
    train_ds = ImageDataset(data, perm[:n_train].tolist(), preprocess, augment, col_mapping,
                            seed=seed, device=device)
    valid_ds = (ImageDataset(data, perm[n_train:].tolist(), preprocess, None, col_mapping,
                             device=device) if n_train < n else None)
    return (train_ds, valid_ds), metadata


def merge_h5(sources, out_path, ratio_test=0.1, seed=0):
    """Merge several image h5 files into one with train / test groups (an
    eager copy); the sources' attributes must agree."""
    import h5py

    attrs_ref = None
    train_parts, test_parts = [], []
    rng = np.random.default_rng(seed)
    for src in sources:
        with h5py.File(src, "r") as f:
            imgs = np.asarray(f["images"] if "images" in f else f["train"]["images"])
            a = {k: f.attrs[k] for k in ("hfov", "vfov", "aspect_ratio", "is_depth",
                                         "is_spherical")}
        if attrs_ref is None:
            attrs_ref = a
        else:
            for k in attrs_ref:
                if not np.all(attrs_ref[k] == a[k]):
                    raise ValueError(f"attribute {k} of {src} differs from the first source's")
        n_test = int(round(len(imgs) * ratio_test))
        perm = rng.permutation(len(imgs))
        test_parts.append(imgs[perm[:n_test]])
        train_parts.append(imgs[perm[n_test:]])
    with h5py.File(out_path, "w") as out:
        out.create_group("train").create_dataset("images", data=np.concatenate(train_parts))
        out.create_group("test").create_dataset("images", data=np.concatenate(test_parts))
        for k, v in attrs_ref.items():
            out.attrs[k] = v
    return out_path
