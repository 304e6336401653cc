"""Training-time image augmentation.

Counterpart of sdf_nmpc_tpu/data/augment.py (the reference's
ImageAugmenter, data.py:33-48): Gaussian noise on the valid pixels,
horizontal / vertical flips, a circular horizontal translation (a 360
lidar), a small rotation, random pixel and box erasing, and close-outlier
removal that makes the cleaned label image.  The same probabilities and
magnitudes.  Images are (B, C, H, W) (or one (C, H, W)), dmax-normalized, 0
marking an invalid pixel.

``draw`` takes every random variate of a batch from a ``torch.Generator``
and ``apply`` maps (images, draws) to (augmented, label): the draws are
tensors with a leading batch axis, so a test can feed the variates the JAX
package's key splits give.
"""

from __future__ import annotations

import torch

from ..perception.preprocessing import remove_close_outliers

N_BOXES = 4  # erased boxes drawn per image


class ImageAugmenter:
    def __init__(self, shape, noise=False, flip=False, translate=False, rotate=False,
                 erase=False, outlier_rm=False):
        self.shape = tuple(int(s) for s in shape)  # (C, H, W)
        self.noise = noise
        self.flip = flip
        self.translate = translate
        self.rotate = rotate
        self.erase = erase
        self.outlier_rm = outlier_rm
        self.invalid = 0.0
        # the reference's probabilities and magnitudes (data.py:33-48)
        self.proba_noise = 1.0
        self.proba_flip = 0.5
        self.proba_translate = 1.0
        self.proba_rotate = 0.8
        self.proba_erase_pixels = 0.3
        self.proba_erase_boxes = 0.3
        self.std_range = 0.02
        self.max_rot = 5.0  # degrees
        H, W = self.shape[1], self.shape[2]
        self.nb_pix_erase_min = int(H * W * 0.03)
        self.nb_pix_erase_max = int(H * W * 0.10)
        self.nb_box_erase_max = N_BOXES
        self.boxes_scale_range = (0.02, 0.06)
        self.boxes_ratio_range = (0.2, 5.0)

    def draw(self, generator, B: int, device, dtype=torch.float32) -> dict:
        """Every random variate of a batch of B images."""
        H, W = self.shape[1], self.shape[2]
        u = lambda *s: torch.rand((B,) + s, generator=generator, device=device, dtype=dtype)
        ints = lambda lo, hi, *s: torch.randint(lo, hi, (B,) + s, generator=generator,
                                                device=device)
        lo, hi = self.boxes_scale_range
        rlo, rhi = self.boxes_ratio_range
        return {
            "flip_h": u() < self.proba_flip, "flip_v": u() < self.proba_flip,
            "translate": u() < self.proba_translate, "shift": ints(0, W),
            "rotate": u() < self.proba_rotate, "angle": u() * (2 * self.max_rot) - self.max_rot,
            "noise_on": u() < self.proba_noise,
            "noise": torch.randn((B,) + self.shape, generator=generator, device=device,
                                 dtype=dtype),
            "pix_on": u() < self.proba_erase_pixels,
            "pix_n": ints(self.nb_pix_erase_min, self.nb_pix_erase_max),
            "pix_u": u(*self.shape),
            "box_on": u() < self.proba_erase_boxes,
            "box_scale": u(N_BOXES) * (hi - lo) + lo, "box_ratio": u(N_BOXES) * (rhi - rlo) + rlo,
            "box_y0": ints(0, H, N_BOXES), "box_x0": ints(0, W, N_BOXES),
        }

    def __call__(self, img, generator=None):
        """(augmented, label) of (B, C, H, W) or (C, H, W) images."""
        single = img.dim() == 3
        x = img[None] if single else img
        out = self.apply(x, self.draw(generator, x.shape[0], x.device, x.dtype))
        return tuple(o[0] for o in out) if single else out

    def apply(self, img, d):
        """(augmented, label) of (B, C, H, W) images under the draws ``d``
        (sdf_nmpc_tpu/data/augment.py:49-91, per image), the images taken
        in float32 as the JAX package takes them."""
        img = img.to(torch.float32)
        sel = lambda flag, a, b: torch.where(flag[:, None, None, None], a, b)
        if self.flip:
            img = sel(d["flip_h"], img.flip(-1), img)
            img = sel(d["flip_v"], img.flip(-2), img)
        if self.translate:  # roll(img, -n) along the width
            W = img.shape[-1]
            cols = (torch.arange(W, device=img.device)[None] + d["shift"][:, None]) % W
            rolled = torch.take_along_dim(img, cols[:, None, None, :].expand_as(img), dim=-1)
            img = sel(d["translate"], rolled, img)
        if self.rotate:
            img = sel(d["rotate"], rotate_images(img, torch.deg2rad(d["angle"]), self.invalid),
                      img)
        # the label: an outlier-removed copy of a real-sensor image, else the image
        if self.outlier_rm:
            has_invalid = (img == self.invalid).flatten(1).any(1)
            label = sel(has_invalid, remove_close_outliers(img), img)
        else:
            label = img
        if self.noise:
            noisy = torch.where(img != self.invalid,
                                torch.clamp(img + d["noise"] * self.std_range, 0, 1),
                                torch.full_like(img, self.invalid))
            img = sel(d["noise_on"], noisy, img)
        if self.erase:
            img = self._erase_pixels(img, d)
            img = self._erase_boxes(img, d)
        return img, label

    def _erase_pixels(self, img, d):
        """A Bernoulli mask of the drawn ratio (the JAX package's static-shape
        stand-in for erasing n pixels)."""
        H, W = self.shape[1], self.shape[2]
        rate = d["pix_n"].to(torch.float32) / (H * W)
        mask = d["pix_u"] < rate[:, None, None, None]
        return torch.where(d["pix_on"][:, None, None, None] & mask, torch.zeros_like(img), img)

    def _erase_boxes(self, img, d):
        H, W = self.shape[1], self.shape[2]
        rows = torch.arange(H, device=img.device)[:, None]
        cols = torch.arange(W, device=img.device)[None, :]
        area = d["box_scale"] * H * W  # (B, N_BOXES)
        bh = torch.sqrt(area * d["box_ratio"]).to(torch.int32)
        bw = torch.sqrt(area / d["box_ratio"]).to(torch.int32)
        y0, x0 = d["box_y0"], d["box_x0"]
        out = img
        for b in range(N_BOXES):
            box = ((rows >= y0[:, b, None, None]) & (rows < (y0[:, b] + bh[:, b])[:, None, None])
                   & (cols >= x0[:, b, None, None])
                   & (cols < (x0[:, b] + bw[:, b])[:, None, None]))  # (B, H, W)
            out = torch.where(d["box_on"][:, None, None, None] & box[:, None], 0.0, out)
        return out


def rotate_images(img, angle_rad, fill):
    """Rotation of channel 0 of (B, C, H, W) images by angle_rad (B,) about
    the image centre, bilinear, ``fill`` outside: jax.scipy.ndimage's
    map_coordinates at order 1, mode 'constant' (each corner's weight times
    its value, or fill off the image)."""
    B, _, H, W = img.shape
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=img.device),
                            torch.arange(W, dtype=torch.float32, device=img.device),
                            indexing="ij")
    c = torch.cos(angle_rad)[:, None, None]
    s = torch.sin(angle_rad)[:, None, None]
    ys = c * (yy - cy) - s * (xx - cx) + cy
    xs = s * (yy - cy) + c * (xx - cx) + cx
    src = img[:, 0].reshape(B, -1)
    y_lo, x_lo = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y_lo, xs - x_lo
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy0, ix0 = y_lo.to(torch.int32).long(), x_lo.to(torch.int32).long()
    out = None
    for iy, wy in ((iy0, wy0), (iy0 + 1, wy1)):
        for ix, wx in ((ix0, wx0), (ix0 + 1, wx1)):
            valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
            flat = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(B, -1)
            val = src.gather(1, flat).reshape(B, H, W)
            term = (wy * wx) * torch.where(valid, val, torch.full_like(val, fill))
            out = term if out is None else out + term
    return out.to(img.dtype)[:, None]
