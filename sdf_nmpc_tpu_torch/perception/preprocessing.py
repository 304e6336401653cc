"""Image preprocessing: depth/range conversions, clipping, resizing and
morphology on (..., H, W) tensors.

Counterpart of sdf_nmpc_tpu/perception/preprocessing.py:
  * images are dmax-normalized in [0, 1]; 0 marks an invalid pixel;
  * the projection maps interpolate tan(fov) linearly across the image;
  * the morphology ignores 0 pixels on request by substituting the border
    value (dilation -2, erosion +2).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.timing import span

# ---------------------------------------------------------------------------
# projection maps
# ---------------------------------------------------------------------------


def _uv_grid(height: int, width: int):
    u = np.arange(width, dtype=np.float32)
    v = np.arange(height, dtype=np.float32)
    return np.meshgrid(u, v, indexing="xy")  # each (H, W)


def depth2range_map(height: int, width: int, hfov: float, vfov: float) -> np.ndarray:
    """Per-pixel sqrt(1 + tan_h^2 + tan_v^2) factor, float32."""
    u, v = _uv_grid(height, width)
    th = np.tan(hfov) * (1 - 2 * u / width)
    tv = np.tan(vfov) * (1 - 2 * v / height)
    return np.sqrt(1 + th**2 + tv**2).astype(np.float32)


def _map_like(img, hfov, vfov):
    H, W = img.shape[-2], img.shape[-1]
    return torch.as_tensor(depth2range_map(H, W, hfov, vfov), device=img.device)


def depth2range(depth_img, hfov: float, vfov: float):
    """Depth -> range, clipped to [0, 1] (the profiler span
    ``nmpc.perception.range``)."""
    with span("nmpc.perception.range"):
        return torch.clamp(depth_img * _map_like(depth_img, hfov, vfov), 0.0, 1.0)


def range2depth(range_img, hfov: float, vfov: float):
    """Range -> depth."""
    return range_img / _map_like(range_img, hfov, vfov)


def clip_distance(img, dmax: float, mm_resolution: float = 1000):
    """Raw sensor units -> dmax-normalized [0, 1] (the profiler span
    ``nmpc.perception.clip``)."""
    with span("nmpc.perception.clip"):
        d = dmax / mm_resolution * 1000
        return torch.clamp(img / d, 0.0, 1.0)


def reshape_resize(img, shape_img=None):
    """-> (1, 1, H, W), bilinearly resized to shape_img[-2:] if it differs:
    antialiased, as jax.image.resize, so a larger frame is low-passed before
    it is sampled down."""
    img = img.reshape(1, 1, img.shape[-2], img.shape[-1])
    if shape_img is not None and tuple(img.shape[-2:]) != tuple(shape_img[-2:]):
        img = F.interpolate(img, size=tuple(int(s) for s in shape_img[-2:]), mode="bilinear",
                            align_corners=False, antialias=True)
    return img


# ---------------------------------------------------------------------------
# morphology
# ---------------------------------------------------------------------------


def _kernel_offsets(kernel: np.ndarray):
    """(dy, dx) taps of the 0/1 kernel relative to its origin, plus pad sizes."""
    kh, kw = kernel.shape
    oy, ox = kh // 2, kw // 2
    taps = [(i - oy, j - ox) for i in range(kh) for j in range(kw) if kernel[i, j] != 0]
    return taps, (oy, kh - oy - 1, ox, kw - ox - 1)


def _shift_stack(img, taps, pads, fill):
    """Stacked shifted copies of img over the kernel taps (padded with fill)."""
    top, bot, left, right = pads
    padded = F.pad(img, (left, right, top, bot), value=fill)
    H, W = img.shape[-2], img.shape[-1]
    views = [padded[..., top + dy: top + dy + H, left + dx: left + dx + W] for dy, dx in taps]
    return torch.stack(views, 0)


def _morph(img, kernel, ignore_zeros, border, reduce):
    kernel = np.ones((3, 3)) if kernel is None else np.asarray(kernel)
    taps, pads = _kernel_offsets(kernel)
    x = torch.where(img == 0, torch.full_like(img, border), img) if ignore_zeros else img
    out = reduce(_shift_stack(x, taps, pads, border), 0)
    if ignore_zeros:
        out = torch.where(out == border, torch.zeros_like(out), out)
    return out


def dilate(img, kernel=None, ignore_zeros: bool = False):
    """Grayscale dilation; border value -2."""
    return _morph(img, kernel, ignore_zeros, -2.0, torch.amax)


def erode(img, kernel=None, ignore_zeros: bool = False):
    """Grayscale erosion; border value +2."""
    return _morph(img, kernel, ignore_zeros, 2.0, torch.amin)


def morph_open(img, kernel_erode=None, kernel_dilate=None):
    """Erosion then dilation."""
    return dilate(erode(img, kernel_erode), kernel_dilate)


def morph_close(img, kernel_erode=None, kernel_dilate=None):
    """The reference's close: erode(dilate(x))."""
    return erode(dilate(img, kernel_dilate), kernel_erode)


def remove_close_outliers(img, kernel_size: int = 3, min_range: float = 0.1):
    """Opening-based removal of close-in sensor-shadow outliers: values below
    min_range cropped, opened, surviving pixels restored to their input."""
    kernel = np.ones((kernel_size, kernel_size))
    x = torch.where(img < min_range, torch.zeros_like(img), img)
    morph = morph_open(x, kernel, kernel)
    return torch.where(morph > 0, x, torch.zeros_like(x))


def disk_kernel(radius: int) -> np.ndarray:
    """Circular 0/1 kernel of the erosion collision mapping."""
    k = np.fromfunction(
        lambda x, y: ((x - radius) ** 2 + (y - radius) ** 2 <= radius**2) * 1,
        (2 * radius + 1, 2 * radius + 1),
        dtype=int,
    )
    return k.astype(np.uint8)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


def make_image_pipeline(cfg, device="cuda"):
    """The VAE's preprocessing: reshape / resize -> clip (unless normalized)
    -> depth2range (if depth).  A raw (H, W) frame -> a float32 (1, 1, H',
    W') tensor on ``device``."""
    from .. import resolve_device

    dev = resolve_device(device)
    shape = tuple(cfg.sensor.shape_imgs)
    hfov, vfov = cfg.sensor.hfov, cfg.sensor.vfov

    def pipeline(img):
        if isinstance(img, torch.Tensor):
            x = img.to(device=dev, dtype=torch.float32)
        else:
            x = torch.from_numpy(np.asarray(img, dtype=np.float32)).to(dev)
        x = reshape_resize(x, shape)
        if not cfg.sensor.is_normalized:
            x = clip_distance(x, cfg.sensor.dmax, cfg.sensor.mm_resolution)
        if cfg.sensor.is_depth:
            x = depth2range(x, hfov, vfov)
        return x

    return pipeline
