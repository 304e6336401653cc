"""Perception: the image preprocessing and the VAE runtime."""

from .preprocessing import (
    clip_distance,
    depth2range,
    depth2range_map,
    dilate,
    disk_kernel,
    erode,
    make_image_pipeline,
    morph_close,
    morph_open,
    range2depth,
    remove_close_outliers,
    reshape_resize,
)
from .vae_runtime import VaeRuntime

__all__ = ["VaeRuntime", "clip_distance", "depth2range", "depth2range_map", "dilate",
           "disk_kernel", "erode", "make_image_pipeline", "morph_close", "morph_open",
           "range2depth", "remove_close_outliers", "reshape_resize"]
