"""The ground-truth data engine: collision labels, distance fields, point
samplers, augmentation, losses and image datasets."""

from .augment import ImageAugmenter
from .collision import ColChecker
from .df_computer import DfComputer, generate_dist_grid, minpool_ignore_zeros
from .losses import (
    loss_kld,
    loss_mse_valid_pixels,
    loss_mse_valid_pixels_bias_distance,
    loss_mse_valid_pixels_bias_pos_dist,
    loss_mse_valid_pixels_bias_positive,
    loss_sdf,
    loss_weighted_bce,
)
from .points import imgs2points, imgs2points_masked, minpool, pixel_grid, unit_rays
from .pos_sampler import PosSampler

__all__ = ["ColChecker", "DfComputer", "ImageAugmenter", "PosSampler", "generate_dist_grid",
           "imgs2points", "imgs2points_masked", "loss_kld", "loss_mse_valid_pixels",
           "loss_mse_valid_pixels_bias_distance", "loss_mse_valid_pixels_bias_pos_dist",
           "loss_mse_valid_pixels_bias_positive", "loss_sdf", "loss_weighted_bce", "minpool",
           "minpool_ignore_zeros", "pixel_grid", "unit_rays"]
