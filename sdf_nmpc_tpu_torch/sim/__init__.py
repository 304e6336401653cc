"""Analytic SDF scenes and range-image rendering."""

from .scenes import Scene, make_scene_sdf_fn, render_range_image, scene_sdf

__all__ = ["Scene", "make_scene_sdf_fn", "render_range_image", "scene_sdf"]
