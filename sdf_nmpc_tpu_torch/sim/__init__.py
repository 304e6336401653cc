"""Analytic SDF scenes, range-image rendering and batched closed-loop
rollouts (with perception in the loop)."""

from .closed_loop import (
    ClosedLoopResult,
    make_closed_loop,
    make_closed_loop_perception,
    summarize,
)
from .scenes import Scene, make_scene_sdf_fn, render_range_image, scene_sdf

__all__ = ["ClosedLoopResult", "Scene", "make_closed_loop", "make_closed_loop_perception",
           "make_scene_sdf_fn", "render_range_image", "scene_sdf", "summarize"]
