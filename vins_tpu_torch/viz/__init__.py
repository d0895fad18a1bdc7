"""Visualization / AR layer (port of vins_tpu/viz: reference DrawResult,
draw_result.{hpp,cpp})."""
from .renderer import (TrajectoryRenderer, draw_ar_overlay, find_ground_plane,
                       project_points, segment_colors)

__all__ = ["TrajectoryRenderer", "draw_ar_overlay", "find_ground_plane",
           "project_points", "segment_colors"]
