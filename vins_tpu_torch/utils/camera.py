"""Pinhole camera with radial-tangential distortion (port of
vins_tpu/utils/camera.py)."""
from __future__ import annotations

import torch

from ..config import CameraConfig


def pixel_to_normalized(cam: CameraConfig, uv: torch.Tensor) -> torch.Tensor:
    """Pixel coords -> undistorted normalized image-plane coords.

    With radtan coefficients the distortion is inverted by a fixed
    20-step fixed-point iteration, each iterate clamped to ±4 (far
    outside any real field of view) so off-image points cannot diverge.
    """
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    xd = torch.stack([x, y], dim=-1)
    if cam.k1 == 0.0 and cam.k2 == 0.0 and cam.p1 == 0.0 and cam.p2 == 0.0:
        return xd
    lim = 4.0
    xu = xd
    for _ in range(20):
        xu = torch.clamp(xd - _distort_delta(cam, xu), -lim, lim)
    return xu


def _distort_delta(cam: CameraConfig, xy: torch.Tensor) -> torch.Tensor:
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = cam.k1 * r2 + cam.k2 * r2 * r2
    dx = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    dy = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([dx, dy], dim=-1)
