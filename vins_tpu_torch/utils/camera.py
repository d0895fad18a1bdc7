"""Pinhole camera with radial-tangential distortion (port of
vins_tpu/utils/camera.py): normalization and its inverse, the
perspective divide and the border test, batched over leading dims."""
from __future__ import annotations

import torch

from ..config import CameraConfig


def intrinsics_matrix(cam: CameraConfig, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    return torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                         [0.0, 0.0, 1.0]], dtype=dtype, device=device)


def _distorted(cam: CameraConfig) -> bool:
    return bool(cam.k1 or cam.k2 or cam.p1 or cam.p2)


def pixel_to_normalized(cam: CameraConfig, uv: torch.Tensor) -> torch.Tensor:
    """Pixel coords -> undistorted normalized image-plane coords.

    With radtan coefficients the distortion is inverted by a fixed
    20-step fixed-point iteration, each iterate clamped to ±4 (far
    outside any real field of view) so off-image points cannot diverge.
    """
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    xd = torch.stack([x, y], dim=-1)
    if not _distorted(cam):
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


def normalized_to_pixel(cam: CameraConfig, xy: torch.Tensor) -> torch.Tensor:
    """Normalized coords -> pixel coords (applying the distortion)."""
    xyd = xy + _distort_delta(cam, xy) if _distorted(cam) else xy
    return torch.stack([xyd[..., 0] * cam.fx + cam.cx,
                        xyd[..., 1] * cam.fy + cam.cy], dim=-1)


def project(points_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame points -> normalized image plane (perspective divide,
    |z| floored at 1e-8 with its sign)."""
    z = points_cam[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-8, torch.sign(z) * 1e-8 + 1e-12, z)
    return points_cam[..., 0:2] / z


def in_border(cam: CameraConfig, uv: torch.Tensor,
              border: int = 1) -> torch.Tensor:
    """Border validity mask (the reference tracker's inBorder)."""
    u, v = uv[..., 0], uv[..., 1]
    return ((u >= border) & (u < cam.width - border)
            & (v >= border) & (v < cam.height - border))
