"""Trajectory / AR software renderer (port of vins_tpu/viz/renderer.py).

Re-design of the reference's DrawResult (VINS_ios/draw_result.cpp): a
CPU renderer that (a) reprojects the 3D trajectory into a gesture-style
virtual orbit camera (Reprojection, draw_result.cpp:943), (b) detects a
ground plane from the sparse map and draws an AR cube on it
(drawAR :516, drawBox :405, findGround :237, findPlane :186), and
(c) colors trajectory segments (newColor golden-ratio HSV :95).

Host-side numpy, as in the JAX module: the device produces the
drift-corrected poses and points, this module consumes them. Every entry
point also takes tensors on any device and fetches them in one copy
(device.host_args) before drawing. Images are float32 [H, W, 3] in
[0, 1]; no OpenCV dependency (lines/polygons are drawn with vectorized
scanline rasterization). find_ground_plane keeps the JAX module's
np.random.default_rng(seed) draws, so a seed gives the same plane.
"""
from __future__ import annotations

import colorsys
from typing import List, Optional, Tuple

import numpy as np

from ..device import host_args


# ---------------------------------------------------------------------------
# Small rasterization helpers (replacing cv::line / cv::fillPoly)
# ---------------------------------------------------------------------------


def _draw_line(img: np.ndarray, p0, p1, color, thickness: int = 1):
    H, W = img.shape[:2]
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1])) + 1)
    if n <= 0 or not (np.isfinite(p0).all() and np.isfinite(p1).all()):
        return
    ts = np.linspace(0.0, 1.0, min(n, 4 * max(H, W)))
    pts = p0[None] + ts[:, None] * (p1 - p0)[None]
    r = max(0, thickness // 2)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            x = np.clip(pts[:, 0] + dx, 0, W - 1).astype(np.int32)
            y = np.clip(pts[:, 1] + dy, 0, H - 1).astype(np.int32)
            inb = ((pts[:, 0] + dx >= 0) & (pts[:, 0] + dx < W)
                   & (pts[:, 1] + dy >= 0) & (pts[:, 1] + dy < H))
            img[y[inb], x[inb]] = color


def _fill_poly(img: np.ndarray, pts: np.ndarray, color, alpha: float = 1.0):
    """Scanline fill of one convex polygon; pts [N,2] (x,y)."""
    H, W = img.shape[:2]
    if not np.isfinite(pts).all():
        return
    yy, xx = np.mgrid[0:H, 0:W]
    inside = np.ones((H, W), bool)
    n = len(pts)
    for i in range(n):
        a, b = pts[i], pts[(i + 1) % n]
        cross = ((b[0] - a[0]) * (yy - a[1]) - (b[1] - a[1]) * (xx - a[0]))
        inside &= cross >= 0
    if not inside.any():
        # winding may be reversed
        inside = np.ones((H, W), bool)
        for i in range(n):
            a, b = pts[i], pts[(i + 1) % n]
            cross = ((b[0] - a[0]) * (yy - a[1]) - (b[1] - a[1]) * (xx - a[0]))
            inside &= cross <= 0
    img[inside] = (1 - alpha) * img[inside] + alpha * np.asarray(color)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def project_points(pts_w: np.ndarray, R_wc: np.ndarray, t_wc: np.ndarray,
                   fx: float, fy: float, cx: float, cy: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """World points → pixel coords through a camera at (R_wc, t_wc).
    Returns (uv [N,2], in_front [N])."""
    pts_w, R_wc, t_wc = host_args(pts_w, R_wc, t_wc)
    pc = (pts_w - t_wc) @ R_wc            # R_wcᵀ (X - t)
    z = pc[:, 2]
    ok = z > 1e-3
    zs = np.where(ok, z, 1.0)
    uv = np.stack([pc[:, 0] / zs * fx + cx, pc[:, 1] / zs * fy + cy], -1)
    return uv, ok


def segment_colors(n_segments: int) -> List[np.ndarray]:
    """Golden-ratio HSV colors per trajectory segment (reference newColor,
    draw_result.cpp:95)."""
    out = []
    h = 0.12
    for _ in range(max(n_segments, 1)):
        h = (h + 0.618033988749895) % 1.0
        out.append(np.asarray(colorsys.hsv_to_rgb(h, 0.9, 0.95), np.float32))
    return out


def find_ground_plane(pts_w: np.ndarray, valid: np.ndarray,
                      n_hyps: int = 128, thresh: float = 0.05,
                      seed: int = 0) -> Optional[Tuple[np.ndarray, float]]:
    """Ground-plane fit from the sparse map: z-histogram seeding + 3-point
    RANSAC (reference findGround draw_result.cpp:237-284 + findPlane
    :186-235). Returns (normal [3], d) with n·x + d = 0, or None."""
    pts_w, valid = host_args(pts_w, valid)
    P = np.asarray(pts_w)[np.asarray(valid)]
    if len(P) < 8:
        return None
    # Histogram of z: ground candidates cluster at the low mode.
    z = P[:, 2]
    hist, edges = np.histogram(z, bins=24)
    k = int(np.argmax(hist))
    zc = 0.5 * (edges[k] + edges[k + 1])
    cand = P[np.abs(z - zc) < max(3 * (edges[1] - edges[0]), 0.15)]
    if len(cand) < 8:
        cand = P
    rng = np.random.default_rng(seed)
    best = None
    best_inl = 0
    for _ in range(n_hyps):
        idx = rng.choice(len(cand), 3, replace=False)
        a, b, c = cand[idx]
        n = np.cross(b - a, c - a)
        nn = np.linalg.norm(n)
        if nn < 1e-9:
            continue
        n = n / nn
        if n[2] < 0:
            n = -n
        if n[2] < 0.85:       # ground planes are near-horizontal
            continue
        d = -n @ a
        inl = int((np.abs(cand @ n + d) < thresh).sum())
        if inl > best_inl:
            best_inl = inl
            best = (n, d)
    if best is None or best_inl < 6:
        return None
    return best


def draw_ground_mesh(img: np.ndarray, R_wc: np.ndarray, t_wc: np.ndarray,
                     fx, fy, cx, cy, pts_w: np.ndarray, normal: np.ndarray,
                     d: float, color=(0.15, 0.8, 0.3),
                     thresh: float = 0.05) -> np.ndarray:
    """Shade the detected ground plane with a Delaunay mesh of its inliers
    (reference DrawResult::drawGround draw_result.cpp:369-403 over the
    vendored triangulator delaunay/delaunay.cpp)."""
    from .delaunay import triangulate_ground

    img, R_wc, t_wc, pts_w, normal, d = host_args(img, R_wc, t_wc, pts_w,
                                                  normal, d)
    if img.ndim == 2:
        out = np.repeat(img[:, :, None], 3, axis=2).astype(np.float32)
    else:
        out = img.astype(np.float32).copy()
    inl, tris = triangulate_ground(pts_w, normal, d, thresh)
    if not tris:
        return out
    uv, ok = project_points(inl, R_wc, t_wc, fx, fy, cx, cy)
    for a, b, c in tris:
        if ok[a] and ok[b] and ok[c]:
            _fill_poly(out, uv[[a, b, c]], color, alpha=0.25)
            for e0, e1 in ((a, b), (b, c), (c, a)):
                _draw_line(out, uv[e0], uv[e1], color, thickness=1)
    return out


def draw_ar_overlay(img: np.ndarray, R_wc: np.ndarray, t_wc: np.ndarray,
                    fx, fy, cx, cy,
                    box_center_w: np.ndarray, box_size: float = 0.3,
                    color=(0.2, 0.5, 0.95)) -> np.ndarray:
    """Draw an AR cube sitting at box_center_w (reference drawBox,
    draw_result.cpp:405-...). img: [H,W] gray or [H,W,3]; returns RGB."""
    img, R_wc, t_wc, box_center_w = host_args(img, R_wc, t_wc, box_center_w)
    if img.ndim == 2:
        out = np.repeat(img[:, :, None], 3, axis=2).astype(np.float32)
    else:
        out = img.astype(np.float32).copy()
    s = box_size / 2.0
    corners = np.array([[sx, sy, sz] for sx in (-s, s) for sy in (-s, s)
                        for sz in (0, 2 * s)]) + np.asarray(box_center_w)
    uv, ok = project_points(corners, R_wc, t_wc, fx, fy, cx, cy)
    if not ok.all():
        return out
    edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    # Top face fill for solidity.
    top = [i for i, c in enumerate(corners - box_center_w) if c[2] > s]
    _fill_poly(out, uv[[top[0], top[1], top[3], top[2]]], color, alpha=0.35)
    for a, b in edges:
        _draw_line(out, uv[a], uv[b], color, thickness=2)
    return out


# ---------------------------------------------------------------------------
# Trajectory view
# ---------------------------------------------------------------------------


class TrajectoryRenderer:
    """Orbitable top-down/perspective trajectory view (reference
    Reprojection, draw_result.cpp:943): renders the drift-corrected
    trajectory, keyframes, loop edges, and the sparse map into an image
    with a virtual camera controlled by (yaw, pitch, radius) — the
    gesture-orbit equivalents."""

    def __init__(self, width: int = 640, height: int = 640,
                 focal: float = 500.0):
        self.W = width
        self.H = height
        self.focal = focal
        self.yaw = 0.0
        self.pitch = -1.1
        self.radius = 12.0
        self.center = np.zeros(3)

    def _camera(self):
        cy_, sy = np.cos(self.yaw), np.sin(self.yaw)
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        # Orbit camera looking at self.center.
        fwd = np.array([cy_ * cp, sy * cp, sp])
        t = self.center - fwd * self.radius
        z = fwd / np.linalg.norm(fwd)
        x = np.cross(z, np.array([0.0, 0.0, 1.0]))
        x = x / max(np.linalg.norm(x), 1e-9)
        y = np.cross(z, x)
        R_wc = np.stack([x, y, z], axis=1)
        return R_wc, t

    def render(self, trajectory: np.ndarray,
               segments: Optional[np.ndarray] = None,
               points_w: Optional[np.ndarray] = None,
               loop_edges: Optional[List[Tuple[int, int]]] = None,
               keyframes: Optional[np.ndarray] = None) -> np.ndarray:
        """trajectory: [N,3]; segments: [N] int segment ids; points_w:
        [M,3] sparse map; loop_edges: index pairs into `keyframes` [K,3]."""
        trajectory, segments, points_w, keyframes, loop_edges = host_args(
            trajectory, segments, points_w, keyframes, loop_edges)
        if isinstance(loop_edges, np.ndarray):      # a fetched [E, 2]
            loop_edges = [tuple(e) for e in loop_edges.astype(int).tolist()]
        img = np.full((self.H, self.W, 3), 0.08, np.float32)
        traj = np.asarray(trajectory, np.float64)
        if len(traj) == 0:
            return img
        self.center = 0.9 * self.center + 0.1 * traj.mean(0)
        R_wc, t = self._camera()
        f = self.focal
        cx, cy_ = self.W / 2, self.H / 2

        if points_w is not None and len(points_w):
            uv, ok = project_points(np.asarray(points_w), R_wc, t, f, f,
                                    cx, cy_)
            u = uv[ok].astype(np.int32)
            inb = ((u[:, 0] >= 0) & (u[:, 0] < self.W)
                   & (u[:, 1] >= 0) & (u[:, 1] < self.H))
            img[u[inb, 1], u[inb, 0]] = (0.55, 0.55, 0.55)

        uv, ok = project_points(traj, R_wc, t, f, f, cx, cy_)
        seg = (np.zeros(len(traj), np.int32) if segments is None
               else np.asarray(segments))
        colors = segment_colors(int(seg.max()) + 1)
        for i in range(1, len(traj)):
            if ok[i - 1] and ok[i] and seg[i] == seg[i - 1]:
                _draw_line(img, uv[i - 1], uv[i], colors[seg[i]], 2)

        if keyframes is not None and loop_edges:
            kuv, kok = project_points(np.asarray(keyframes), R_wc, t, f, f,
                                      cx, cy_)
            for a, b in loop_edges:
                if kok[a] and kok[b]:
                    _draw_line(img, kuv[a], kuv[b], (0.95, 0.85, 0.2), 1)
        return img
