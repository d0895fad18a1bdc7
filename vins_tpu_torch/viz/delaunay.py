"""Delaunay triangulation of ground-plane inlier points (port of
vins_tpu/viz/delaunay.py: the same Bowyer–Watson algorithm, giving the
same triangles in the same order; inputs may be numpy or tensors).

Capability parity with the reference's vendored triangulator
(VINS_ios/delaunay/delaunay.cpp:1-118, used by DrawResult::drawGround,
draw_result.cpp:369-403) which meshes the detected ground inliers so the
AR overlay can shade the floor. Host-side Bowyer–Watson over the (at
most a few hundred) plane inliers — this is a per-render visualization
step, not a device hot loop.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..device import host_args

Triangle = Tuple[int, int, int]


def _circumcircle(a: np.ndarray, b: np.ndarray, c: np.ndarray):
    """Center and squared radius of the circumcircle of triangle abc.

    Returns (center [2], r2). Degenerate triangles get r2 = inf so they
    swallow every point and are culled with the super-triangle.
    """
    d = 2.0 * (a[0] * (b[1] - c[1]) + b[0] * (c[1] - a[1])
               + c[0] * (a[1] - b[1]))
    if abs(d) < 1e-12:
        return np.array([0.0, 0.0]), np.inf
    ux = ((a @ a) * (b[1] - c[1]) + (b @ b) * (c[1] - a[1])
          + (c @ c) * (a[1] - b[1])) / d
    uy = ((a @ a) * (c[0] - b[0]) + (b @ b) * (a[0] - c[0])
          + (c @ c) * (b[0] - a[0])) / d
    center = np.array([ux, uy])
    return center, float(np.sum((a - center) ** 2))


def delaunay(points: np.ndarray) -> List[Triangle]:
    """Bowyer–Watson Delaunay triangulation of 2D `points` [N, 2].

    Returns index triangles into `points`. Duplicate points are kept but
    never produce degenerate output triangles.
    """
    pts = np.asarray(host_args(points)[0], np.float64)
    n = len(pts)
    if n < 3:
        return []

    # Super-triangle enclosing everything.
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    c = 0.5 * (lo + hi)
    m = max(float(np.max(hi - lo)), 1e-6) * 20.0
    sup = np.array([[c[0] - m, c[1] - m],
                    [c[0] + m, c[1] - m],
                    [c[0], c[1] + m]])
    allp = np.vstack([pts, sup])
    tris: List[Triangle] = [(n, n + 1, n + 2)]
    circ = {(n, n + 1, n + 2): _circumcircle(*allp[[n, n + 1, n + 2]])}

    for i in range(n):
        p = allp[i]
        bad = []
        for t in tris:
            center, r2 = circ[t]
            if np.sum((p - center) ** 2) <= r2:
                bad.append(t)
        # Boundary of the cavity: edges not shared by two bad triangles.
        edge_count = {}
        for t in bad:
            for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
                k = (min(e), max(e))
                edge_count[k] = edge_count.get(k, 0) + 1
        for t in bad:
            tris.remove(t)
            del circ[t]
        for (u, v), cnt in edge_count.items():
            if cnt == 1:
                t = (u, v, i)
                cc = _circumcircle(allp[u], allp[v], allp[i])
                if np.isfinite(cc[1]):
                    tris.append(t)
                    circ[t] = cc

    # Drop triangles touching the super-triangle.
    return [t for t in tris if max(t) < n]


def triangulate_ground(pts_w: np.ndarray, normal: np.ndarray,
                       d: float, thresh: float = 0.05
                       ) -> Tuple[np.ndarray, List[Triangle]]:
    """Mesh the points within `thresh` of plane n·x + d = 0.

    Projects inliers into the plane's 2D frame, triangulates there, and
    returns (inlier world points [M, 3], triangles). Mirrors drawGround's
    inlier meshing (draw_result.cpp:369-403).
    """
    pts_w, normal, d = host_args(pts_w, normal, d)
    P = np.asarray(pts_w, np.float64)
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    inl = P[np.abs(P @ n + d) < thresh]
    if len(inl) < 3:
        return inl, []
    # Plane basis.
    a = np.array([1.0, 0.0, 0.0])
    if abs(n @ a) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    u = np.cross(n, a)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    uv = np.stack([inl @ u, inl @ v], axis=1)
    return inl, delaunay(uv)
