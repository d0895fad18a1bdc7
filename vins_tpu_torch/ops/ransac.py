"""Batched fixed-hypothesis 8-point RANSAC, essential-matrix pose
recovery and Gauss–Newton PnP (port of vins_tpu/ops/ransac.py).

The reference samples each hypothesis's minimal set by Gumbel-top-k over
the valid points with jax.random, whose bits torch cannot reproduce, so
the noise is an input here: pass `gumbel` [n_hyps, N] (tests replay the
JAX key chain into it) or a torch.Generator to draw it from.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import lie


def _normalize_points(pts: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization over the valid rows (invalid rows excluded
    with where, so a NaN there cannot poison the mean)."""
    w = valid.to(pts.dtype)[:, None]
    pts_safe = torch.where(valid[:, None], pts, torch.zeros_like(pts))
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(pts_safe * w, 0) / n
    d = torch.sqrt(torch.sum((pts_safe - mean) ** 2, -1) + 1e-12)
    scale = 1.41421356 / torch.clamp(torch.sum(d * valid) / n, min=1e-9)
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[0]]),
        torch.stack([zero, scale, -scale * mean[1]]),
        torch.stack([zero, zero, one])])
    return (pts - mean) * scale, T


def _eight_point(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """[B, 8, 2] correspondences -> [B, 3, 3] F (no rank-2 projection):
    the null vector of the 8x9 system from a complete QR of Aᵀ."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1)             # [B, 8, 9]
    Q, _ = torch.linalg.qr(A.transpose(-1, -2), mode="complete")
    return Q[..., :, -1].reshape(A.shape[:-2] + (3, 3))


def _sampson_dist(F: torch.Tensor, p1: torch.Tensor,
                  p2: torch.Tensor) -> torch.Tensor:
    """[B, N] Sampson distances of [N, 2] correspondences under [B,3,3]."""
    ones = torch.ones_like(p1[:, :1])
    x1 = torch.cat([p1, ones], -1)
    x2 = torch.cat([p2, ones], -1)
    Fx1 = torch.einsum("nj,bij->bni", x1, F)       # F @ x1
    Ftx2 = torch.einsum("ni,bij->bnj", x2, F)      # Fᵀ @ x2
    num = torch.sum(x2[None] * Fx1, -1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
           + Ftx2[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)


class RansacResult(NamedTuple):
    model: torch.Tensor      # [3, 3]
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # []


def gumbel_noise(n_hyps: int, N: int, generator: torch.Generator,
                 dtype=torch.float32) -> torch.Tensor:
    """[n_hyps, N] standard Gumbel draws from `generator`."""
    u = torch.rand((n_hyps, N), generator=generator, dtype=dtype,
                   device=generator.device)
    u = torch.clamp(u, min=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def ransac_fundamental(p1: torch.Tensor, p2: torch.Tensor,
                       valid: torch.Tensor, n_hyps: int = 256,
                       thresh: float = 1e-5,
                       gumbel: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> RansacResult:
    """Batched 8-point F-RANSAC over [N, 2] correspondences.

    Hypothesis h fits the 8 valid points with the largest
    gumbel[h] + log(valid) (Gumbel-top-k, distinct within a hypothesis);
    all hypotheses are scored by Sampson distance in one [n_hyps, N]
    pass and the first with the most inliers wins."""
    N = p1.shape[0]
    if gumbel is None:
        gumbel = gumbel_noise(n_hyps, N, generator, p1.dtype)
    pn1, T1 = _normalize_points(p1, valid)
    pn2, T2 = _normalize_points(p2, valid)
    logits = torch.where(valid, 0.0, float("-inf")).to(p1.dtype)
    _, idx = torch.topk(gumbel + logits, 8, dim=-1)          # [h, 8]
    Fh = _eight_point(pn1[idx], pn2[idx])
    Fs = T2.T @ Fh @ T1                                      # [h, 3, 3]
    d = _sampson_dist(Fs, p1, p2)
    inl = (d < thresh) & valid[None, :]
    counts = torch.sum(inl, 1)
    # index_select keeps the winner's index on the device (indexing with a
    # device scalar would read it back to the host).
    best = torch.argmax(counts)[None]
    pick = lambda x: torch.index_select(x, 0, best)[0]
    U, S, Vh = torch.linalg.svd(pick(Fs))
    S = torch.cat([S[:2], torch.zeros_like(S[2:])])
    return RansacResult(model=U @ torch.diag(S) @ Vh, inliers=pick(inl),
                        n_inliers=pick(counts))


def ransac_essential(p1: torch.Tensor, p2: torch.Tensor,
                     valid: torch.Tensor, n_hyps: int = 256,
                     thresh: float = 1e-5,
                     gumbel: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> RansacResult:
    """The 8-point F-RANSAC on normalized camera-plane coordinates, its
    winner projected onto the essential manifold (singular values
    1, 1, 0)."""
    res = ransac_fundamental(p1, p2, valid, n_hyps, thresh, gumbel,
                             generator)
    U, _, Vh = torch.linalg.svd(res.model)
    s = torch.ones(3, dtype=p1.dtype, device=p1.device)
    s[2:].zero_()
    return res._replace(model=U @ torch.diag(s) @ Vh)


def _triangulate_pair(R: torch.Tensor, t: torch.Tensor, p1: torch.Tensor,
                      p2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation of [N] correspondences for cam1 = [I|0],
    cam2 = [R|t]: the null vector of each 4x4 system, read as
    X[:3] / X[3] (its sign cancels). Returns [N, 3] in cam1's frame."""
    P2 = torch.cat([R, t[:, None]], 1)                       # [3, 4]
    a0, a1 = p1[:, 0], p1[:, 1]
    zero, one = torch.zeros_like(a0), torch.ones_like(a0)
    A = torch.stack([
        torch.stack([-one, zero, a0, zero], -1),
        torch.stack([zero, -one, a1, zero], -1),
        p2[:, 0:1] * P2[2] - P2[0],
        p2[:, 1:2] * P2[2] - P2[1]], 1)                      # [N, 4, 4]
    X = torch.linalg.svd(A)[2][:, -1]
    w = X[:, 3:]
    return X[:, :3] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)


def _count_in_front(R, t, p1, p2, valid) -> torch.Tensor:
    """Correspondences triangulated in front of both cameras."""
    X1 = _triangulate_pair(R, t, p1, p2)
    z2 = (X1 @ R.T + t)[:, 2]
    return torch.sum((X1[:, 2] > 0) & (z2 > 0) & valid)


def recover_pose(E: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                 valid: torch.Tensor):
    """Cheirality-tested decomposition of E (cv::recoverPose): of the four
    (R, ±t) candidates the first with the most points in front of both
    cameras. Returns (R, t, n_good), x2 ~ R x1 + t, |t| = 1. U and Vᵀ
    are made proper rotations by their determinants' signs; R is then
    the same whichever basis the SVD picks for E's repeated singular
    value."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    Wm = torch.zeros((3, 3), dtype=E.dtype, device=E.device)
    Wm[0, 1:2].fill_(-1.0)
    Wm[1, 0:1].fill_(1.0)
    Wm[2, 2:].fill_(1.0)
    R1 = U @ Wm @ Vh
    R2 = U @ Wm.T @ Vh
    t = U[:, 2]
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([t, -t, t, -t])
    counts = torch.stack([_count_in_front(R, tt, p1, p2, valid)
                          for R, tt in zip(Rs, ts)])
    best = torch.argmax(counts)[None]
    pick = lambda x: torch.index_select(x, 0, best)[0]
    return pick(Rs), pick(ts), pick(counts)


def translation_known_rotation(R: torch.Tensor, p1: torch.Tensor,
                               p2: torch.Tensor, valid: torch.Tensor):
    """Relative translation direction for a known rotation (the gyro's):
    each correspondence gives t · (R x̃1 × x̃2) = 0, valid for any scene
    structure, planes included; min |C t| with |t| = 1 by SVD, the sign
    by cheirality. Returns (t_unit, n_good)."""
    ones = torch.ones_like(p1[:, :1])
    h1 = torch.cat([p1, ones], 1)
    h2 = torch.cat([p2, ones], 1)
    C = lie.cross(h1 @ R.T, h2) * valid[:, None].to(p1.dtype)
    t = torch.linalg.svd(C, full_matrices=False)[2][-1]
    t = t / torch.clamp(torch.sqrt(torch.sum(t * t)), min=1e-12)
    n_pos = _count_in_front(R, t, p1, p2, valid)
    n_neg = _count_in_front(R, -t, p1, p2, valid)
    return torch.where(n_neg > n_pos, -t, t), torch.maximum(n_pos, n_neg)


def pnp_gn(points_w: torch.Tensor, obs: torch.Tensor, valid: torch.Tensor,
           p0: torch.Tensor, q0: torch.Tensor, iters: int = 10):
    """Gauss–Newton PnP: refine the world-from-camera pose (p, q) from
    fixed world points [N, 3] and normalized observations [N, 2]; a step
    is kept only if it lowers the squared residual. Returns (p, q,
    mean_sq_residual). The 2N x 6 Jacobian is forward-mode autodiff at
    the tangent origin, as jax.jacfwd takes it."""
    w = valid.to(points_w.dtype)

    def residual(p, q):
        pc = lie.quat_rotate(lie.quat_conj(q), points_w - p)
        z = torch.where(torch.abs(pc[:, 2:3]) < 1e-6,
                        torch.full_like(pc[:, 2:3], 1e-6), pc[:, 2:3])
        return (pc[:, :2] / z - obs) * w[:, None]

    z6 = torch.zeros(6, dtype=points_w.dtype, device=points_w.device)
    eye = 1e-6 * torch.eye(6, dtype=points_w.dtype, device=points_w.device)
    p, q = p0, q0
    for _ in range(iters):
        def res_local(d, p=p, q=q):
            return residual(*lie.pose_retract(p, q, d)).reshape(-1)

        r = res_local(z6)
        J = torch.func.jacfwd(res_local)(z6)
        H = J.T @ J + eye
        d = -torch.linalg.solve_ex(H, J.T @ r)[0]
        pp, qq = lie.pose_retract(p, q, d)
        better = torch.sum(r ** 2) >= torch.sum(residual(pp, qq) ** 2)
        p = torch.where(better, pp, p)
        q = torch.where(better, qq, q)
    msr = torch.sum(residual(p, q) ** 2) / torch.clamp(torch.sum(w), min=1.0)
    return p, q, msr
