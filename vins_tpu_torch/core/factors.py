"""Batched factor residuals and tangent-space Jacobians (port of
vins_tpu/core/factors.py).

Each factor exposes a local residual of a small tangent perturbation;
its Jacobian is the forward-mode derivative at zero
(`local_jacobian`: one torch.func.jvp per tangent direction, vmapped over
the directions, with the factor batch riding along) — the counterpart of
the JAX module's vmapped jax.jacfwd.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jvp, vmap

from ..utils import lie
from . import preintegration as pre_mod


class Extrinsics(NamedTuple):
    tic: torch.Tensor   # [3]
    qic: torch.Tensor   # [4] wxyz


def local_jacobian(local: Callable[[torch.Tensor], torch.Tensor], B: int,
                   n: int, dtype, device):
    """(r [B, m], J [B, m, n]) of a batched local residual
    local(delta [B, n]) -> [B, m] at delta = 0."""
    zero = torch.zeros((B, n), dtype=dtype, device=device)
    basis = torch.eye(n, dtype=dtype, device=device)[:, None, :].expand(
        n, B, n)
    r = local(zero)
    J = vmap(lambda t: jvp(local, (zero,), (t,))[1])(basis)   # [n, B, m]
    return r, J.permute(1, 2, 0)


# ---------------------------------------------------------------------------
# IMU factors (one per window edge)
# ---------------------------------------------------------------------------


def imu_residual_whitened(pre: pre_mod.Preintegration, p_i, q_i, v_i, ba_i,
                          bg_i, p_j, q_j, v_j, ba_j, bg_j,
                          gravity: torch.Tensor) -> torch.Tensor:
    """Whitened 15-dim IMU residual S r of one edge (or a batch of edges
    over leading dimensions)."""
    r = pre_mod.evaluate(pre, p_i, q_i, v_i, ba_i, bg_i,
                         p_j, q_j, v_j, ba_j, bg_j, gravity)
    return torch.einsum("...ij,...j->...i", pre_mod.sqrt_information(pre), r)


def imu_factor_local(pre: pre_mod.Preintegration, p_i, q_i, v_i, ba_i,
                     bg_i, p_j, q_j, v_j, ba_j, bg_j, gravity,
                     S: torch.Tensor):
    """Whitened residual and Jacobian of B IMU edges wrt the 30-dim
    tangent [frame i (15) | frame j (15)]. Inputs are [B, ...] per-edge
    slices; S: [B, 15, 15] whitening. Returns (r [B,15], J [B,15,30])."""

    def local(delta):
        di, dj = delta[..., :15], delta[..., 15:]
        pi, qi = lie.pose_retract(p_i, q_i, di[..., 0:6])
        pj, qj = lie.pose_retract(p_j, q_j, dj[..., 0:6])
        r = pre_mod.evaluate(
            pre, pi, qi, v_i + di[..., 6:9], ba_i + di[..., 9:12],
            bg_i + di[..., 12:15], pj, qj, v_j + dj[..., 6:9],
            ba_j + dj[..., 9:12], bg_j + dj[..., 12:15], gravity)
        return torch.einsum("...ij,...j->...i", S, r)

    return local_jacobian(local, p_i.shape[0], 30, p_i.dtype, p_i.device)


# ---------------------------------------------------------------------------
# Projection factors
# ---------------------------------------------------------------------------


def projection_residual(obs_i, obs_j, p_i, q_i, p_j, q_j, inv_dep,
                        ext: Extrinsics) -> torch.Tensor:
    """Unwhitened 2-dim reprojection residual, anchor frame i -> frame j
    (projection_facor.cpp:16-40). inv_dep: [...]."""
    pts_i = torch.cat([obs_i, torch.ones_like(obs_i[..., :1])], -1)
    pts_cam_i = pts_i / torch.clamp(inv_dep, min=1e-6)[..., None]
    pts_imu_i = lie.quat_rotate(ext.qic, pts_cam_i) + ext.tic
    pts_w = lie.quat_rotate(q_i, pts_imu_i) + p_i
    pts_imu_j = lie.quat_rotate(lie.quat_conj(q_j), pts_w - p_j)
    pts_cam_j = lie.quat_rotate(lie.quat_conj(ext.qic), pts_imu_j - ext.tic)
    z = pts_cam_j[..., 2:3]
    z_safe = torch.where(torch.abs(z) < 1e-4,
                         torch.where(z < 0, -1e-4, 1e-4).to(z.dtype), z)
    return pts_cam_j[..., 0:2] / z_safe - obs_j


def projection_factor_local(obs_i, obs_j, p_i, q_i, p_j, q_j, inv_dep,
                            ext: Extrinsics, sqrt_info: torch.Tensor):
    """Residual and Jacobian of B projection factors wrt the 13-dim
    tangent [anchor pose 6 | observing pose 6 | inverse depth 1].
    Returns (r [B, 2], J [B, 2, 13])."""

    def local(delta):
        pi, qi = lie.pose_retract(p_i, q_i, delta[..., 0:6])
        pj, qj = lie.pose_retract(p_j, q_j, delta[..., 6:12])
        r = projection_residual(obs_i, obs_j, pi, qi, pj, qj,
                                inv_dep + delta[..., 12], ext)
        return sqrt_info * r

    return local_jacobian(local, obs_i.shape[0], 13, obs_i.dtype,
                          obs_i.device)


def perspective_residual(pt_world, obs, p, q, ext: Extrinsics):
    """2-dim residual of a fixed world landmark seen from pose (p, q)
    (perspective_factor.cpp:16-40; the caller folds the track weight into
    its sqrt_info)."""
    pts_imu = lie.quat_rotate(lie.quat_conj(q), pt_world - p)
    pts_cam = lie.quat_rotate(lie.quat_conj(ext.qic), pts_imu - ext.tic)
    z = pts_cam[..., 2:3]
    z_safe = torch.where(torch.abs(z) < 1e-4,
                         torch.where(z < 0, -1e-4, 1e-4).to(z.dtype), z)
    return pts_cam[..., 0:2] / z_safe - obs


def cauchy_weight(r: torch.Tensor, c: float) -> torch.Tensor:
    """Sqrt-reweighting for the Cauchy loss on whitened residuals."""
    s = torch.sum(r * r, -1, keepdim=True)
    return torch.sqrt(1.0 / (1.0 + s / (c * c)))


def cauchy_rho(s: torch.Tensor, c: float) -> torch.Tensor:
    return c * c * torch.log1p(s / (c * c))
