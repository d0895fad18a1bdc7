"""Schur-complement bundle adjustment on one device (port of the
single-device path of vins_tpu/parallel/dist_ba.py).

Per LM iteration: per landmark-keyframe residuals and their Jacobians
(forward mode over the 9-dim pose-and-point tangent), the block-diagonal
pose-pose normal equations, the landmark blocks eliminated by batched 3x3
inverses (S = Σ_l B_l Hpp_l⁻¹ B_lᵀ), the reduced camera system (6K x 6K)
solved by Cholesky, and the landmark back-substitution. The accept/reject
of each step is a torch.where on the state: a solve runs its fixed
iteration count without a host decision. Poses are gauge-fixed through
per-pose freeze flags; an optional position prior keeps the IMU-metric
scale (BAProblem). The JAX module's landmark-sharded solve
(solve_ba_sharded, a psum over the mesh's block axis) is not ported.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import jvp, vmap

from ..utils import lie


class BAProblem(NamedTuple):
    """Dense observation grid of L landmarks over K keyframes.

    obs[l, k]: normalized camera-plane observation of landmark l in
    keyframe k; mask[l, k] ∈ {0, 1}; pose_free[k]: 1 free, 0 fixed (gauge
    anchors). prior_p, prior_w: an optional position prior pulling every
    free pose toward prior_p (residual rows w·(p − p⁰)); in a mono BA the
    metric scale is otherwise observable only through the anchors."""

    obs: torch.Tensor        # [L, K, 2]
    mask: torch.Tensor       # [L, K] float
    pose_free: torch.Tensor  # [K]
    prior_p: Optional[torch.Tensor] = None   # [K, 3]
    prior_w: Optional[torch.Tensor] = None   # [] weight per meter


class BAState(NamedTuple):
    p: torch.Tensor      # [K, 3] camera positions (world)
    q: torch.Tensor      # [K, 4] wxyz world-from-camera
    pts: torch.Tensor    # [L, 3] landmark world points


def _residual_lk(X, obs, p, q):
    """Reprojection residual of landmarks X in cameras (p, q), batched."""
    Xc = lie.quat_rotate(lie.quat_conj(q), X - p)
    z = Xc[..., 2:3]
    z_safe = torch.where(torch.abs(z) < 1e-4,
                         torch.where(z < 0, -1e-4, 1e-4), z)
    return Xc[..., :2] / z_safe - obs


def _landmark_blocks(state: BAState, prob: BAProblem):
    """Masked residuals r [L, K, 2] and Jacobians Jc [L, K, 2, 6] (pose
    tangent, frozen poses zeroed) and Jp [L, K, 2, 3] (point)."""
    L, K = prob.mask.shape
    X = state.pts[:, None, :].expand(L, K, 3)
    p = state.p[None].expand(L, K, 3)
    q = state.q[None].expand(L, K, 4)

    def local(d):
        pp, qq = lie.pose_retract(p, q, d[..., :6])
        return _residual_lk(X + d[..., 6:9], prob.obs, pp, qq)

    zero = torch.zeros((L, K, 9), dtype=state.p.dtype, device=state.p.device)
    basis = torch.eye(9, dtype=zero.dtype, device=zero.device)[
        :, None, None, :].expand(9, L, K, 9)
    r = local(zero)
    J = vmap(lambda t: jvp(local, (zero,), (t,))[1])(basis)  # [9, L, K, 2]
    J = J.permute(1, 2, 3, 0)                                 # [L, K, 2, 9]
    m = prob.mask[..., None, None]
    Jc = J[..., :6] * m * prob.pose_free[None, :, None, None]
    return r * prob.mask[..., None], Jc, J[..., 6:9] * m


def _block_diag(blocks: torch.Tensor) -> torch.Tensor:
    """[K, 6, 6] -> [6K, 6K] block-diagonal."""
    K = blocks.shape[0]
    eye = torch.eye(K, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("kij,kl->kilj", blocks, eye).reshape(K * 6, K * 6)


def _local_normal_eqs(state: BAState, prob: BAProblem):
    """(H_cc [6K, 6K], g_c [6K], S [6K, 6K], gs_corr [6K], Hpp_inv
    [L, 3, 3], B [L, 6K, 3], g_p [L, 3], cost [])."""
    L, K = prob.mask.shape
    r, Jc, Jp = _landmark_blocks(state, prob)
    # Within a landmark, different k rows never share a pose column, so
    # H_cc is block-diagonal per pose.
    Hcc_k = torch.einsum("lkri,lkrj->kij", Jc, Jc)
    g_c = torch.einsum("lkri,lkr->ki", Jc, r).reshape(K * 6)
    Hpp = torch.einsum("lkri,lkrj->lij", Jp, Jp) + 1e-8 * torch.eye(
        3, dtype=Jp.dtype, device=Jp.device)
    g_p = torch.einsum("lkri,lkr->li", Jp, r)
    B = torch.einsum("lkri,lkrj->lkij", Jc, Jp).reshape(L, K * 6, 3)
    Hpp_inv = torch.linalg.inv_ex(Hpp)[0]
    BH = B @ Hpp_inv                                          # [L, 6K, 3]
    S = torch.einsum("lia,lja->ij", BH, B)
    gs_corr = torch.einsum("lia,la->i", BH, g_p)
    cost = 0.5 * torch.sum(r * r)
    return _block_diag(Hcc_k), g_c, S, gs_corr, Hpp_inv, B, g_p, cost


def _lm_iteration(state: BAState, prob: BAProblem, lam: torch.Tensor):
    """One damped LM step: the candidate state and the current cost. A
    failed Cholesky gives a NaN step (rejected by the caller). The prior
    fields are set (_materialize_prior)."""
    K = prob.mask.shape[1]
    Hcc, g_c, S, gs_corr, Hpp_inv, B, g_p, cost = _local_normal_eqs(
        state, prob)
    H_s = Hcc - S
    g_s = g_c - gs_corr
    w2 = prob.prior_w * prob.prior_w
    diag = torch.zeros((K, 6), dtype=H_s.dtype, device=H_s.device)
    diag[:, :3] = (w2 * prob.pose_free)[:, None]
    H_s = H_s + torch.diag(diag.reshape(-1))
    dp = (state.p - prob.prior_p) * prob.pose_free[:, None]
    g_add = torch.zeros_like(diag)
    g_add[:, :3] = w2 * dp
    g_s = g_s + g_add.reshape(-1)
    # Damping plus a floor: frozen poses have zeroed columns, and the
    # absolute term keeps their rows positive definite.
    d = torch.diagonal(H_s)
    H_d = H_s + torch.diag(lam * d + 1e-6 + lam)
    L_chol, info = torch.linalg.cholesky_ex(H_d)
    dx_c = -torch.cholesky_solve(g_s[:, None], L_chol)[:, 0]
    dx_c = torch.where(info == 0, dx_c, torch.full_like(dx_c, float("nan")))
    rhs = g_p + torch.einsum("lia,i->la", B, dx_c)
    dx_p = -torch.einsum("lab,lb->la", Hpp_inv, rhs)
    d_pose = dx_c.reshape(K, 6) * prob.pose_free[:, None]
    p_new, q_new = lie.pose_retract(state.p, state.q, d_pose)
    return BAState(p=p_new, q=q_new, pts=state.pts + dx_p), cost


def _ba_cost(state: BAState, prob: BAProblem) -> torch.Tensor:
    # The residuals of _landmark_blocks at a zero step: through
    # pose_retract, which renormalizes q.
    p, q = lie.pose_retract(state.p, state.q, torch.zeros_like(state.p)
                            .repeat(1, 2))
    r = _residual_lk(state.pts[:, None, :], prob.obs, p[None],
                     q[None]) * prob.mask[..., None]
    dp = (state.p - prob.prior_p) * prob.pose_free[:, None]
    return 0.5 * torch.sum(r * r) + 0.5 * (prob.prior_w ** 2) * torch.sum(
        dp * dp)


def _solve_ba_core(state: BAState, prob: BAProblem, iters: int):
    lam = torch.tensor(1e-4, dtype=state.p.dtype, device=state.p.device)
    cost = _ba_cost(state, prob)
    hist = []
    for _ in range(iters):
        cand, _ = _lm_iteration(state, prob, lam)
        new_cost = _ba_cost(cand, prob)
        good = torch.isfinite(new_cost) & (new_cost < cost)
        state = BAState(*(torch.where(good, b, a)
                          for a, b in zip(state, cand)))
        cost = torch.where(good, new_cost, cost)
        lam = torch.clamp(torch.where(good, lam * 0.3, lam * 10.0),
                          1e-9, 1e3)
        hist.append(cost)
    return state, cost, torch.stack(hist)


def _materialize_prior(state: BAState, prob: BAProblem) -> BAProblem:
    """Absent prior fields as an inert (zero-weight) prior."""
    if prob.prior_p is not None:
        return prob
    return prob._replace(prior_p=torch.zeros_like(state.p),
                         prior_w=torch.zeros((), dtype=state.p.dtype,
                                             device=state.p.device))


def solve_ba(state: BAState, prob: BAProblem, iters: int = 10):
    """LM Schur BA on one device. Returns (state, final cost, per-iteration
    costs [iters]), all on the state's device."""
    return _solve_ba_core(state, _materialize_prior(state, prob), iters)
