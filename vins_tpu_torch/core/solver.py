"""Sliding-window Levenberg–Marquardt with Schur elimination of the
inverse depths (port of vins_tpu/core/solver.py).

The whole problem is one dense whitened Jacobian J [R, D_pose + M]
(prior, IMU and projection rows; D_pose = 15 F, plus 6 loop-pose
columns in the loop variant), H = JᵀJ by one fp32 matmul, the diagonal
landmark block eliminated elementwise, the reduced camera system solved
by Cholesky with an LU fallback selected on the factorization's status
(no host sync). The reference's early-exit LM while_loop becomes a
`max_iters` loop whose updates are masked once it has converged or run
out of its budget, which gives the while_loop's result exactly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import VinsConfig
from ..utils import lie
from . import preintegration as pre_mod
from .factors import (Extrinsics, cauchy_rho, cauchy_weight,
                      imu_factor_local, projection_factor_local)
from .state import (FeatureTable, PriorFactor, WindowState, retract_window,
                    state_boxminus)


class SolveStats(NamedTuple):
    final_cost: torch.Tensor
    initial_cost: torch.Tensor
    visual_cost: torch.Tensor
    visual_factor_num: torch.Tensor
    accepted_iters: torch.Tensor
    final_lambda: torch.Tensor


class LoopProblem(NamedTuple):
    obs_old: torch.Tensor   # [M, 2]
    ok: torch.Tensor        # [M] bool
    frame: torch.Tensor     # [] int32
    weight: torch.Tensor    # [] 1 active / 0 inert


class WindowProblem(NamedTuple):
    feats: FeatureTable
    preints: pre_mod.Preintegration   # stacked over W edges
    prior: PriorFactor
    ext: Extrinsics
    gravity: torch.Tensor             # [3]
    sqrt_info_proj: torch.Tensor      # [] focal / 1.5
    frame_free: torch.Tensor          # [F] 1 free / 0 frozen
    loop: Optional[LoopProblem] = None


class ProjSelection(NamedTuple):
    fj: torch.Tensor   # [P] observing frame
    mm: torch.Tensor   # [P] landmark slot
    w: torch.Tensor    # [P] 1 active / 0 padding


def select_proj_factors(prob: WindowProblem, P: int) -> ProjSelection:
    """Compact the valid (frame, slot) cells into P factor slots, longest
    tracks first, ties on flat grid order."""
    F, M = prob.feats.mask.shape
    P = min(P, F * M)
    dev = prob.gravity.device
    fj = torch.arange(F, device=dev).repeat_interleave(M)
    mm = torch.arange(M, device=dev).repeat(F)
    w_valid = _proj_factor_mask(prob, fj, mm)
    n = fj.shape[0]
    track_len = torch.sum(prob.feats.mask, 0).to(w_valid.dtype)
    score = (w_valid * (1.0 + track_len[mm]) * (2.0 * n)
             - torch.arange(n, dtype=w_valid.dtype, device=dev))
    order = torch.topk(score, P).indices    # scores are distinct
    return ProjSelection(fj=fj[order], mm=mm[order], w=w_valid[order])


def select_loop_factors(prob: WindowProblem, P: int) -> ProjSelection:
    lp = prob.loop
    M = prob.feats.mask.shape[1]
    P = min(P, M)
    dev = prob.gravity.device
    mm = torch.arange(M, device=dev)
    a = prob.feats.anchor.long()
    valid = (lp.ok & prob.feats.valid & prob.feats.mask[a, mm]
             & (prob.feats.track_id >= 0))
    w_valid = valid.to(prob.gravity.dtype) * lp.weight
    score = w_valid * (2.0 * M) - torch.arange(M, dtype=w_valid.dtype,
                                               device=dev)
    order = torch.topk(score, P).indices
    return ProjSelection(fj=a[order], mm=mm[order], w=w_valid[order])


def _proj_factor_mask(prob: WindowProblem, fj, mm) -> torch.Tensor:
    feats = prob.feats
    a = feats.anchor.long()[mm]
    return (feats.valid[mm] & feats.mask[fj, mm] & feats.mask[a, mm]
            & (fj != a)).to(prob.gravity.dtype)


def _place_blocks(J_blocks: torch.Tensor, cols: torch.Tensor,
                  D: int) -> torch.Tensor:
    """[K, R, C] blocks + [K, C] column indices -> dense [K, R, D]
    (duplicate columns add, as the reference's one-hot contraction)."""
    K, R, C = J_blocks.shape
    out = J_blocks.new_zeros((K, R, D))
    return out.scatter_add_(2, cols[:, None, :].expand(K, R, C).long(),
                            J_blocks)


def _edge_slices(state: WindowState):
    """Per-edge (frame e, frame e+1) state slices for the W = F-1 edges."""
    return (state.p[:-1], state.q[:-1], state.v[:-1], state.ba[:-1],
            state.bg[:-1], state.p[1:], state.q[1:], state.v[1:],
            state.ba[1:], state.bg[1:])


def _linearize(state: WindowState, prob: WindowProblem, cfg: VinsConfig,
               S_imu: torch.Tensor, sel: ProjSelection, loop_pq=None,
               sel_loop: Optional[ProjSelection] = None):
    """Dense whitened (J [R, D], r [R]) at `state`, plus the robust cost
    and the visual-cost statistics."""
    F, M = prob.feats.mask.shape
    dtype, dev = state.p.dtype, state.p.device
    D_c = 15 * F
    D_pose = D_c + (6 if prob.loop is not None else 0)
    D = D_pose + M
    W = F - 1
    K = sel.fj.shape[0]
    c = cfg.solver.cauchy_c
    ar = lambda n: torch.arange(n, device=dev)

    # Prior rows.
    dx = state_boxminus(state, prob.prior)
    r_prior = (prob.prior.r + prob.prior.J @ dx) * prob.prior.weight
    J_top = torch.nn.functional.pad(prob.prior.J * prob.prior.weight,
                                    (0, D - D_c))

    # IMU rows.
    r_imu, J_imu = imu_factor_local(prob.preints, *_edge_slices(state),
                                    prob.gravity, S_imu)
    free_i = prob.frame_free[:W]
    free_j = prob.frame_free[1:]
    col_scale = torch.cat([free_i[:, None].expand(W, 15),
                           free_j[:, None].expand(W, 15)], 1)
    J_imu = J_imu * col_scale[:, None, :]
    cols_imu = 15 * ar(W)[:, None] + ar(30)[None, :]
    J_imu_full = _place_blocks(J_imu, cols_imu, D).reshape(15 * W, D)

    # Projection rows.
    fj, mm, w_valid = sel.fj, sel.mm, sel.w
    a = prob.feats.anchor.long()[mm]
    obs = prob.feats.obs
    r_proj, J_proj = projection_factor_local(
        obs[a, mm], obs[fj, mm], state.p[a], state.q[a], state.p[fj],
        state.q[fj], state.inv_depth[mm], prob.ext, prob.sqrt_info_proj)
    ok = w_valid[:, None] > 0
    r_proj = torch.where(ok, r_proj, 0.0)
    J_proj = torch.where(ok[:, :, None], J_proj, 0.0)
    w_rob = cauchy_weight(r_proj, c)
    scale = w_rob * w_valid[:, None]
    r_proj_w = r_proj * scale
    J_proj_w = J_proj * scale[:, :, None]
    col_free = torch.cat([
        prob.frame_free[a][:, None].expand(K, 6),
        prob.frame_free[fj][:, None].expand(K, 6),
        torch.ones((K, 1), dtype=dtype, device=dev)], 1)
    J_proj_w = J_proj_w * col_free[:, None, :]
    cols_p = torch.cat([15 * a[:, None] + ar(6)[None, :],
                        15 * fj[:, None] + ar(6)[None, :],
                        D_pose + mm[:, None]], 1)
    J_proj_full = _place_blocks(J_proj_w, cols_p, D).reshape(2 * K, D)

    rows = [J_top, J_imu_full, J_proj_full]
    res = [r_prior, r_imu.reshape(-1), r_proj_w.reshape(-1)]
    s = torch.sum(r_proj * r_proj, -1)
    cost = (0.5 * torch.sum(r_prior * r_prior)
            + 0.5 * torch.sum(r_imu * r_imu)
            + 0.5 * torch.sum(cauchy_rho(s, c) * w_valid))
    vis_cost = torch.sum(s * w_valid)
    vis_num = torch.sum(w_valid)

    # Loop-reprojection rows against the free loop pose (VINS.cpp:571-637).
    if prob.loop is not None:
        loop_p, loop_q = loop_pq
        lm, wl = sel_loop.mm, sel_loop.w
        al = prob.feats.anchor.long()[lm]
        Kl = lm.shape[0]
        r_lp, J_lp = projection_factor_local(
            obs[al, lm], prob.loop.obs_old[lm], state.p[al], state.q[al],
            loop_p.expand(Kl, 3), loop_q.expand(Kl, 4),
            state.inv_depth[lm], prob.ext, prob.sqrt_info_proj)
        okl = wl[:, None] > 0
        r_lp = torch.where(okl, r_lp, 0.0)
        J_lp = torch.where(okl[:, :, None], J_lp, 0.0)
        scale_l = cauchy_weight(r_lp, c) * wl[:, None]
        r_lp_w = r_lp * scale_l
        J_lp_w = J_lp * scale_l[:, :, None]
        colf = torch.cat([prob.frame_free[al][:, None].expand(Kl, 6),
                          torch.ones((Kl, 7), dtype=dtype, device=dev)], 1)
        J_lp_w = J_lp_w * colf[:, None, :]
        cols_l = torch.cat([15 * al[:, None] + ar(6)[None, :],
                            (D_c + ar(6))[None, :].expand(Kl, 6),
                            D_pose + lm[:, None]], 1)
        rows.append(_place_blocks(J_lp_w, cols_l, D).reshape(2 * Kl, D))
        res.append(r_lp_w.reshape(-1))
        s_l = torch.sum(r_lp * r_lp, -1)
        cost = cost + 0.5 * torch.sum(cauchy_rho(s_l, c) * wl)

    return torch.cat(rows, 0), torch.cat(res), cost, vis_cost, vis_num


def _schur_solve(J: torch.Tensor, r: torch.Tensor, lam: torch.Tensor,
                 D_c: int, landmark_active: torch.Tensor):
    """Damped normal equations with the diagonal landmark block
    eliminated; Cholesky, or LU where the Cholesky fails."""
    H = J.T @ J
    g = J.T @ r
    H_cc = H[:D_c, :D_c]
    H_cl = H[:D_c, D_c:]
    h_ll = torch.diagonal(H[D_c:, D_c:])
    g_c, g_l = g[:D_c], g[D_c:]
    d_c = torch.diagonal(H_cc)
    H_cc_d = H_cc + torch.diag(lam * d_c + 1e-8 + lam)
    h_ll_d = h_ll + lam * h_ll + 1e-8 + lam
    inv_hll = torch.where(landmark_active > 0, 1.0 / h_ll_d, 0.0)
    H_s = H_cc_d - (H_cl * inv_hll[None, :]) @ H_cl.T
    g_s = g_c - H_cl @ (inv_hll * g_l)

    L, info = torch.linalg.cholesky_ex(H_s)
    ok = (info == 0) & torch.all(torch.isfinite(L))
    x_chol = torch.cholesky_solve(g_s[:, None], L)[:, 0]
    x_lu = torch.linalg.solve_ex(H_s, g_s)[0]
    dx_c = torch.where(ok, x_chol, x_lu)
    dx_l = inv_hll * (g_l - H_cl.T @ dx_c)
    return -dx_c, -dx_l


def solve_window_with_loop(state: WindowState, loop_p: torch.Tensor,
                           loop_q: torch.Tensor, prob: WindowProblem,
                           cfg: VinsConfig, iter_budget=None):
    """Joint solve of the window and a free loop pose (VINS.cpp:571-637).
    Returns (state, (loop_p, loop_q), stats)."""
    assert prob.loop is not None
    return _solve_window_impl(state, (loop_p, loop_q), prob, cfg,
                              iter_budget)


def solve_window(state: WindowState, prob: WindowProblem, cfg: VinsConfig,
                 iter_budget=None) -> Tuple[WindowState, SolveStats]:
    assert prob.loop is None
    state, _, stats = _solve_window_impl(state, None, prob, cfg,
                                         iter_budget)
    return state, stats


def _sel(cond: torch.Tensor, a, b):
    """where(cond, a, b) over matching tuples/NamedTuples of tensors."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    vals = [_sel(cond, x, y) for x, y in zip(a, b)]
    return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)


def _solve_window_impl(state: WindowState, loop_pq, prob: WindowProblem,
                       cfg: VinsConfig, iter_budget=None):
    F, M = prob.feats.mask.shape
    D_c = 15 * F
    D_pose = D_c + (6 if prob.loop is not None else 0)
    dtype, dev = state.p.dtype, state.p.device
    sc = cfg.solver

    sel = select_proj_factors(prob, sc.max_proj_factors)
    sel_loop = (select_loop_factors(prob, sc.max_loop_factors)
                if prob.loop is not None else None)
    if loop_pq is None:
        loop_pq = (torch.zeros(3, dtype=dtype, device=dev),
                   lie.quat_identity(dtype, dev))
    seg = sel.w.new_zeros(M).index_add_(0, sel.mm, sel.w)
    landmark_active = (seg > 0).to(dtype)
    if sel_loop is not None:
        seg_l = sel_loop.w.new_zeros(M).index_add_(0, sel_loop.mm,
                                                   sel_loop.w)
        landmark_active = torch.maximum(landmark_active,
                                        (seg_l > 0).to(dtype))

    S_imu = pre_mod.sqrt_information(prob.preints)
    free15 = prob.frame_free.repeat_interleave(15)

    def retract_all(st, lpq, dx_c, dx_l):
        win = retract_window(st, dx_c[:D_c] * free15, dx_l)
        if prob.loop is None:
            return win, lpq
        return win, lie.pose_retract(lpq[0], lpq[1], dx_c[D_c:D_c + 6])

    J, r, cost0, vis_cost, vis_num = _linearize(state, prob, cfg, S_imu,
                                                sel, loop_pq, sel_loop)
    budget = sc.max_iters if iter_budget is None else \
        min(int(iter_budget), sc.max_iters)

    st, lpq, cost = state, loop_pq, cost0
    lam = torch.full((), sc.lambda_init, dtype=dtype, device=dev)
    accepted = torch.zeros((), dtype=torch.int32, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    small_prev = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(budget):
        live = ~converged
        dx_c, dx_l = _schur_solve(J, r, lam, D_pose, landmark_active)
        dx_l = dx_l * landmark_active
        cand, lpq_c = retract_all(st, lpq, dx_c, dx_l)
        J_c, r_c, new_cost, vis_cost_c, vis_num_c = _linearize(
            cand, prob, cfg, S_imu, sel, lpq_c, sel_loop)
        good = torch.isfinite(new_cost) & (new_cost < cost)
        small = good & (cost - new_cost
                        <= sc.rel_tol * torch.clamp(cost, min=1.0))
        conv_new = small & small_prev & (lam <= sc.lambda_init)
        take = live & good
        st = _sel(take, cand, st)
        lpq = _sel(take, lpq_c, lpq)
        J = torch.where(take, J_c, J)
        r = torch.where(take, r_c, r)
        cost = torch.where(take, new_cost, cost)
        vis_cost = torch.where(take, vis_cost_c, vis_cost)
        vis_num = torch.where(take, vis_num_c, vis_num)
        lam = torch.where(live, torch.clamp(
            torch.where(good, lam * sc.lambda_down, lam * sc.lambda_up),
            sc.lambda_min, sc.lambda_max), lam)
        accepted = accepted + take.to(torch.int32)
        small_prev = torch.where(live, small, small_prev)
        converged = converged | conv_new

    stats = SolveStats(final_cost=cost, initial_cost=cost0,
                       visual_cost=vis_cost, visual_factor_num=vis_num,
                       accepted_iters=accepted, final_lambda=lam)
    return st, lpq, stats
