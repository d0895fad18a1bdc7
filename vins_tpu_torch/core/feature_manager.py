"""Feature-track lifecycle on the dense [F, M] tables (port of
vins_tpu/core/feature_manager.py): slot-allocating ingest, compensated
parallax, closed-form triangulation, failure removal, both slides."""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import VinsConfig
from ..utils import lie
from .factors import Extrinsics
from .state import FeatureTable, WindowState


def _drop_set(dst: torch.Tensor, idx: torch.Tensor,
              src: torch.Tensor) -> torch.Tensor:
    """dst.at[idx].set(src, mode="drop") along axis 0, idx in [0, len];
    out of place (src may be batched under vmap where dst is not)."""
    ext = torch.cat([dst, torch.zeros_like(dst[:1])], 0)
    return ext.index_put((idx.long(),), src.to(dst.dtype))[:-1]


def ingest_frame(feats: FeatureTable, frame_idx: int, ids: torch.Tensor,
                 obs: torch.Tensor,
                 incoming_valid: torch.Tensor) -> FeatureTable:
    """Write one frame's tracked features into row `frame_idx`: matched
    ids update their slot, new ids take free slots in index order."""
    M = feats.track_id.shape[0]
    incoming_valid = incoming_valid & (ids >= 0)
    eq = ((ids[:, None] == feats.track_id[None, :])
          & (feats.track_id[None, :] >= 0))
    has_match = torch.any(eq, 1)
    match_slot = torch.argmax(eq.to(torch.int32), 1)

    is_free = feats.track_id < 0
    order = torch.argsort((~is_free).to(torch.int32), stable=True)
    needs_new = incoming_valid & ~has_match
    new_rank = torch.cumsum(needs_new.to(torch.int32), 0) - 1
    n_free = torch.sum(is_free.to(torch.int32))
    can_alloc = needs_new & (new_rank < n_free)
    alloc_slot = order[torch.clamp(new_rank, 0, M - 1).long()]

    slot = torch.where(has_match, match_slot, alloc_slot)
    write = incoming_valid & (has_match | can_alloc)
    slot_c = torch.where(write, slot, M)

    obs_row = _drop_set(feats.obs[frame_idx], slot_c, obs)
    mask_row = _drop_set(feats.mask[frame_idx], slot_c,
                         torch.ones_like(write))
    obs_new = torch.cat([feats.obs[:frame_idx], obs_row[None],
                         feats.obs[frame_idx + 1:]], 0)
    mask_new = torch.cat([feats.mask[:frame_idx], mask_row[None],
                          feats.mask[frame_idx + 1:]], 0)
    is_new_write = write & ~has_match
    slot_n = torch.where(is_new_write, slot, M)
    anchor_new = _drop_set(feats.anchor, slot_n,
                           torch.full_like(ids, frame_idx))
    track_new = _drop_set(feats.track_id, slot_n, ids)
    n_obs = torch.sum(mask_new, 0)
    valid_new = (track_new >= 0) & (n_obs >= 2)
    return FeatureTable(obs=obs_new, mask=mask_new, anchor=anchor_new,
                        valid=valid_new, track_id=track_new)


def keyframe_parallax(feats: FeatureTable, cfg: VinsConfig,
                      focal: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compensated-parallax keyframe decision on frames F-3, F-2
    (feature_manager.cpp:103-160). Returns (is_keyframe, parallax_px)."""
    F = feats.mask.shape[0]
    i, j = F - 3, F - 2
    both = feats.mask[i] & feats.mask[j] & (feats.track_id >= 0)
    d = feats.obs[j] - feats.obs[i]
    par = torch.sqrt(torch.sum(d * d, -1))
    n = torch.sum(both)
    mean_par = torch.where(n > 0, torch.sum(par * both)
                           / torch.clamp(n, min=1), 0.0)
    mean_par_px = mean_par * focal
    long_tracks = torch.sum(both & (torch.sum(feats.mask, 0) >= 4))
    is_kf = ((n == 0) | (long_tracks < 20)
             | (mean_par_px >= cfg.window.min_parallax_px))
    return is_kf, mean_par_px


def _cam_poses(state: WindowState, ext: Extrinsics):
    R_wb = lie.quat_to_rotmat(state.q)
    R_ic = lie.quat_to_rotmat(ext.qic)
    R_wc = R_wb @ R_ic
    t_wc = state.p + torch.einsum("fij,j->fi", R_wb, ext.tic)
    return R_wc, t_wc


def triangulate(state: WindowState, feats: FeatureTable, ext: Extrinsics,
                cfg: VinsConfig) -> WindowState:
    """Inhomogeneous DLT triangulation (closed-form 3x3 normal equations)
    of valid slots with inverse depth <= 0, in the anchor camera."""
    R_wc, t_wc = _cam_poses(state, ext)
    anchor = feats.anchor.long()
    Ra = R_wc[anchor]
    ta = t_wc[anchor]
    R_rel = torch.einsum("fij,mik->fmjk", R_wc, Ra)
    t_rel = torch.einsum("fij,fmi->fmj", R_wc,
                         ta[None, :, :] - t_wc[:, None, :])
    P = torch.cat([R_rel, t_rel[..., None]], -1)          # [F, M, 3, 4]
    x = feats.obs[..., 0]
    y = feats.obs[..., 1]
    w = feats.mask.to(P.dtype)
    row0 = (x[..., None] * P[..., 2, :] - P[..., 0, :]) * w[..., None]
    row1 = (y[..., None] * P[..., 2, :] - P[..., 1, :]) * w[..., None]
    A = torch.cat([row0, row1], 0).transpose(0, 1)       # [M, 2F, 4]
    B = A[..., :3]
    c = -A[..., 3]
    N = torch.einsum("mra,mrb->mab", B, B)
    b = torch.einsum("mra,mr->ma", B, c)
    n00, n01, n02 = N[:, 0, 0], N[:, 0, 1], N[:, 0, 2]
    n11, n12, n22 = N[:, 1, 1], N[:, 1, 2], N[:, 2, 2]
    c00 = n11 * n22 - n12 * n12
    c01 = n02 * n12 - n01 * n22
    c02 = n01 * n12 - n02 * n11
    c12 = n01 * n02 - n00 * n12
    c22 = n00 * n11 - n01 * n01
    det = n00 * c00 + n01 * c01 + n02 * c02
    big = torch.abs(det) > 1e-12
    det_safe = torch.where(big, det, torch.ones_like(det))
    z = (c02 * b[:, 0] + c12 * b[:, 1] + c22 * b[:, 2]) / det_safe
    depth = torch.where(big, z, cfg.window.init_depth)
    depth = torch.where(depth < 0.1, cfg.window.init_depth, depth)
    need = (feats.valid & (state.inv_depth <= 0)
            & (torch.sum(feats.mask, 0) >= 2))
    return state._replace(inv_depth=torch.where(need, 1.0 / depth,
                                                state.inv_depth))


def remove_failures(state: WindowState, feats: FeatureTable) -> FeatureTable:
    bad = feats.valid & (state.inv_depth < 0)
    return feats._replace(
        valid=feats.valid & ~bad,
        track_id=torch.where(bad, -1, feats.track_id).to(torch.int32),
        mask=feats.mask & ~bad[None, :])


def slide_old(state: WindowState, feats: FeatureTable, ext: Extrinsics,
              cfg: VinsConfig) -> Tuple[FeatureTable, torch.Tensor]:
    """Drop frame 0: shift the grid, re-anchor frame-0 depths to old frame
    1 (removeBackShiftDepth). Returns (feats, inv_depth). Call before
    marginalization.slide_state_old."""
    M = feats.mask.shape[1]
    R_wc, t_wc = _cam_poses(state, ext)
    anchored0 = feats.anchor == 0
    seen1 = feats.mask[1]
    pt_anchor = torch.cat([feats.obs[0], torch.ones_like(feats.obs[0, :, :1])],
                          -1) / torch.clamp(state.inv_depth[:, None],
                                            min=1e-6)
    pt_w = torch.einsum("ij,mj->mi", R_wc[0], pt_anchor) + t_wc[0]
    pt_c1 = torch.einsum("ji,mj->mi", R_wc[1], pt_w - t_wc[1])
    new_depth = pt_c1[:, 2]
    inv1 = torch.where(new_depth > 0.1,
                       1.0 / torch.clamp(new_depth, min=0.1),
                       1.0 / cfg.window.init_depth)

    obs = torch.cat([feats.obs[1:], torch.zeros_like(feats.obs[:1])], 0)
    mask = torch.cat([feats.mask[1:], torch.zeros_like(feats.mask[:1])], 0)
    anchor = torch.clamp(feats.anchor - 1, min=0).to(torch.int32)

    keep0 = anchored0 & seen1 & feats.valid
    drop = feats.valid & anchored0 & ~seen1
    inv_depth = torch.where(keep0, inv1, state.inv_depth)

    n_obs = torch.sum(mask, 0)
    valid = feats.valid & ~drop & (n_obs >= 2)
    track_id = torch.where(drop | (n_obs < 1), -1,
                           feats.track_id).to(torch.int32)
    valid = valid & (track_id >= 0)
    mask = mask & (track_id >= 0)[None, :]
    return FeatureTable(obs=obs, mask=mask, anchor=anchor, valid=valid,
                        track_id=track_id), inv_depth


def slide_new(feats: FeatureTable) -> FeatureTable:
    """Drop the second-newest frame, moving the newest down (removeFront)."""
    F = feats.mask.shape[0]
    obs = feats.obs.clone()
    obs[F - 2] = feats.obs[F - 1]
    obs[F - 1] = 0.0
    mask = feats.mask.clone()
    mask[F - 2] = feats.mask[F - 1]
    mask[F - 1] = False
    anchor = torch.where(feats.anchor == F - 1, F - 2,
                         feats.anchor).to(torch.int32)
    n_obs = torch.sum(mask, 0)
    track_id = torch.where(n_obs < 1, -1, feats.track_id).to(torch.int32)
    valid = feats.valid & (n_obs >= 2) & (track_id >= 0)
    mask = mask & (track_id >= 0)[None, :]
    return FeatureTable(obs=obs, mask=mask, anchor=anchor, valid=valid,
                        track_id=track_id)
