"""Streaming block path: a block of camera frames through the whole
per-frame pipeline (port of vins_tpu/stream.py, loop-closure anchor
left out).

precompute_block runs CLAHE, the pyramid and the Scharr gradients for
the whole block in batched ops; vio_scan_step then runs one frame:
tracking (K1 forward and backward, K2), F-RANSAC, top-up on backend
frames, the dead-reckoned 30 Hz pose, and on every freq-th frame the
sliding-window backend with the pnp re-sync. The JAX scan's phase,
pending-chunk flag and solver budget are known on the host here, so the
backend branch is a Python `if` with no device sync. ScanState.loop
stays, always inactive, until the loop slice is ported.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .config import VinsConfig
from .core import marginalization as marg
from .core import pnp as pnp_mod
from .core import preintegration as pre_mod
from .core.estimator import (BackendState, FrameInput, LoopInput,
                             backend_step, landmark_world_points)
from .core.factors import Extrinsics
from .core.solver import _sel
from .frontend import tracker as tr_mod
from .ops import image as image_mod


def precompute_block(imgs: torch.Tensor, cfg: VinsConfig):
    """Batched image prep of [N, H, W] frames. Returns (pyrs, grads):
    per-level [N, h, w] stacks and per-level ([N,h,w], [N,h,w]) pairs."""
    fe = cfg.frontend
    eq = image_mod.clahe(imgs, fe.clahe_clip, fe.clahe_grid, fe.clahe_bins)
    pyrs = [eq]
    for _ in range(fe.pyramid_levels - 1):
        pyrs.append(image_mod.pyr_down(pyrs[-1]))
    grads = tuple(image_mod.sobel_gradients(p) for p in pyrs)
    return tuple(pyrs), grads


class ScanState(NamedTuple):
    """Everything carried frame to frame by the block pipeline."""

    tracker: tr_mod.TrackerState
    pnp: pnp_mod.PnpWindow
    est: BackendState
    pending: pre_mod.ImuChunk    # IMU accumulated since the last backend frame
    has_pending: bool            # host-known
    phase: int                   # host-known; 0 = backend frame
    loop: LoopInput              # inactive until the loop slice lands
    solver_budget: int           # LM iteration budget


class ScanOutput(NamedTuple):
    """Per-frame outputs (stacked [N, ...] over a block)."""

    p: torch.Tensor
    q: torch.Tensor
    is_backend: torch.Tensor
    is_keyframe: torch.Tensor
    failure: torch.Tensor
    solver_cost: torch.Tensor
    n_tracked: torch.Tensor
    kf_pts_px: torch.Tensor     # [Mw, 2]
    kf_valid: torch.Tensor      # [Mw]
    kf_pts_w: torch.Tensor      # [Mw, 3]
    kf_w_ok: torch.Tensor       # [Mw]
    kf_ids: torch.Tensor        # [Mw]
    point_cloud: torch.Tensor   # [M, 3] float16
    point_valid: torch.Tensor   # [M]
    loop_good: torch.Tensor
    loop_rel_t: torch.Tensor
    loop_rel_yaw: torch.Tensor
    loop_retired: torch.Tensor
    packed: torch.Tensor        # [18] float32, PACK_* columns


PACK_P = slice(0, 3)
PACK_Q = slice(3, 7)
PACK_COST = 7
PACK_IS_BE = 8
PACK_IS_KF = 9
PACK_FAIL = 10
PACK_NTRACK = 11
PACK_LGOOD = 12
PACK_LYAW = 13
PACK_LRET = 14
PACK_LREL_T = slice(15, 18)


def _gather_by_id(dst_ids, src_ids, src_vals, src_valid):
    """For each dst id, the matching src slot's value(s) and a found mask."""
    eq = ((dst_ids[:, None] == src_ids[None, :])
          & (src_ids[None, :] >= 0) & src_valid[None, :]
          & (dst_ids[:, None] >= 0))
    has = torch.any(eq, 1)
    j = torch.argmax(eq.to(torch.int32), 1)
    if isinstance(src_vals, torch.Tensor):
        return src_vals[j], has
    return tuple(v[j] for v in src_vals), has


def _sync_pnp(pnp: pnp_mod.PnpWindow, est: BackendState, cfg: VinsConfig,
              ext: Extrinsics) -> pnp_mod.PnpWindow:
    """Anchor the pnp window at the newest backend solution and refresh its
    fixed landmark map (ViewController.mm:731-758)."""
    F = cfg.window.num_frames
    S = cfg.window.pnp_size + 1
    win = est.window
    pnp = pnp_mod.anchor_from_backend(pnp, S - 1, win.p[F - 1],
                                      win.q[F - 1], win.v[F - 1],
                                      win.ba[F - 1], win.bg[F - 1])
    pts_w = landmark_world_points(win, est.feats, ext)
    valid = est.feats.valid & (win.inv_depth > 1e-3)
    track_len = torch.sum(est.feats.mask, 0)
    return pnp_mod.update_features(pnp, pts_w, valid, track_len)


def vio_scan_step(state: ScanState, pyr, grads, chunk: pre_mod.ImuChunk,
                  cfg: VinsConfig, ext: Extrinsics, gravity: torch.Tensor,
                  use_pnp: bool = True,
                  gumbel: Optional[torch.Tensor] = None
                  ) -> Tuple[ScanState, ScanOutput]:
    """One camera frame of the block pipeline. pyr/grads: this frame's
    precomputed prep; gumbel: optional RANSAC noise for this frame."""
    F = cfg.window.num_frames
    Mw = cfg.frontend.max_features
    M = cfg.window.max_landmarks
    dtype, dev = gravity.dtype, gravity.device
    is_backend = state.phase == 0
    do_topup = cfg.frontend.topup_every_frame or is_backend
    tracker, front = tr_mod.track_step_pre(state.tracker, pyr, grads, cfg,
                                           do_topup=do_topup, gumbel=gumbel)
    merged = (marg.merge_chunks(state.pending, chunk) if state.has_pending
              else chunk)

    if use_pnp:
        mode = cfg.solver.pnp_stream_solve
        obs_l, has_l = _gather_by_id(state.est.feats.track_id, front.ids,
                                     front.obs, front.obs_valid)
        pnp, (p30, q30, _v30) = pnp_mod.pnp_step(
            state.pnp, chunk, obs_l, has_l, cfg, ext, gravity,
            do_solve=(mode == "all"
                      or (mode == "nonbackend" and not is_backend)),
            update_preints=(mode != "deadreckon"))
    else:
        pnp = state.pnp
        p30 = state.est.window.p[F - 1]
        q30 = state.est.window.q[F - 1]

    false = torch.zeros((), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    est, loop = state.est, state.loop
    if is_backend:
        inp = FrameInput(chunk=merged, ids=front.ids, obs=front.obs,
                         obs_valid=front.obs_valid, loop=state.loop,
                         iter_budget=state.solver_budget)
        est2, out = backend_step(state.est, inp, cfg, ext, gravity)
        # Freeze on failure (the host decides the recovery between blocks).
        est = _sel(out.failure, state.est, est2)
        pnp = _sync_pnp(pnp, est, cfg, ext)
        win = est.window
        pts_w = landmark_world_points(win, est.feats, ext)
        kf_pts_w, has_t = _gather_by_id(
            tracker.ids, est.feats.track_id, pts_w,
            est.feats.valid & (win.inv_depth > 1e-3))
        kf_w_ok = has_t & tracker.valid
        active = state.loop.weight > 0
        ttl2 = torch.where(active, state.loop.ttl - 1, state.loop.ttl)
        retired = active & ((ttl2 <= 0) | (out.loop_support < 10))
        loop = state.loop._replace(
            ttl=ttl2, weight=torch.where(retired | out.failure, 0.0,
                                         state.loop.weight))
        p_out, q_out = out.pose_p, out.pose_q
        is_kf, failure, cost = out.is_keyframe, out.failure, \
            out.stats.final_cost
        pcl = out.point_cloud.to(torch.float16)
        pcl_ok = out.point_valid
        loop_good = out.loop_good & active
        loop_rel_t, loop_rel_yaw = out.loop_rel_t, out.loop_rel_yaw
        loop_retired = retired
    else:
        p_out, q_out = p30, q30
        is_kf, failure, cost = false, false, zero
        kf_pts_w = torch.zeros((Mw, 3), dtype=dtype, device=dev)
        kf_w_ok = torch.zeros((Mw,), dtype=torch.bool, device=dev)
        pcl = torch.zeros((M, 3), dtype=torch.float16, device=dev)
        pcl_ok = torch.zeros((M,), dtype=torch.bool, device=dev)
        loop_good, loop_retired = false, false
        loop_rel_t = torch.zeros(3, dtype=dtype, device=dev)
        loop_rel_yaw = zero

    pending = (pre_mod.ImuChunk(*[torch.zeros_like(x) for x in merged])
               if is_backend else merged)
    new_state = ScanState(tracker=tracker, pnp=pnp, est=est,
                          pending=pending, has_pending=not is_backend,
                          phase=(state.phase + 1) % cfg.freq, loop=loop,
                          solver_budget=state.solver_budget)
    f32 = torch.float32
    is_be_t = torch.full((), is_backend, dtype=torch.bool, device=dev)
    packed = torch.cat([
        p_out.to(f32), q_out.to(f32),
        torch.stack([cost.to(f32), is_be_t.to(f32), is_kf.to(f32),
                     failure.to(f32), front.n_tracked.to(f32),
                     loop_good.to(f32), loop_rel_yaw.to(f32),
                     loop_retired.to(f32)]),
        loop_rel_t.to(f32)])
    out = ScanOutput(
        p=p_out, q=q_out, is_backend=is_be_t, is_keyframe=is_kf,
        failure=failure, solver_cost=cost, n_tracked=front.n_tracked,
        kf_pts_px=tracker.pts, kf_valid=tracker.valid, kf_pts_w=kf_pts_w,
        kf_w_ok=kf_w_ok, kf_ids=tracker.ids, point_cloud=pcl,
        point_valid=pcl_ok, loop_good=loop_good, loop_rel_t=loop_rel_t,
        loop_rel_yaw=loop_rel_yaw, loop_retired=loop_retired, packed=packed)
    return new_state, out


def run_vio_scan(state: ScanState, imgs: torch.Tensor,
                 chunks: pre_mod.ImuChunk, cfg: VinsConfig,
                 ext: Extrinsics, gravity: torch.Tensor,
                 use_pnp: bool = True,
                 gumbel: Optional[torch.Tensor] = None
                 ) -> Tuple[ScanState, ScanOutput]:
    """A staged block: imgs [N, H, W], chunks stacked [N, ...], optional
    per-frame RANSAC noise gumbel [N, n_hyps, M]. Returns the final state
    and the per-frame outputs stacked [N, ...]."""
    pyrs, grads = precompute_block(imgs, cfg)
    outs = []
    for k in range(imgs.shape[0]):
        pyr = tuple(p[k] for p in pyrs)
        grad = tuple((g[0][k], g[1][k]) for g in grads)
        chunk = pre_mod.ImuChunk(*[x[k] for x in chunks])
        state, out = vio_scan_step(
            state, pyr, grad, chunk, cfg, ext, gravity, use_pnp,
            None if gumbel is None else gumbel[k])
        outs.append(out)
    return state, ScanOutput(*[torch.stack(xs) for xs in zip(*outs)])
