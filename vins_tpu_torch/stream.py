"""Streaming block path: a block of camera frames through the whole
per-frame pipeline (port of vins_tpu/stream.py).

precompute_block runs CLAHE, the pyramid and the Scharr gradients for
the whole block in batched ops; vio_scan_step then runs one frame:
tracking (K1 forward and backward, K2), F-RANSAC, top-up on backend
frames, the 30 Hz pose (dead-reckoned, or solved as
cfg.solver.pnp_stream_solve asks), and on every freq-th frame the
ride-time loop attach, the sliding-window backend with the pnp re-sync
and the loop constraint's lifecycle. The JAX scan's phase, pending-chunk
flag and solver budget are known on the host here, so the backend branch
is a Python `if` with no device sync. Whether a staged loop anchor may
still be pending is host-known too (ScanState.anchor_live: set when the
host stages one, cleared when a sync shows it done); while it is, the
attach is computed on every backend frame and selected by the device
flags, as the JAX scan's lax.cond would pick it.
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
from .ops import brief as brief_mod
from .ops import image as image_mod
from .utils import lie


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


class LoopAnchor(NamedTuple):
    """A verified loop hit staged for ride-time attachment: the OLD
    keyframe's descriptors and normalized observations, matched against
    the live frame's features at the next backend frames (so the join is
    fresh whatever the detection latency), and its PnP-refined pose."""

    desc_old: torch.Tensor   # [Nf, 8] int32 BRIEF words of the old kf
    ok_old: torch.Tensor     # [Nf] bool
    obs_old: torch.Tensor    # [Nf, 2] normalized obs in the old kf
    p_init: torch.Tensor     # [3] PnP-refined old pose (raw odometry frame)
    q_init: torch.Tensor     # [4]
    ttl: torch.Tensor        # [] int32 backend frames left to try
    pending: torch.Tensor    # [] bool attach not yet done

    @staticmethod
    def inactive(Nf: int, dtype=torch.float32, device="cpu") -> "LoopAnchor":
        return LoopAnchor(
            desc_old=torch.zeros((Nf, 8), dtype=torch.int32, device=device),
            ok_old=torch.zeros((Nf,), dtype=torch.bool, device=device),
            obs_old=torch.zeros((Nf, 2), dtype=dtype, device=device),
            p_init=torch.zeros((3,), dtype=dtype, device=device),
            q_init=lie.quat_identity(dtype, device),
            ttl=torch.zeros((), dtype=torch.int32, device=device),
            pending=torch.zeros((), dtype=torch.bool, device=device))


class ScanState(NamedTuple):
    """Everything carried frame to frame by the block pipeline."""

    tracker: tr_mod.TrackerState
    pnp: pnp_mod.PnpWindow
    est: BackendState
    pending: pre_mod.ImuChunk    # IMU accumulated since the last backend frame
    has_pending: bool            # host-known
    phase: int                   # host-known; 0 = backend frame
    loop: LoopInput              # active loop constraint (weight 0 = none)
    anchor: LoopAnchor           # staged hit awaiting attachment
    anchor_live: bool            # host-known: the anchor may be pending
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


def _tracker_world_points(est: BackendState, tracker: tr_mod.TrackerState,
                          ext: Extrinsics):
    """The landmarks' world points in tracker-slot order and which slots
    have one (what a keyframe insert stores)."""
    win = est.window
    pts_w, has = _gather_by_id(
        tracker.ids, est.feats.track_id,
        landmark_world_points(win, est.feats, ext),
        est.feats.valid & (win.inv_depth > 1e-3))
    return pts_w, has & tracker.valid


def _nanmedian(x: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Median of x over sel as jnp.nanmedian takes it (the mean of the
    two middle values for an even count: low*(1-h) + high*h, h = 0 or
    ½), NaN for an empty selection; computed without a host sync."""
    n = torch.sum(sel)
    s, _ = torch.sort(torch.where(sel, x, float("inf")))
    pos = 0.5 * (n - 1).to(x.dtype)
    lo = torch.floor(pos)
    hw = pos - lo
    lo_i = torch.clamp(lo.long(), 0, x.shape[0] - 1)
    hi_i = torch.clamp(torch.ceil(pos).long(), 0, x.shape[0] - 1)
    med = s[lo_i] * (1.0 - hw) + s[hi_i] * hw
    return torch.where(n > 0, med, float("nan"))


def _attach_loop(est: BackendState, anchor: LoopAnchor, loop_prev: LoopInput,
                 tracker: tr_mod.TrackerState, img: torch.Tensor,
                 cfg: VinsConfig, ext: Extrinsics):
    """Ride-time loop attachment: match the staged old keyframe's
    descriptors against the live frame's features (BRIEF from the RAW
    frame, as the DB's descriptors are), keep the matches whose landmarks
    reproject through the old pose near the consensus (median) offset,
    and slot-align them with the landmark table. Returns (LoopInput —
    the new block where >= 10 slots attach, else loop_prev — and good)."""
    lp = cfg.loop
    F = cfg.window.num_frames
    desc_cur = brief_mod.extract_brief(img, tracker.pts, tracker.valid)
    m = brief_mod.match_descriptors(
        desc_cur, anchor.desc_old, tracker.valid, anchor.ok_old,
        max_dist=lp.match_max_dist, ratio=lp.match_ratio)
    win = est.window
    ptw = landmark_world_points(win, est.feats, ext)
    ptw_t, has_w = _gather_by_id(tracker.ids, est.feats.track_id, ptw,
                                 est.feats.valid & (win.inv_depth > 1e-3))
    R_old = lie.quat_to_rotmat(anchor.q_init)
    R_ic = lie.quat_to_rotmat(ext.qic)
    Xc = ((ptw_t - anchor.p_init) @ R_old - ext.tic) @ R_ic
    z = Xc[:, 2]
    proj = Xc[:, :2] / torch.clamp(z, min=1e-3)[:, None]
    obs_m = anchor.obs_old[m.idx.long()]
    d = proj - obs_m
    err = torch.sqrt(torch.sum(d * d, -1))
    sel = m.ok & has_w & (z > 0.1)
    med = _nanmedian(err, sel)
    med = torch.where(torch.isfinite(med), med, 1e6)
    row_ok = (sel & (torch.abs(err - med) < lp.attach_gate)
              & (err < lp.attach_max))
    obs_slot, ok_slot = _gather_by_id(est.feats.track_id, tracker.ids, obs_m,
                                      row_ok)
    ok_slot = ok_slot & (est.feats.track_id >= 0)
    good = torch.sum(ok_slot) >= 10
    loop_new = LoopInput(
        obs_old=obs_slot, ok=ok_slot, ids=est.feats.track_id,
        p_init=anchor.p_init, q_init=anchor.q_init,
        ttl=torch.full((), F, dtype=torch.int32, device=z.device),
        weight=torch.where(good, 1.0, 0.0).to(z.dtype))
    return _sel(good, loop_new, loop_prev), good


def vio_scan_step(state: ScanState, pyr, grads, img: torch.Tensor,
                  chunk: pre_mod.ImuChunk, cfg: VinsConfig, ext: Extrinsics,
                  gravity: torch.Tensor, use_pnp: bool = True,
                  gumbel: Optional[torch.Tensor] = None
                  ) -> Tuple[ScanState, ScanOutput]:
    """One camera frame of the block pipeline. pyr/grads: this frame's
    precomputed prep; img: the raw frame (the ride-time attach extracts
    BRIEF from it); gumbel: optional RANSAC noise for this frame."""
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
        # "all" solves every frame, "deadreckon" none, any other mode the
        # frames whose pose the backend does not publish.
        pnp, (p30, q30, _v30) = pnp_mod.pnp_step(
            state.pnp, chunk, obs_l, has_l, cfg, ext, gravity,
            do_solve=(mode == "all"
                      or (mode != "deadreckon" and not is_backend)),
            update_preints=(mode != "deadreckon"))
    else:
        pnp = state.pnp
        p30 = state.est.window.p[F - 1]
        q30 = state.est.window.q[F - 1]

    false = torch.zeros((), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    est, loop, anchor = state.est, state.loop, state.anchor
    if is_backend:
        loop_in, anchor_expired = state.loop, false
        if state.anchor_live:
            # One attach per staged hit, only while no constraint rides.
            att_try = (anchor.pending & (anchor.ttl > 0)
                       & (state.loop.weight <= 0))
            loop_att, good = _attach_loop(state.est, anchor, state.loop,
                                          tracker, img, cfg, ext)
            attached = att_try & good
            loop_in = _sel(att_try, loop_att, state.loop)
            ttl_a = torch.where(anchor.pending, anchor.ttl - 1, anchor.ttl)
            anchor_expired = anchor.pending & ~attached & (ttl_a <= 0)
            anchor = anchor._replace(
                ttl=ttl_a, pending=anchor.pending & ~attached & (ttl_a > 0))
        inp = FrameInput(chunk=merged, ids=front.ids, obs=front.obs,
                         obs_valid=front.obs_valid, loop=loop_in,
                         iter_budget=state.solver_budget)
        est2, out = backend_step(state.est, inp, cfg, ext, gravity)
        # Freeze on failure (the host decides the recovery between blocks).
        est = _sel(out.failure, state.est, est2)
        pnp = _sync_pnp(pnp, est, cfg, ext)
        kf_pts_w, kf_w_ok = _tracker_world_points(est, tracker, ext)
        # Loop-constraint lifecycle: it rides while enough matched tracks
        # survive and its TTL lasts; retirement (or an anchor that expired
        # unattached) triggers the host's pose-graph run.
        active = loop_in.weight > 0
        ttl2 = torch.where(active, loop_in.ttl - 1, loop_in.ttl)
        retired = active & ((ttl2 <= 0) | (out.loop_support < 10))
        loop = loop_in._replace(
            ttl=ttl2, weight=torch.where(retired | out.failure, 0.0,
                                         loop_in.weight))
        p_out, q_out = out.pose_p, out.pose_q
        is_kf, failure, cost = out.is_keyframe, out.failure, \
            out.stats.final_cost
        pcl = out.point_cloud.to(torch.float16)
        pcl_ok = out.point_valid
        loop_good = out.loop_good & active
        loop_rel_t, loop_rel_yaw = out.loop_rel_t, out.loop_rel_yaw
        loop_retired = retired | anchor_expired
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
                          anchor=anchor, anchor_live=state.anchor_live,
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
            state, pyr, grad, imgs[k], chunk, cfg, ext, gravity, use_pnp,
            None if gumbel is None else gumbel[k])
        outs.append(out)
    return state, ScanOutput(*[torch.stack(xs) for xs in zip(*outs)])
