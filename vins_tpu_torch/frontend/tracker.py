"""KLT front-end step (port of vins_tpu/frontend/tracker.py).

CLAHE → pyramid → forward/backward LK + NCC gate (kernels K1, K2) →
F-RANSAC culling → Shi–Tomasi top-up into free slots. TrackerState
mirrors the JAX type field for field, except that the PRNG key becomes a
torch.Generator (`gen`) for the RANSAC draws; parity tests inject the
JAX draws through `gumbel` instead.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import device as device_mod
from ..config import VinsConfig
from ..ops import corners as corners_mod
from ..ops import image as image_mod
from ..ops import klt as klt_mod
from ..ops import ransac as ransac_mod
from ..utils import camera as cam_mod


class TrackerState(NamedTuple):
    pyr: Tuple[torch.Tensor, ...]    # previous frame pyramid
    grads: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # its (gx, gy)
    pts: torch.Tensor                # [M, 2] pixel positions
    ids: torch.Tensor                # [M] int32 (-1 free)
    track_cnt: torch.Tensor          # [M] int32 frames tracked
    valid: torch.Tensor              # [M] bool
    next_id: torch.Tensor            # [] int32
    gen: torch.Generator             # RANSAC draws (JAX: PRNG key)


class FrontendOutput(NamedTuple):
    ids: torch.Tensor        # [M]
    obs: torch.Tensor        # [M, 2] normalized camera-plane coords
    obs_valid: torch.Tensor  # [M]
    pts_px: torch.Tensor     # [M, 2]
    n_tracked: torch.Tensor  # []


def fresh_state(cfg: VinsConfig, seed: int = 0,
                device="cpu") -> TrackerState:
    M = cfg.frontend.max_features
    H, W = cfg.camera.height, cfg.camera.width
    pyr = tuple(torch.zeros((H >> l, W >> l), device=device)
                for l in range(cfg.frontend.pyramid_levels))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TrackerState(
        pyr=pyr,
        grads=tuple((torch.zeros_like(p), torch.zeros_like(p)) for p in pyr),
        pts=torch.zeros((M, 2), device=device),
        ids=torch.full((M,), -1, dtype=torch.int32, device=device),
        track_cnt=torch.zeros((M,), dtype=torch.int32, device=device),
        valid=torch.zeros((M,), dtype=torch.bool, device=device),
        next_id=torch.zeros((), dtype=torch.int32, device=device),
        gen=gen)


def _scatter_drop(dst: torch.Tensor, slot: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """dst.at[slot].set(src, mode="drop") for slot in [0, len(dst)]."""
    ext = torch.cat([dst, torch.zeros_like(dst[:1])], 0)
    ext[slot] = src.to(dst.dtype)
    return ext[:-1]


def _top_up(pts, ids, track_cnt, valid, next_id, img_eq, cfg: VinsConfig):
    """Detect new corners in unoccupied cells and fill free slots."""
    fe = cfg.frontend
    M = fe.max_features
    need = fe.target_features - torch.sum(valid)
    occ = corners_mod.occupancy_cells(tuple(img_eq.shape), pts, valid,
                                      fe.min_distance)
    resp = corners_mod.shi_tomasi_response(img_eq)
    pick = corners_mod.select_corners_grid(resp, occ, fe.target_features,
                                           fe.min_distance)
    K = pick.pts.shape[0]
    want = pick.valid & (torch.arange(K, device=pts.device) < need)

    is_free = ~valid
    order = torch.argsort((~is_free).to(torch.int32), stable=True)
    rank = torch.cumsum(want.to(torch.int32), 0) - 1
    n_free = torch.sum(is_free.to(torch.int32))
    can = want & (rank < n_free)
    slot = order[torch.clamp(rank, 0, M - 1).long()]
    slot_c = torch.where(can, slot, M)

    new_ids = next_id + torch.cumsum(can.to(torch.int32), 0) - 1
    pts = _scatter_drop(pts, slot_c, pick.pts)
    ids = _scatter_drop(ids, slot_c, new_ids)
    track_cnt = _scatter_drop(track_cnt, slot_c,
                              torch.ones_like(new_ids))
    valid = _scatter_drop(valid, slot_c, torch.ones_like(want))
    next_id = next_id + torch.sum(can.to(torch.int32))
    return pts, ids, track_cnt, valid, next_id.to(torch.int32)


def _prep(img: torch.Tensor, cfg: VinsConfig):
    fe = cfg.frontend
    img_eq = image_mod.clahe(img, fe.clahe_clip, fe.clahe_grid,
                             fe.clahe_bins)
    pyr = tuple(image_mod.build_pyramid(img_eq, fe.pyramid_levels))
    grads = tuple(image_mod.sobel_gradients(p) for p in pyr)
    return pyr, grads


def _make_output(state: TrackerState, cfg: VinsConfig) -> FrontendOutput:
    obs = cam_mod.pixel_to_normalized(cfg.camera, state.pts)
    return FrontendOutput(
        ids=torch.where(state.valid, state.ids, -1).to(torch.int32),
        obs=obs, obs_valid=state.valid, pts_px=state.pts,
        n_tracked=torch.sum(state.valid))


def init_step(state: TrackerState, img: torch.Tensor,
              cfg: VinsConfig) -> Tuple[TrackerState, FrontendOutput]:
    """First frame: equalize, build the pyramid, detect corners."""
    pyr, grads = _prep(img, cfg)
    M = cfg.frontend.max_features
    dev = img.device
    pts, ids, cnt, valid, next_id = _top_up(
        torch.zeros((M, 2), device=dev),
        torch.full((M,), -1, dtype=torch.int32, device=dev),
        torch.zeros((M,), dtype=torch.int32, device=dev),
        torch.zeros((M,), dtype=torch.bool, device=dev),
        state.next_id, pyr[0], cfg)
    new_state = TrackerState(pyr=pyr, grads=grads, pts=pts, ids=ids,
                             track_cnt=cnt, valid=valid, next_id=next_id,
                             gen=state.gen)
    return new_state, _make_output(new_state, cfg)


def track_step(state: TrackerState, img: torch.Tensor, cfg: VinsConfig,
               do_topup: bool = True,
               gumbel: Optional[torch.Tensor] = None
               ) -> Tuple[TrackerState, FrontendOutput]:
    """Track the previous features into `img`, cull, top up."""
    pyr, grads = _prep(img, cfg)
    return track_step_pre(state, pyr, grads, cfg, do_topup, gumbel)


def track_step_pre(state: TrackerState, pyr, grads, cfg: VinsConfig,
                   do_topup: bool = True,
                   gumbel: Optional[torch.Tensor] = None
                   ) -> Tuple[TrackerState, FrontendOutput]:
    """track_step with the frame's pyramid and gradients precomputed.
    gumbel: optional [f_ransac_hyps, M] RANSAC noise; drawn from
    state.gen when absent."""
    fe = cfg.frontend
    img_eq = pyr[0]
    res = klt_mod.track_pyramid_fb(list(state.pyr), list(pyr), state.pts,
                                   state.valid, fe,
                                   grads_prev=list(state.grads),
                                   grads_next=list(grads))
    valid = res.status

    prev_n = cam_mod.pixel_to_normalized(cfg.camera, state.pts)
    cur_n = cam_mod.pixel_to_normalized(cfg.camera, res.pts)
    thresh = (fe.f_ransac_thresh / cfg.camera.focal) ** 2
    rr = ransac_mod.ransac_fundamental(prev_n, cur_n, valid,
                                       fe.f_ransac_hyps, thresh,
                                       gumbel=gumbel, generator=state.gen)
    use_f = torch.sum(valid) >= 12
    valid = torch.where(use_f, valid & rr.inliers, valid)

    ids = torch.where(valid, state.ids, -1).to(torch.int32)
    cnt = torch.where(valid, state.track_cnt + 1, 0).to(torch.int32)
    if do_topup:
        pts, ids, cnt, valid2, next_id = _top_up(
            res.pts, ids, cnt, valid, state.next_id, img_eq, cfg)
    else:
        pts, valid2, next_id = res.pts, valid, state.next_id

    new_state = TrackerState(pyr=tuple(pyr), grads=tuple(grads), pts=pts,
                             ids=ids, track_cnt=cnt, valid=valid2,
                             next_id=next_id, gen=state.gen)
    return new_state, _make_output(new_state, cfg)


class FeatureTracker:
    """Host shell holding the tracker state; device=None means the first
    CUDA card."""

    def __init__(self, cfg: VinsConfig, seed: int = 0, device=None):
        self.cfg = cfg
        self.state = fresh_state(cfg, seed, device_mod.resolve(device))
        self.started = False

    def process(self, img: torch.Tensor, do_topup: bool = True,
                gumbel: Optional[torch.Tensor] = None) -> FrontendOutput:
        if not self.started:
            self.state, out = init_step(self.state, img, self.cfg)
            self.started = True
        else:
            self.state, out = track_step(self.state, img, self.cfg,
                                         do_topup, gumbel)
        return out
