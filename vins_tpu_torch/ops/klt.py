"""Pyramidal Lucas–Kanade tracking, batched over feature slots (port of
vins_tpu/ops/klt.py).

Tracking always goes through kernel K1 (ops/klt_cuda.track_pyramid) and
the NCC gate through K2 (ops/klt_cuda.patch_ncc) — their CUDA kernels on
a CUDA tensor, their plain versions on a CPU tensor — so the port has
the numerics of the JAX package's TPU path (early exit at klt_eps). With
klt_eps = 0 they also equal the JAX package's CPU (XLA) path on live
slots. Every post-filter of the reference is kept.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..config import FrontendConfig
from . import klt_cuda
from .image import sobel_gradients


class KltResult(NamedTuple):
    pts: torch.Tensor      # [M, 2] tracked positions (level-0 pixels)
    status: torch.Tensor   # [M] bool
    err: torch.Tensor      # [M]


def track_pyramid(pyr_prev: List[torch.Tensor],
                  pyr_next: List[torch.Tensor], pts_prev: torch.Tensor,
                  valid: torch.Tensor, cfg: FrontendConfig,
                  init_flow: torch.Tensor | None = None,
                  grads_prev=None) -> KltResult:
    """Track [M, 2] level-0 points from prev to next across the pyramid.
    grads_prev: optional per-level (gx, gy) of pyr_prev."""
    grads = (grads_prev if grads_prev is not None
             else [sobel_gradients(p) for p in pyr_prev])
    pts_next, ok, err = klt_cuda.track_pyramid(
        pyr_prev, grads, pyr_next, pts_prev, valid, cfg.klt_window,
        cfg.klt_iters, cfg.klt_eps, init_flow)
    H, W = pyr_next[0].shape
    border = 1.0
    inb = ((pts_next[:, 0] >= border) & (pts_next[:, 0] < W - border)
           & (pts_next[:, 1] >= border) & (pts_next[:, 1] < H - border))
    ok = ok & inb & (err < 0.35) & torch.all(torch.isfinite(pts_next), -1)
    return KltResult(pts=pts_next, status=ok & valid, err=err)


def track_pyramid_fb(pyr_prev: List[torch.Tensor],
                     pyr_next: List[torch.Tensor], pts_prev: torch.Tensor,
                     valid: torch.Tensor, cfg: FrontendConfig,
                     fb_thresh: float = 0.3, grads_prev=None,
                     grads_next=None) -> KltResult:
    """Forward–backward checked tracking plus the zero-mean NCC gate:
    keep tracks whose round trip lands within fb_thresh px and whose
    template/match NCC exceeds 0.5. err is the round-trip distance."""
    fwd = track_pyramid(pyr_prev, pyr_next, pts_prev, valid, cfg,
                        grads_prev=grads_prev)
    bwd = track_pyramid(pyr_next, pyr_prev, fwd.pts, fwd.status, cfg,
                        init_flow=pts_prev - fwd.pts,
                        grads_prev=grads_next)
    d = bwd.pts - pts_prev
    rt = torch.sqrt(torch.sum(d * d, -1))
    ncc = klt_cuda.patch_ncc(pyr_prev[0], pyr_next[0], pts_prev, fwd.pts,
                             cfg.klt_window)
    ok = fwd.status & bwd.status & (rt < fb_thresh) & (ncc > 0.5)
    return KltResult(pts=fwd.pts, status=ok, err=rt)
