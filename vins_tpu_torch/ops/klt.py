"""Pyramidal Lucas–Kanade tracking, batched over feature slots (port of
vins_tpu/ops/klt.py).

One-direction tracking goes through kernel K1 (ops/klt_cuda.track_pyramid)
and forward–backward tracking with the NCC gate through the fused kernel
(ops/klt_cuda.track_fb, one launch per frame) — their CUDA kernels on a
CUDA tensor, their plain versions on a CPU tensor — so the port has the
numerics of the JAX package's TPU path (early exit at klt_eps). With
klt_eps = 0 they also equal the JAX package's CPU (XLA) path on live
slots. The whole system is held to that TPU path at the shipped klt_eps
of 0.01 (tests/test_torch_stream_shipped.py, the Pallas kernels in
interpret mode). Every post-filter of the reference is kept.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..config import FrontendConfig
from . import klt_cuda
from .image import sobel_gradients

NCC_MIN = 0.5    # the NCC gate of vins_tpu/ops/klt.py:203


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
    status = klt_cuda.post_filter(pts_next, ok, err, valid,
                                  pyr_next[0].shape)
    return KltResult(pts=pts_next, status=status, err=err)


def track_pyramid_fb(pyr_prev: List[torch.Tensor],
                     pyr_next: List[torch.Tensor], pts_prev: torch.Tensor,
                     valid: torch.Tensor, cfg: FrontendConfig,
                     fb_thresh: float = 0.3, grads_prev=None,
                     grads_next=None) -> KltResult:
    """Forward–backward checked tracking plus the zero-mean NCC gate:
    keep tracks whose round trip lands within fb_thresh px and whose
    template/match NCC exceeds NCC_MIN. err is the round-trip distance.
    One call of klt_cuda.track_fb: on the card one kernel launch."""
    if grads_prev is None:
        grads_prev = [sobel_gradients(p) for p in pyr_prev]
    if grads_next is None:
        grads_next = [sobel_gradients(p) for p in pyr_next]
    pts, status, rt, _ = klt_cuda.track_fb(
        pyr_prev, grads_prev, pyr_next, grads_next, pts_prev, valid,
        cfg.klt_window, cfg.klt_iters, cfg.klt_eps, fb_thresh, NCC_MIN)
    return KltResult(pts=pts, status=status, err=rt)
