"""Motion-only 30 Hz window, streaming subset (port of
vins_tpu/core/pnp.py): the state types, `window_preints`, `pnp_step` in
the default dead-reckoning mode (no solve, carried preintegrations left
stale), `anchor_from_backend` and `update_features`. The interactive
motion-only solve (`solve_pnp_window`) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import VinsConfig
from ..utils import lie
from . import preintegration as pre_mod
from .factors import Extrinsics


class PnpState(NamedTuple):
    p: torch.Tensor    # [S, 3]
    q: torch.Tensor    # [S, 4]
    v: torch.Tensor    # [S, 3]
    ba: torch.Tensor   # [S, 3]
    bg: torch.Tensor   # [S, 3]

    @staticmethod
    def identity(S: int, dtype=torch.float32, device="cpu") -> "PnpState":
        z = torch.zeros((S, 3), dtype=dtype, device=device)
        return PnpState(p=z, q=lie.quat_identity(dtype, device).repeat(S, 1),
                        v=z.clone(), ba=z.clone(), bg=z.clone())


class PnpFeatures(NamedTuple):
    pts_w: torch.Tensor    # [Mp, 3] fixed world landmarks
    obs: torch.Tensor      # [S, Mp, 2]
    mask: torch.Tensor     # [S, Mp] bool
    weight: torch.Tensor   # [Mp]

    @staticmethod
    def empty(S: int, Mp: int, dtype=torch.float32,
              device="cpu") -> "PnpFeatures":
        return PnpFeatures(
            pts_w=torch.zeros((Mp, 3), dtype=dtype, device=device),
            obs=torch.zeros((S, Mp, 2), dtype=dtype, device=device),
            mask=torch.zeros((S, Mp), dtype=torch.bool, device=device),
            weight=torch.zeros((Mp,), dtype=dtype, device=device))


class PnpWindow(NamedTuple):
    state: PnpState
    feats: PnpFeatures
    chunks: pre_mod.ImuChunk                    # [S-1, N]
    anchored: torch.Tensor                      # [S] bool
    preints: Optional[pre_mod.Preintegration] = None


def window_preints(win: PnpWindow, cfg: VinsConfig) -> pre_mod.Preintegration:
    """Every edge's preintegration at the window's current biases."""
    W = win.state.p.shape[0] - 1
    return pre_mod.propagate(win.chunks, win.state.ba[:W],
                             win.state.bg[:W], cfg.imu)


def _slide(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[1:], x[-1:]], 0)


def pnp_step(win: PnpWindow, chunk: pre_mod.ImuChunk, obs: torch.Tensor,
             obs_mask: torch.Tensor, cfg: VinsConfig, ext: Extrinsics,
             gravity: torch.Tensor, do_solve: bool = False,
             update_preints: bool = False
             ) -> Tuple[PnpWindow, Tuple[torch.Tensor, ...]]:
    """One camera frame: slide, ingest, dead-reckon the newest frame.

    Only the streaming default is ported (cfg.solver.pnp_stream_solve =
    "deadreckon": do_solve=False, update_preints=False — the carried
    preintegrations slide stale and must be rebuilt with window_preints
    before any solve). Returns (window, (p, q, v)) of the newest frame."""
    if do_solve or update_preints:
        raise NotImplementedError(
            "the motion-only solve (solve_pnp_window) is not ported yet; "
            "see ROADMAP.md")
    S = win.state.p.shape[0]
    W = S - 1
    st = PnpState(*[_slide(x) for x in win.state])
    feats = win.feats._replace(
        obs=torch.cat([win.feats.obs[1:], obs[None]], 0),
        mask=torch.cat([win.feats.mask[1:], obs_mask[None]], 0))
    chunks = pre_mod.ImuChunk(*[torch.cat([c[1:], n[None]], 0)
                                for c, n in zip(win.chunks, chunk)])
    anchored = torch.cat([win.anchored[1:], torch.zeros_like(
        win.anchored[:1])], 0)

    p_n, q_n, v_n = pre_mod.propagate_state(
        st.p[W - 1], st.q[W - 1], st.v[W - 1], st.ba[W - 1], st.bg[W - 1],
        chunk, gravity)

    def put(x, val):
        x = x.clone()
        x[W] = val
        return x

    st = PnpState(p=put(st.p, p_n), q=put(st.q, q_n), v=put(st.v, v_n),
                  ba=put(st.ba, st.ba[W - 1]), bg=put(st.bg, st.bg[W - 1]))
    preints = pre_mod.Preintegration(*[_slide(x) for x in win.preints])
    win2 = PnpWindow(state=st, feats=feats, chunks=chunks,
                     anchored=anchored, preints=preints)
    return win2, (st.p[W], st.q[W], st.v[W])


def anchor_from_backend(win: PnpWindow, frame_idx: int, p: torch.Tensor,
                        q: torch.Tensor, v: torch.Tensor, ba: torch.Tensor,
                        bg: torch.Tensor) -> PnpWindow:
    """Inject the newest backend solution at slot frame_idx and freeze it;
    biases update across the whole window."""
    st = win.state
    S = st.p.shape[0]

    def put(x, val):
        x = x.clone()
        x[frame_idx] = val
        return x

    st = PnpState(p=put(st.p, p), q=put(st.q, q), v=put(st.v, v),
                  ba=ba[None].repeat(S, 1), bg=bg[None].repeat(S, 1))
    anchored = win.anchored.clone()
    anchored[frame_idx:frame_idx + 1].fill_(True)   # no host-to-device copy
    return win._replace(state=st, anchored=anchored)


def update_features(win: PnpWindow, pts_w: torch.Tensor,
                    valid: torch.Tensor,
                    track_len: torch.Tensor) -> PnpWindow:
    """Refresh the fixed landmark set from the backend's solved features."""
    w = torch.where(valid, torch.clamp(track_len.to(pts_w.dtype) / 10.0,
                                       max=1.0), 0.0)
    return win._replace(feats=win.feats._replace(pts_w=pts_w, weight=w))
