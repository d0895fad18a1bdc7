"""Motion-only 30 Hz window (port of vins_tpu/core/pnp.py): the
vinsPnP equivalent. A 7-frame window of IMU factors and fixed-landmark
perspective factors, anchored to the newest backend solve by freezing
the frames it solved; `solve_pnp_window` runs a fixed number of LM steps
over its 7·15 pose/velocity/bias unknowns (no landmark columns), and
`pnp_step` slides, ingests, dead-reckons and solves one camera frame.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import VinsConfig
from ..utils import lie
from . import preintegration as pre_mod
from .factors import (Extrinsics, imu_factor_local, local_jacobian,
                      perspective_residual)


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


def _perspective_local(pts_w, obs, p, q, ext: Extrinsics, sqrt_info):
    """(r [P, 2], J [P, 2, 6]) of P fixed-landmark factors wrt the pose
    tangent of their frame."""

    def local(d):
        pp, qq = lie.pose_retract(p, q, d)
        return sqrt_info[:, None] * perspective_residual(pts_w, obs, pp, qq,
                                                         ext)

    return local_jacobian(local, p.shape[0], 6, p.dtype, p.device)


def _imu_local(pre: pre_mod.Preintegration, st: PnpState, gravity,
               S_info):
    """(r [W, 15], J [W, 15, 30]) of every IMU edge wrt both frames'
    tangents."""
    W = st.p.shape[0] - 1
    i, j = slice(0, W), slice(1, W + 1)
    return imu_factor_local(pre, st.p[i], st.q[i], st.v[i], st.ba[i],
                            st.bg[i], st.p[j], st.q[j], st.v[j], st.ba[j],
                            st.bg[j], gravity, S_info)


@functools.lru_cache(maxsize=None)
def _placement(S: int, dtype, device):
    """One-hot column placement of the IMU edges' [15, 30] blocks
    ([W, 30, 15 S]) and of a frame's pose block ([S, 6, 15 S]): the
    Jacobian is assembled by contraction, as the reference does. Cached:
    the tensors are constants and no caller writes to them."""
    D = 15 * S
    T_imu = torch.zeros((S - 1, 30, D), dtype=dtype, device=device)
    T_per = torch.zeros((S, 6, D), dtype=dtype, device=device)
    eye30 = torch.eye(30, dtype=dtype, device=device)
    for e in range(S - 1):
        T_imu[e, :, 15 * e:15 * e + 30] = eye30
    for s in range(S):
        T_per[s, :, 15 * s:15 * s + 6] = eye30[:6, :6]
    return T_imu, T_per


def solve_pnp_window(win: PnpWindow, cfg: VinsConfig, ext: Extrinsics,
                     gravity: torch.Tensor, iters: Optional[int] = None
                     ) -> Tuple[PnpState, torch.Tensor]:
    """Fixed-iteration LM over the motion-only window; anchored frames are
    frozen (their columns zeroed, identity damping). Active factors (a
    live observation of a weighted landmark in a free frame) are
    compacted into cfg.solver.pnp_max_factors slots, newest frame first,
    so that on overflow the oldest frames' factors drop. Each iteration
    linearizes at its candidate and carries (J, r) when it is accepted.
    A failed Cholesky factorization gives a NaN step, a non-finite
    candidate cost and a rejected step, as in the reference, without a
    host sync. Returns (state, cost)."""
    st0 = win.state
    S, Mp = win.feats.mask.shape
    W = S - 1
    dtype, dev = st0.p.dtype, st0.p.device
    focal_info = cfg.camera.focal / 1.5
    if iters is None:
        iters = cfg.solver.pnp_iters
    free = (~win.anchored).to(dtype)                           # [S]
    preints = win.preints if win.preints is not None \
        else window_preints(win, cfg)
    S_all = pre_mod.sqrt_information(preints)

    fgrid = torch.arange(S - 1, -1, -1, device=dev).repeat_interleave(Mp)
    mgrid = torch.arange(Mp, device=dev).repeat(S)
    n = S * Mp
    P = min(cfg.solver.pnp_max_factors, n)
    w_act = (win.feats.mask[fgrid, mgrid] & (win.feats.weight[mgrid] > 0)
             & (free[fgrid] > 0)).to(dtype)
    score = w_act * (2.0 * n) - torch.arange(n, dtype=dtype, device=dev)
    order = torch.topk(score, P).indices
    selF, selM, selW = fgrid[order], mgrid[order], w_act[order]
    sel_si = focal_info * torch.clamp(win.feats.weight[selM], max=1.0)
    pts_sel = win.feats.pts_w[selM]
    obs_sel = win.feats.obs[selF, selM]
    ok = selW[:, None] > 0

    T_imu, T_per = _placement(S, dtype, dev)
    T_per_sel = T_per[selF]                                    # [P, 6, D]
    col_scale = torch.cat([free[:W, None].expand(W, 15),
                           free[1:, None].expand(W, 15)], 1)   # [W, 30]

    def build(st: PnpState):
        r_imu, J_imu = _imu_local(preints, st, gravity, S_all)
        J_imu = J_imu * col_scale[:, None, :]
        r_per, J_per = _perspective_local(pts_sel, obs_sel, st.p[selF],
                                          st.q[selF], ext, sel_si)
        r_per = torch.where(ok, r_per, 0.0)
        J_per = torch.where(ok[:, :, None], J_per, 0.0)
        J = torch.cat([
            torch.einsum("eic,ecd->eid", J_imu, T_imu).reshape(15 * W, -1),
            torch.einsum("pij,pjd->pid", J_per, T_per_sel).reshape(2 * P,
                                                                   -1)], 0)
        return J, torch.cat([r_imu.reshape(-1), r_per.reshape(-1)])

    def retract(st: PnpState, dx):
        d = dx.reshape(S, 15) * free[:, None]
        p, q = lie.pose_retract(st.p, st.q, d[:, 0:6])
        return PnpState(p=p, q=q, v=st.v + d[:, 6:9], ba=st.ba + d[:, 9:12],
                        bg=st.bg + d[:, 12:15])

    J, r = build(st0)
    cost = 0.5 * torch.sum(r * r)
    st = st0
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)
    for _ in range(iters):
        H = J.T @ J
        g = J.T @ r
        H = H + torch.diag(lam * torch.diagonal(H) + 1e-6 + lam)
        L, info = torch.linalg.cholesky_ex(H)
        L = torch.where(info == 0, L, float("nan"))
        dx = -torch.cholesky_solve(g[:, None], L)[:, 0]
        cand = retract(st, dx)
        J_c, r_c = build(cand)
        c2 = 0.5 * torch.sum(r_c * r_c)
        good = torch.isfinite(c2) & (c2 < cost)
        st = PnpState(*[torch.where(good, b, a) for a, b in zip(st, cand)])
        J = torch.where(good, J_c, J)
        r = torch.where(good, r_c, r)
        cost = torch.where(good, c2, cost)
        lam = torch.clamp(torch.where(good, lam * 0.3, lam * 10.0), 1e-9,
                          1e3)
    return st, cost


def pnp_step(win: PnpWindow, chunk: pre_mod.ImuChunk, obs: torch.Tensor,
             obs_mask: torch.Tensor, cfg: VinsConfig, ext: Extrinsics,
             gravity: torch.Tensor, do_solve: bool = True,
             update_preints: bool = True
             ) -> Tuple[PnpWindow, Tuple[torch.Tensor, ...]]:
    """One camera frame at full rate: slide, ingest, dead-reckon the
    newest frame and, with do_solve, run the motion-only solve.
    update_preints=False (the streaming "deadreckon" policy, where no
    solve reads them) slides the carried preintegrations stale instead
    of propagating the new edge; they must be rebuilt with
    window_preints before the next solve. Returns (window, (p, q, v)) of
    the newest frame."""
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
    if not update_preints:
        preints = pre_mod.Preintegration(*[_slide(x) for x in win.preints])
    elif win.preints is not None:
        pre_new = pre_mod.propagate(chunk, st.ba[W - 1], st.bg[W - 1],
                                    cfg.imu)
        preints = pre_mod.Preintegration(*[
            torch.cat([a[1:], b[None]], 0)
            for a, b in zip(win.preints, pre_new)])
    else:
        preints = window_preints(PnpWindow(state=st, feats=feats,
                                           chunks=chunks, anchored=anchored),
                                 cfg)
    win2 = PnpWindow(state=st, feats=feats, chunks=chunks,
                     anchored=anchored, preints=preints)
    if do_solve:
        win2 = win2._replace(state=solve_pnp_window(win2, cfg, ext,
                                                    gravity)[0])
    st = win2.state
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
