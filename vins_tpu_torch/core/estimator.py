"""Sliding-window VIO backend step (port of vins_tpu/core/estimator.py).

backend_step: preintegrate the newest edge (all edges where the bias
estimates drifted), ingest the frame, keyframe decision, dead-reckoned
guess, triangulation, LM/Schur solve (the loop variant, with an inactive
loop block on the streaming path), failure detection, marginalization
and slide. The JAX module's three lax.conds become: both branches and a
select for the repropagation and the prior-less re-anchoring (no sync),
and for the marginalization one host branch on the keyframe flag (one
device-to-host sync per backend frame, the main path) or, with
select=True, both slides and a select (no host read; what vmap and
run_sequence_scan run). Also the backend-only host shell VinsEstimator
and run_sequence_scan, the whole-sequence replay with the state frozen
on failure.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_map

from .. import device as device_mod
from ..config import VinsConfig
from ..utils import lie
from . import feature_manager as fm
from . import marginalization as marg
from . import preintegration as pre_mod
from .factors import Extrinsics
from .solver import (LoopProblem, SolveStats, WindowProblem, _sel,
                     solve_window, solve_window_with_loop)
from .state import FeatureTable, PriorFactor, WindowState


def _stack_chunks(chunk: pre_mod.ImuChunk, W: int) -> pre_mod.ImuChunk:
    return pre_mod.ImuChunk(*[x[None].repeat((W,) + (1,) * x.dim())
                              for x in chunk])


def _slide_chunks_old(chunks: pre_mod.ImuChunk) -> pre_mod.ImuChunk:
    return pre_mod.ImuChunk(*[torch.cat([c[1:], torch.zeros_like(c[:1])], 0)
                              for c in chunks])


def _slide_preints_old(preints: pre_mod.Preintegration):
    return pre_mod.Preintegration(*[torch.cat([p[1:], p[-1:]], 0)
                                    for p in preints])


class BackendState(NamedTuple):
    window: WindowState
    feats: FeatureTable
    chunks: pre_mod.ImuChunk          # [W, N] raw IMU per edge
    preints: pre_mod.Preintegration   # [W]
    prior: PriorFactor
    last_is_kf: torch.Tensor          # [] bool
    failure: torch.Tensor             # [] bool

    @staticmethod
    def fresh(cfg: VinsConfig, device="cpu") -> "BackendState":
        F = cfg.window.num_frames
        M = cfg.window.max_landmarks
        W = F - 1
        chunks = _stack_chunks(
            pre_mod.ImuChunk.empty(cfg.window.max_imu_per_edge,
                                   device=device), W)
        z = torch.zeros((W, 3), device=device)
        return BackendState(
            window=WindowState.identity(F, M, device=device),
            feats=FeatureTable.empty(F, M, device=device),
            chunks=chunks,
            preints=pre_mod.propagate(chunks, z, z, cfg.imu),
            prior=PriorFactor.empty(F, device=device),
            last_is_kf=torch.ones((), dtype=torch.bool, device=device),
            failure=torch.zeros((), dtype=torch.bool, device=device))

    @staticmethod
    def bootstrap(cfg: VinsConfig, window: WindowState, feats: FeatureTable,
                  chunks: pre_mod.ImuChunk, ext: Extrinsics,
                  gravity: torch.Tensor) -> "BackendState":
        """A ready state from a solved window: marginalize the oldest
        frame and slide once, as a normal step's tail does."""
        F = cfg.window.num_frames
        W = F - 1
        dev, dtype = window.p.device, window.p.dtype
        preints = pre_mod.propagate(chunks, window.ba[:W], window.bg[:W],
                                    cfg.imu)
        prob = WindowProblem(
            feats=feats, preints=preints,
            prior=PriorFactor.empty(F, dtype, dev), ext=ext, gravity=gravity,
            sqrt_info_proj=torch.full((), cfg.camera.focal / 1.5,
                                      dtype=dtype, device=dev),
            frame_free=torch.ones(F, dtype=dtype, device=dev))
        prior_new = marg.marginalize_old(window, prob, cfg, bootstrap=True)
        feats_new, inv_new = fm.slide_old(window, feats, ext, cfg)
        win_new = marg.slide_state_old(window)._replace(inv_depth=inv_new)
        return BackendState.fresh(cfg, dev)._replace(
            window=win_new, feats=feats_new,
            chunks=_slide_chunks_old(chunks),
            preints=_slide_preints_old(preints), prior=prior_new)


class LoopInput(NamedTuple):
    obs_old: torch.Tensor   # [M, 2]
    ok: torch.Tensor        # [M] bool
    ids: torch.Tensor       # [M] int32
    p_init: torch.Tensor    # [3]
    q_init: torch.Tensor    # [4]
    ttl: torch.Tensor       # [] int32
    weight: torch.Tensor    # [] 1 active / 0 inert

    @staticmethod
    def inactive(M: int, dtype=torch.float32, device="cpu") -> "LoopInput":
        return LoopInput(
            obs_old=torch.zeros((M, 2), dtype=dtype, device=device),
            ok=torch.zeros((M,), dtype=torch.bool, device=device),
            ids=torch.full((M,), -1, dtype=torch.int32, device=device),
            p_init=torch.zeros((3,), dtype=dtype, device=device),
            q_init=lie.quat_identity(dtype, device),
            ttl=torch.zeros((), dtype=torch.int32, device=device),
            weight=torch.zeros((), dtype=dtype, device=device))


class FrameInput(NamedTuple):
    chunk: pre_mod.ImuChunk
    ids: torch.Tensor          # [Mi] int32
    obs: torch.Tensor          # [Mi, 2]
    obs_valid: torch.Tensor    # [Mi] bool
    loop: Optional[LoopInput] = None
    iter_budget: Optional[int] = None


class BackendOutput(NamedTuple):
    pose_p: torch.Tensor
    pose_q: torch.Tensor
    vel: torch.Tensor
    is_keyframe: torch.Tensor
    parallax_px: torch.Tensor
    failure: torch.Tensor
    stats: SolveStats
    point_cloud: torch.Tensor   # [M, 3]
    point_valid: torch.Tensor   # [M]
    loop_rel_t: torch.Tensor
    loop_rel_yaw: torch.Tensor
    loop_good: torch.Tensor
    loop_support: torch.Tensor


def _failure_detection(prev: WindowState, cur: WindowState,
                       feats: FeatureTable, cfg: VinsConfig) -> torch.Tensor:
    """VINS::failureDetection (VINS.cpp:214-265)."""
    F = cur.p.shape[0]
    norm = lambda x: torch.sqrt(torch.sum(x * x))
    n_tracked = torch.sum(feats.mask[F - 1] & feats.valid)
    dq = lie.quat_mul(lie.quat_conj(prev.q[F - 2]), cur.q[F - 1])
    ang = norm(lie.so3_log(dq))
    return ((n_tracked < cfg.fail_min_features)
            | (norm(cur.bg[F - 1]) > cfg.fail_max_gyr_bias)
            | (norm(cur.ba[F - 1]) > cfg.fail_max_acc_bias)
            | (norm(cur.p[F - 1] - prev.p[F - 2]) > cfg.fail_max_trans_jump)
            | (torch.abs(cur.p[F - 1, 2] - prev.p[F - 2, 2])
               > cfg.fail_max_z_jump)
            | (ang > math.radians(cfg.fail_max_rot_jump_deg))
            | ~torch.all(torch.isfinite(cur.p)))


def landmark_world_points(window: WindowState, feats: FeatureTable,
                          ext: Extrinsics) -> torch.Tensor:
    """[M, 3] world points of the landmarks; slots without a usable depth
    are zeroed."""
    M = feats.track_id.shape[0]
    anchor = feats.anchor.long()
    ok = feats.valid & (window.inv_depth > 1e-3)
    obs_a = feats.obs[anchor, torch.arange(M, device=anchor.device)]
    pt_anchor = torch.cat([obs_a, torch.ones_like(obs_a[:, :1])], -1)
    pt_anchor = pt_anchor / torch.clamp(window.inv_depth[:, None], min=1e-3)
    pt_imu = lie.quat_rotate(ext.qic, pt_anchor) + ext.tic
    pts = lie.quat_rotate(window.q[anchor], pt_imu) + window.p[anchor]
    return torch.where(ok[:, None], pts, 0.0)


def _set_row(x: torch.Tensor, i: int, v: torch.Tensor) -> torch.Tensor:
    """x with row i replaced by v, out of place (v may be batched under
    vmap where x is not)."""
    return torch.cat([x[:i], v[None].to(x.dtype), x[i + 1:]], 0)


def _reanchor(s: WindowState, ref: WindowState) -> WindowState:
    """Re-anchor frame 0's yaw and position to `ref`'s (the first solves
    after init run with an empty prior and a free 4-DoF gauge)."""
    ypr_before = lie.rotmat_to_ypr(lie.quat_to_rotmat(ref.q[0]))
    ypr_after = lie.rotmat_to_ypr(lie.quat_to_rotmat(s.q[0]))
    dyaw = ypr_before[0] - ypr_after[0]
    zero = torch.zeros_like(dyaw)
    R_fix = lie.ypr_to_rotmat(torch.stack([dyaw, zero, zero]))
    q_fix = lie.rotmat_to_quat(R_fix)
    p_fix = ref.p[0] - R_fix @ s.p[0]
    return s._replace(p=s.p @ R_fix.T + p_fix,
                      q=lie.quat_mul(q_fix, s.q), v=s.v @ R_fix.T)


def backend_step(est: BackendState, inp: FrameInput, cfg: VinsConfig,
                 ext: Extrinsics, gravity: torch.Tensor,
                 select: bool = False
                 ) -> Tuple[BackendState, BackendOutput]:
    """One backend frame. select=False (the main path) branches on the
    keyframe flag on the host; select=True computes both slides and
    selects on the device, with no host read, for torch.func.vmap and
    run_sequence_scan."""
    F = cfg.window.num_frames
    W = F - 1
    focal = cfg.camera.focal
    dev = gravity.device

    # 1. Newest edge takes the chunk; repropagate every edge where some
    #    bias estimate drifted from its linearization point.
    chunks = pre_mod.ImuChunk(*[_set_row(a, W - 1, n)
                                for a, n in zip(est.chunks, inp.chunk)])
    pre_new = pre_mod.propagate(inp.chunk, est.window.ba[F - 2],
                                est.window.bg[F - 2], cfg.imu)
    preints = pre_mod.Preintegration(*[_set_row(a, W - 1, n)
                                       for a, n in zip(est.preints, pre_new)])
    dev_a = torch.max(torch.sqrt(torch.sum(
        (est.window.ba[:W] - preints.linearized_ba) ** 2, -1)))
    dev_g = torch.max(torch.sqrt(torch.sum(
        (est.window.bg[:W] - preints.linearized_bg) ** 2, -1)))
    repro = pre_mod.propagate(chunks, est.window.ba[:W], est.window.bg[:W],
                              cfg.imu)
    preints = _sel((dev_a > 0.05) | (dev_g > 0.01), repro, preints)

    # 2-3. Ingest into slot F-1; keyframe decision.
    feats = fm.ingest_frame(est.feats, F - 1, inp.ids, inp.obs,
                            inp.obs_valid)
    is_kf, par_px = fm.keyframe_parallax(feats, cfg, focal)

    # 4. Dead-reckoned guess for the newest frame.
    win = est.window
    p_n, q_n, v_n = pre_mod.propagate_state(
        win.p[F - 2], win.q[F - 2], win.v[F - 2], win.ba[F - 2],
        win.bg[F - 2], inp.chunk, gravity)
    win = win._replace(p=_set_row(win.p, F - 1, p_n),
                       q=_set_row(win.q, F - 1, q_n),
                       v=_set_row(win.v, F - 1, v_n),
                       ba=_set_row(win.ba, F - 1, win.ba[F - 2]),
                       bg=_set_row(win.bg, F - 1, win.bg[F - 2]))

    # 5. Triangulate new landmarks.
    win = fm.triangulate(win, feats, ext, cfg)

    # 6. Solve.
    prob = WindowProblem(
        feats=feats, preints=preints, prior=est.prior, ext=ext,
        gravity=gravity,
        sqrt_info_proj=torch.full((), focal / 1.5, device=dev),
        frame_free=torch.ones(F, device=dev))
    if inp.loop is not None:
        loop_ok = (inp.loop.ok & (feats.track_id == inp.loop.ids)
                   & (inp.loop.ids >= 0))
        prob = prob._replace(loop=LoopProblem(
            obs_old=inp.loop.obs_old, ok=loop_ok,
            frame=torch.zeros((), dtype=torch.int32, device=dev),
            weight=inp.loop.weight))
        solved, (loop_p, loop_q), stats = solve_window_with_loop(
            win, inp.loop.p_init, inp.loop.q_init, prob, cfg,
            iter_budget=inp.iter_budget)
    else:
        solved, stats = solve_window(win, prob, cfg,
                                     iter_budget=inp.iter_budget)

    # Re-anchor frame 0 while no marginalization prior pins the gauge.
    solved = _sel(est.prior.weight > 0, solved, _reanchor(solved, win))

    # 7. Failure detection; on failure keep the predicted state.
    fail = _failure_detection(win, solved, feats, cfg)
    solved = _sel(fail, win, solved)
    feats = fm.remove_failures(solved, feats)
    pts_w = landmark_world_points(solved, feats, ext)

    zero = torch.zeros((), dtype=gravity.dtype, device=dev)
    if inp.loop is not None:
        R_loop = lie.quat_to_rotmat(loop_q)
        loop_rel_t = R_loop.T @ (solved.p[F - 1] - loop_p)
        yaw_l = lie.rotmat_to_ypr(R_loop)[0]
        yaw_w = lie.rotmat_to_ypr(lie.quat_to_rotmat(solved.q[F - 1]))[0]
        dyaw = yaw_w - yaw_l
        loop_rel_yaw = torch.atan2(torch.sin(dyaw), torch.cos(dyaw))
        n_loop = torch.sum(prob.loop.ok & feats.valid)
        loop_good = (inp.loop.weight > 0) & (n_loop >= 10) & ~fail
    else:
        n_loop = torch.zeros((), dtype=torch.int64, device=dev)
        loop_rel_t = torch.zeros(3, device=dev)
        loop_rel_yaw = zero
        loop_good = torch.zeros((), dtype=torch.bool, device=dev)

    out = BackendOutput(
        pose_p=solved.p[F - 1], pose_q=solved.q[F - 1], vel=solved.v[F - 1],
        is_keyframe=is_kf, parallax_px=par_px, failure=fail, stats=stats,
        point_cloud=pts_w,
        point_valid=(feats.valid & feats.mask[F - 1]
                     & (solved.inv_depth > 1e-3)),
        loop_rel_t=loop_rel_t, loop_rel_yaw=loop_rel_yaw,
        loop_good=loop_good, loop_support=n_loop.to(torch.int32))

    # 8. Marginalize + slide: MARGIN_OLD if the 2nd-newest frame is a
    #    keyframe. On the host path the flag picks the branch (the one
    #    device-to-host sync of a backend frame); the select variant runs
    #    both and selects, as lax.cond does under vmap and scan.
    prob_solved = prob._replace(feats=feats)
    if select:
        slid = _sel(is_kf,
                    _slide_old(solved, feats, chunks, preints, prob_solved,
                               ext, cfg),
                    _slide_new(solved, feats, chunks, preints, est.prior,
                               cfg))
    elif bool(is_kf):
        slid = _slide_old(solved, feats, chunks, preints, prob_solved, ext,
                          cfg)
    else:
        slid = _slide_new(solved, feats, chunks, preints, est.prior, cfg)
    win2, feats2, chunks2, preints2, prior2 = slid

    new_est = BackendState(window=win2, feats=feats2, chunks=chunks2,
                           preints=preints2, prior=prior2, last_is_kf=is_kf,
                           failure=fail)
    return new_est, out


def _slide_old(solved: WindowState, feats: FeatureTable, chunks, preints,
               prob_solved: WindowProblem, ext: Extrinsics,
               cfg: VinsConfig):
    """MARGIN_OLD: the oldest frame marginalized into the prior, every
    row shifted down one. (window, feats, chunks, preints, prior)."""
    prior = marg.marginalize_old(solved, prob_solved, cfg)
    feats2, inv_new = fm.slide_old(solved, feats, ext, cfg)
    win2 = marg.slide_state_old(solved)._replace(inv_depth=inv_new)
    return (win2, feats2, _slide_chunks_old(chunks),
            _slide_preints_old(preints), prior)


def _slide_new(solved: WindowState, feats: FeatureTable, chunks, preints,
               prior: PriorFactor, cfg: VinsConfig):
    """MARGIN_SECOND_NEW: the second-newest frame dropped, its IMU edge
    merged into the newest one's and propagated once at W-2's
    linearization bias. (window, feats, chunks, preints, prior)."""
    W = cfg.window.num_frames - 1
    prior2 = marg.marginalize_second_new(solved, prior, cfg)
    merged = marg.merge_chunks(
        pre_mod.ImuChunk(*[c[W - 2] for c in chunks]),
        pre_mod.ImuChunk(*[c[W - 1] for c in chunks]))
    chunks2 = pre_mod.ImuChunk(*[
        _set_row(_set_row(c, W - 2, m), W - 1, torch.zeros_like(c[W - 1]))
        for c, m in zip(chunks, merged)])
    pre_merged = pre_mod.propagate(merged, preints.linearized_ba[W - 2],
                                   preints.linearized_bg[W - 2], cfg.imu)
    preints2 = pre_mod.Preintegration(*[
        _set_row(p, W - 2, m) for p, m in zip(preints, pre_merged)])
    return (marg.slide_state_new(solved), fm.slide_new(feats), chunks2,
            preints2, prior2)


def tree_stack(trees: Sequence, dim: int = 0):
    """Stack matching trees (NamedTuples of tensors, None leaves kept)
    along a new axis `dim`."""
    return tree_map(lambda *xs: torch.stack(xs, dim)
                    if isinstance(xs[0], torch.Tensor) else xs[0], *trees)


def tree_index(tree, i: int):
    """Every tensor leaf's entry i of its leading axis."""
    return tree_map(lambda x: x[i] if isinstance(x, torch.Tensor) else x,
                    tree)


def run_sequence_scan(est: BackendState, inputs: FrameInput,
                      cfg: VinsConfig, ext: Extrinsics,
                      gravity: torch.Tensor):
    """Replay a stacked input sequence (every FrameInput leaf [T, ...])
    through the select-variant backend step: the throughput path, with
    no device-to-host read per frame. A failed frame is flagged and the
    state frozen at the last good window (the JAX module's lax.scan with
    its torch.where). Returns (final state, BackendOutput stacked [T])."""
    outs = []
    for t in range(inputs.ids.shape[0]):
        est2, out = backend_step(est, tree_index(inputs, t), cfg, ext,
                                 gravity, select=True)
        est = _sel(out.failure, est, est2)
        outs.append(out)
    return est, tree_stack(outs)


class VinsEstimator:
    """The backend-only host shell: a bootstrapped BackendState fed frame
    by frame (the main path's host-branch step). Until a caller
    bootstraps it with a known-good window (tests, synthetic worlds), it
    is not initialized; a failure drops it back to uninitialized, as the
    reference's clearState and re-init (VINS.cpp:463-467). device=None
    means the first CUDA card."""

    def __init__(self, cfg: VinsConfig, ext: Extrinsics,
                 dtype=torch.float32, device=None):
        dev = device_mod.resolve(device)
        self.cfg = cfg
        self.ext = Extrinsics(ext.tic.to(dev), ext.qic.to(dev))
        self.gravity = torch.tensor([0.0, 0.0, cfg.imu.gravity],
                                    dtype=dtype, device=dev)
        self.state = BackendState.fresh(cfg, dev)
        self.initialized = False

    def bootstrap(self, window: WindowState, feats: FeatureTable,
                  chunks: pre_mod.ImuChunk) -> None:
        self.state = BackendState.bootstrap(self.cfg, window, feats, chunks,
                                            self.ext, self.gravity)
        self.initialized = True

    def process_frame(self, inp: FrameInput) -> BackendOutput:
        if not self.initialized:
            raise RuntimeError("estimator not initialized")
        self.state, out = backend_step(self.state, inp, self.cfg, self.ext,
                                       self.gravity)
        if bool(out.failure):
            self.initialized = False
        return out
