"""Full-system orchestration (port of vins_tpu/pipeline.VinsSystem: the
bootstrap, the interactive path and the streaming block path, with or
without loop closure).

INITIAL: interactive frames through the tracker; every freq-th frame
joins the boot window, and once it holds F frames
core/initialization.initialize bootstraps it (SfM, gyro bias, gravity and
scale), refine_init_window solves it, and the final cost is gated on
cfg.init_max_cost; a failed attempt drops the oldest boot frame and the
next backend frame retries. NON_LINEAR, interactive (process_frame): the
motion-only solve gives every frame's 30 Hz pose, every freq-th frame
runs the backend step, and on every loop_freq-th keyframe the loop DB
inserts and detects. NON_LINEAR, streaming (process_stream): blocks of
frames through stream.run_vio_scan; an in-block failure re-enters INITIAL
(a new loop-DB segment) and the tail of the stream is reprocessed.

Block mode keeps up to `depth` blocks dispatched before the oldest is
synced (the JAX pipeline's process_stream, depth 2 by default). A block is
"in flight" once the host has issued its ops on the one CUDA stream;
there are no other streams, threads or graphs, so depth buys the
reference's order of host work, not overlap. Loop closure (use_loop=True,
the default, as in the JAX package) runs between blocks: sync_block
fetches a block's packed rows together with the previous block's
detection scores, verify results and the drift in one copy, runs the
loop-edge lifecycle of the constraint that rode that block (each dispatch
is stamped, so a constraint staged after the next block was dispatched is
never charged for it), finishes verification and stages the newest
verified hit as a ride-time anchor for the next dispatch (at depth 2 the
block after next); insert_block_keyframes gates and verifies, runs a
deferred pose graph (and, with global_ba_every_kf, the global BA),
inserts every loop_freq-th keyframe into the DB and dispatches the new
rows' scores; publish_block applies the pose-graph drift to poses and
point clouds. An in-block failure publishes the good prefix, discards the
blocks dispatched after it and reprocesses from the frame after the
failure. With realtime=True the solver's iteration budget steps between
cfg.solver.min_iters and max_iters on the sync cadence against the
block's span of sensor time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from . import device as device_mod
from .config import VinsConfig
from .core import feature_manager as fm
from .core import initialization as init_mod
from .core import marginalization as marg
from .core import pnp as pnp_mod
from .core import preintegration as pre_mod
from .core.estimator import (BackendState, FrameInput, LoopInput,
                             backend_step)
from .core.factors import Extrinsics
from .core.state import FeatureTable, WindowState
from .device import fetch_flat as _fetch_flat
from .frontend.tracker import FeatureTracker
from .loop.keyframe_db import LoopCloser, _fetch, _fill
from .utils import lie
from . import stream as stream_mod

# A test seam in place of initialization: initializer(feats, chunks,
# frames) -> solved WindowState, or None when the boot window cannot be
# initialized (the oldest frame is then dropped and the next backend
# frame retries). frames: the stream indices of the F boot frames;
# chunks: their F-1 merged IMU edges, stacked.
Initializer = Callable[[FeatureTable, pre_mod.ImuChunk, List[int]],
                       Optional[WindowState]]


class PipelineOutput(NamedTuple):
    t: float
    p: np.ndarray            # [3] drift-corrected position
    q: np.ndarray            # [4]
    p_raw: np.ndarray        # [3] raw VIO position
    is_keyframe: bool
    initialized: bool
    n_tracked: int
    solver_cost: float
    loop_hit: Optional[int]  # matched old keyframe row, if any
    point_cloud: Optional[np.ndarray] = None   # [M, 3] at backend frames
    point_valid: Optional[np.ndarray] = None   # [M]
    status: str = ""


@dataclasses.dataclass
class _BootFrame:
    ids: torch.Tensor
    obs: torch.Tensor
    valid: torch.Tensor
    chunk: pre_mod.ImuChunk
    frame: int               # stream index, for the initializer


def _np_quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """Host quaternion (w, x, y, z) -> rotation matrix, as the JAX
    pipeline's drift correction computes it."""
    w, x, y, z = [float(v) for v in q]
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _np_yaw(q: np.ndarray) -> float:
    R = _np_quat_to_rotmat(q)
    return float(np.arctan2(R[1, 0], R[0, 0]))


def _np_rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """Host rotation matrix -> quaternion (w, x, y, z), Shepperd's method
    with the JAX pipeline's branch order."""
    t = float(np.trace(R))
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        v = np.zeros(3)
        v[i] = 0.25 * s
        v[j] = (R[j, i] + R[i, j]) / s
        v[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = v
    q = np.array([w, x, y, z], np.float32)
    return q / np.linalg.norm(q)


def _reanchor_window(window: WindowState, p_anchor: torch.Tensor,
                     yaw_anchor: torch.Tensor) -> WindowState:
    """Rigidly move a window so frame 0 sits at p_anchor with yaw_anchor."""
    dyaw = yaw_anchor - lie.rotmat_to_ypr(lie.quat_to_rotmat(window.q[0]))[0]
    zero = torch.zeros_like(dyaw)
    R_fix = lie.ypr_to_rotmat(torch.stack([dyaw, zero, zero]))
    q_fix = lie.rotmat_to_quat(R_fix)
    return window._replace(p=(window.p - window.p[0]) @ R_fix.T + p_anchor,
                           q=lie.quat_mul(q_fix, window.q),
                           v=window.v @ R_fix.T)


def default_extrinsics(cfg: VinsConfig, device=None) -> Extrinsics:
    """The camera config's extrinsics (device=None: the first CUDA card)."""
    cam = cfg.camera
    dev = device_mod.resolve(device)
    return Extrinsics(
        tic=torch.tensor(cam.tic, dtype=torch.float32, device=dev),
        qic=lie.rotmat_to_quat(torch.tensor(cam.ric_matrix(), device=dev)))


class VinsSystem:
    """End-to-end VIO/SLAM on one device; device=None means the first
    CUDA card (a RuntimeError without one)."""

    def __init__(self, cfg: VinsConfig, seed: int = 0, use_pnp: bool = True,
                 use_loop: bool = True, ext: Optional[Extrinsics] = None,
                 device=None, initializer: Optional[Initializer] = None,
                 global_ba_every_kf: int = 0):
        """initializer: a test seam that replaces the visual-inertial
        initialization (None, the default, runs it); global_ba_every_kf:
        run LoopCloser.global_ba in block mode every that many new DB
        rows (0, the default, never)."""
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        dev = self.device
        self.ext = (Extrinsics(*(x.to(dev) for x in ext)) if ext is not None
                    else default_extrinsics(cfg, dev))
        self.gravity = torch.tensor([0.0, 0.0, cfg.imu.gravity], device=dev)
        self.initializer = initializer
        self.tracker = FeatureTracker(cfg, seed, dev)
        self.use_pnp = use_pnp
        self.use_loop = use_loop and cfg.loop.enabled
        self.loop = (LoopCloser(cfg, seed, ext=(self.ext.tic, self.ext.qic),
                                device=dev) if self.use_loop else None)
        # The LM iteration budget of streaming solves; process_stream's
        # real-time mode moves it between these bounds.
        self.solver_budget = cfg.solver.max_iters
        self._budget_floor = cfg.solver.min_iters
        self._dispatch_seq = 0       # stamps each dispatched block
        self._loop_inactive = LoopInput.inactive(cfg.window.max_landmarks,
                                                 device=dev)
        self._anchor_inactive = stream_mod.LoopAnchor.inactive(
            cfg.loop.max_kf_features, device=dev)
        self._stage_queue = []       # verified hits awaiting staging
        self._pending_detect = []    # inserted rows awaiting scoring
        self._pending_scores = None  # (scores [Q, K] on the device, floor)
        self._pending_gate = None    # (rows, fetched scores, floor)
        self._pending_verify = None  # gate_and_dispatch result to finish
        self._needs_optimize = False
        self._pending_refine = None  # edge refinement awaiting kf rows
        # Block mode's dead-reckoning leaves the pnp window's carried
        # preintegrations stale; the next interactive solve rebuilds them.
        self._pnp_preints_stale = False
        # In-stream global BA on one device (the sharded solve is not
        # ported: _ba_mesh stays None).
        self._ba_every = int(global_ba_every_kf)
        self._last_ba_count = 0
        self._ba_mesh = None
        self.ba_runs = 0
        self.loop_stats = {"hits": 0, "staged": 0, "attached": 0,
                           "good_frames": 0, "retired": 0}
        self.timings = {"dispatch": 0.0, "sync": 0.0, "insert": 0.0,
                        "publish": 0.0, "drain": 0.0, "blocks": 0,
                        "host_syncs": 0}
        self.reset()

    # -- lifecycle ----------------------------------------------------------

    def reset(self, keep_trajectory: bool = False):
        cfg = self.cfg
        S = cfg.window.pnp_size + 1
        dev = self.device
        self.initialized = False
        self.est = BackendState.fresh(cfg, dev)
        self.boot: List[_BootFrame] = []
        empty = pre_mod.ImuChunk.empty(cfg.window.max_imu_per_edge,
                                       device=dev)
        self.pnp = pnp_mod.PnpWindow(
            state=pnp_mod.PnpState.identity(S, device=dev),
            feats=pnp_mod.PnpFeatures.empty(S, cfg.window.max_landmarks,
                                            device=dev),
            chunks=pre_mod.ImuChunk(*[x[None].repeat((S - 1,) + (1,) * x.dim())
                                      for x in empty]),
            anchored=torch.zeros((S,), dtype=torch.bool, device=dev))
        self.pnp = self.pnp._replace(
            preints=pnp_mod.window_preints(self.pnp, cfg))
        self.frame_idx = 0
        self.kf_count = 0
        self._pending_chunk: Optional[pre_mod.ImuChunk] = None
        # Device-carried loop lifecycle (dropped with the estimator state).
        self._loop_dev: Optional[LoopInput] = None
        self._anchor_dev: Optional[stream_mod.LoopAnchor] = None
        self._anchor_live = False
        self._pending_loop = None    # host mirror of the staged constraint
        if not keep_trajectory:
            self.trajectory: List[np.ndarray] = []
            self._recover_anchor = None
            self._last_good = None

    def _fail_reset(self):
        """Failure recovery (VINS.cpp:463-467): re-enter INITIAL, keep the
        trajectory, re-anchor the next init at the last good pose, and
        start a new loop-DB segment."""
        if self.loop is not None:
            self.loop.new_segment()
        anchor = self._last_good
        self.reset(keep_trajectory=True)
        self._recover_anchor = anchor

    def _merge_pending(self, chunk: pre_mod.ImuChunk) -> pre_mod.ImuChunk:
        if self._pending_chunk is None:
            return chunk
        return marg.merge_chunks(self._pending_chunk, chunk)

    def _drift_correct(self, p: np.ndarray, q: np.ndarray):
        """The pose-graph drift applied on the host (numpy only)."""
        if self.loop is None:
            return p, q
        R, t = self.loop.r_drift, self.loop.t_drift
        p2 = (R @ p + t).astype(np.float32)
        q2 = _np_rotmat_to_quat(R @ _np_quat_to_rotmat(q))
        return p2, q2

    def _drift_correct_points(self, pts: np.ndarray) -> np.ndarray:
        """The drift applied to the published sparse map (VINS.cpp:307-331)."""
        if self.loop is None:
            return pts
        return (pts @ self.loop.r_drift.T
                + self.loop.t_drift[None, :]).astype(np.float32)

    # -- interactive entry ----------------------------------------------------

    def process_frame(self, img: torch.Tensor, chunk: pre_mod.ImuChunk,
                      t: float = 0.0,
                      gumbel: Optional[torch.Tensor] = None
                      ) -> PipelineOutput:
        """One camera frame + the IMU chunk since the previous frame.
        gumbel: optional RANSAC noise for the tracker."""
        img = img.to(self.device, torch.float32)
        is_backend_frame = (self.frame_idx % self.cfg.freq) == 0
        front = self.tracker.process(img, do_topup=True, gumbel=gumbel)
        frame = self.frame_idx
        self.frame_idx += 1
        if not self.initialized:
            out = self._process_boot(front, chunk, t, is_backend_frame, frame)
        else:
            out = self._process_nonlinear(img, front, chunk, t,
                                          is_backend_frame)
        self.trajectory.append(out.p)
        return out

    # -- INITIAL --------------------------------------------------------------

    def _process_boot(self, front, chunk, t, is_backend_frame,
                      frame) -> PipelineOutput:
        cfg = self.cfg
        F = cfg.window.num_frames
        merged = self._merge_pending(chunk)
        if not is_backend_frame:
            self._pending_chunk = merged
            return self._null_output(t, front)
        self._pending_chunk = None

        self.boot.append(_BootFrame(ids=front.ids, obs=front.obs,
                                    valid=front.obs_valid, chunk=merged,
                                    frame=frame))
        if len(self.boot) > F:
            self.boot.pop(0)
        if len(self.boot) < F:
            return self._null_output(t, front)

        # Keep only ids seen in >= 2 boot frames (the only tracks the
        # initializer can use), most-observed first when they overflow
        # the landmark budget.
        L = cfg.window.max_landmarks
        ids_all = np.stack([bf.ids.cpu().numpy() for bf in self.boot])
        ok_all = np.stack([bf.valid.cpu().numpy() for bf in self.boot])
        ok_all &= ids_all >= 0
        uniq, cnt = np.unique(ids_all[ok_all], return_counts=True)
        multi = cnt >= 2
        keep = uniq[multi]
        if len(keep) > L:
            keep = keep[np.argsort(-cnt[multi], kind="stable")[:L]]
        feats = FeatureTable.empty(F, L, device=self.device)
        for f, bf in enumerate(self.boot):
            sel = ok_all[f] & np.isin(ids_all[f], keep)
            feats = fm.ingest_frame(feats, f, bf.ids, bf.obs,
                                    torch.as_tensor(sel, device=self.device))
        chunks = pre_mod.ImuChunk(*[torch.stack(xs) for xs in zip(
            *[bf.chunk for bf in self.boot[1:]])])
        window, cost, status = self._initialize_window(
            feats, chunks, [bf.frame for bf in self.boot])
        if window is None:
            self.boot.pop(0)   # slide and retry at the next backend frame
            return self._null_output(t, front, status=status)

        # Re-anchor a re-initialization at the last good pose so the
        # trajectory does not jump (VINS.cpp:137-142).
        if self._recover_anchor is not None:
            p_anchor, yaw_anchor = self._recover_anchor
            window = _reanchor_window(
                window, torch.as_tensor(p_anchor, device=self.device),
                torch.tensor(yaw_anchor, device=self.device))
            self._recover_anchor = None

        self.est = BackendState.bootstrap(cfg, window, feats, chunks,
                                          self.ext, self.gravity)
        self.initialized = True
        self.boot.clear()
        self._sync_pnp_from_backend()
        p_raw, q_raw, ntr = _fetch_flat([window.p[F - 1], window.q[F - 1],
                                         front.n_tracked])
        self._last_good = (p_raw, _np_yaw(q_raw))
        p, q = self._drift_correct(p_raw, q_raw)
        return PipelineOutput(
            t=t, p=p, q=q, p_raw=p_raw, is_keyframe=True,
            initialized=True, n_tracked=int(ntr), solver_cost=cost,
            loop_hit=None)

    def _initialize_window(self, feats: FeatureTable,
                           chunks: pre_mod.ImuChunk, frames: List[int]):
        """One bootstrap attempt on the boot window: initialize (seed 0 on
        every attempt), the accepting refinement solve and its cost gate
        (VINS.cpp:415-443), or the test seam. Returns (window or None,
        final cost, status string)."""
        if self.initializer is not None:
            window = self.initializer(feats, chunks, frames)
            return window, 0.0, "" if window is not None else "FAIL_INIT"
        res = init_mod.initialize(feats, chunks, self.ext, self.cfg, seed=0)
        if res.status is not init_mod.InitStatus.SUCCESS:
            return None, 0.0, res.status.name
        window, cost = init_mod.refine_init_window(res.window, feats, chunks,
                                                   self.ext, self.cfg)
        cost = float(cost)
        if not np.isfinite(cost) or cost > self.cfg.init_max_cost:
            return None, 0.0, "FAIL_CHECK"
        return window, cost, ""

    # -- NON_LINEAR, interactive ----------------------------------------------

    def _process_nonlinear(self, img, front, chunk, t,
                           is_backend_frame) -> PipelineOutput:
        """An initialized frame (vins_tpu/pipeline.py:482-585): the
        motion-only solve on every frame; on backend frames the window
        step with the staged loop constraint, one combined fetch, the
        failure reset, the loop-edge refinement and TTL, the keyframe
        insert, and the drift-corrected pose and point cloud."""
        cfg = self.cfg
        merged = self._merge_pending(chunk)
        if self.use_pnp:
            if self._pnp_preints_stale:
                self.pnp = self.pnp._replace(
                    preints=pnp_mod.window_preints(self.pnp, cfg))
                self._pnp_preints_stale = False
            # The pnp map lives in backend landmark slot order.
            obs_l, has_l = stream_mod._gather_by_id(
                self.est.feats.track_id, front.ids, front.obs,
                front.obs_valid)
            self.pnp, (p30, q30, _v30) = pnp_mod.pnp_step(
                self.pnp, chunk, obs_l, has_l, cfg, self.ext, self.gravity,
                do_solve=True, update_preints=True)

        if not is_backend_frame:
            self._pending_chunk = merged
            if not self.use_pnp:
                return self._null_output(t, front, initialized=True)
            p30_h, q30_h, ntr = _fetch_flat([p30, q30, front.n_tracked])
            p, q = self._drift_correct(p30_h, q30_h)
            return PipelineOutput(
                t=t, p=p, q=q, p_raw=p30_h, is_keyframe=False,
                initialized=True, n_tracked=int(ntr), solver_cost=0.0,
                loop_hit=None)

        self._pending_chunk = None
        if self._pending_loop is not None and "dev" not in self._pending_loop:
            # A constraint staged in block mode: the scan owned it; close
            # it out with the pose graph.
            self.loop.optimize()
            self._pending_loop = None
        loop_inp = (self._scan_loop() if self._pending_loop is not None
                    else self._loop_inactive)
        inp = FrameInput(chunk=merged, ids=front.ids, obs=front.obs,
                         obs_valid=front.obs_valid, loop=loop_inp)
        self.est, out = backend_step(self.est, inp, cfg, self.ext,
                                     self.gravity)
        (failure, is_kf, pose_p, pose_q, cost, ntr, pts_w, pts_ok,
         loop_rel_t, loop_rel_yaw, loop_good, loop_support) = _fetch_flat([
             out.failure, out.is_keyframe, out.pose_p, out.pose_q,
             out.stats.final_cost, front.n_tracked, out.point_cloud,
             out.point_valid, out.loop_rel_t, out.loop_rel_yaw,
             out.loop_good, out.loop_support])

        if bool(failure):
            self._fail_reset()
            return self._null_output(t, front, status="FAILURE")

        self._last_good = (pose_p, _np_yaw(pose_q))
        self._sync_pnp_from_backend()

        # Loop-edge lifecycle (VINS.cpp:663-680, ViewController.mm:850-875):
        # each good solve refines the edge, re-pointed at the newest
        # keyframe; the constraint retires when its TTL runs out or too
        # few matched tracks survive, and the pose graph runs.
        if self._pending_loop is not None:
            pl = self._pending_loop
            if bool(loop_good):
                e = self.loop.edge_index(pl["edge_abs"])
                if e >= 0 and self.loop.count >= 1:
                    self._refine_edge_to_kf(
                        e, loop_rel_t, float(loop_rel_yaw), pose_p,
                        _np_yaw(pose_q), self.loop.count - 1)
                    self.loop_stats["good_frames"] += 1
                    if not pl["attached"]:
                        pl["attached"] = True
                        self.loop_stats["attached"] += 1
            pl["ttl"] -= 1
            if pl["ttl"] <= 0 or int(loop_support) < 10:
                self.loop.optimize()
                self._pending_loop = None
                self.loop_stats["retired"] += 1

        loop_hit = None
        if self.use_loop and bool(is_kf):
            self.kf_count += 1
            if self.kf_count % cfg.loop.loop_freq == 0:
                loop_hit = self._handle_keyframe(
                    img, t, p_host=pose_p, yaw_host=_np_yaw(pose_q))

        p, q = self._drift_correct(pose_p, pose_q)
        return PipelineOutput(
            t=t, p=p, q=q, p_raw=pose_p, is_keyframe=bool(is_kf),
            initialized=True, n_tracked=int(ntr), solver_cost=float(cost),
            loop_hit=loop_hit,
            point_cloud=self._drift_correct_points(pts_w), point_valid=pts_ok)

    def _handle_keyframe(self, img, t=0.0, p_host=None,
                         yaw_host=None) -> Optional[int]:
        """Insert the keyframe into the loop DB and detect; stage a hit as
        a loop constraint for the following window solves, or run the
        pose graph with its detection-time edge when too few of its
        matches resolve to live landmark slots. Returns the hit's old
        row."""
        F = self.cfg.window.num_frames
        win, tr = self.est.window, self.tracker.state
        pts_w, w_ok = stream_mod._tracker_world_points(self.est, tr, self.ext)
        idx = self.loop.add_keyframe(
            img, win.p[F - 1], win.q[F - 1], tr.pts, tr.valid, pts_w, w_ok,
            window_ids=tr.ids, t=t, p_host=p_host, yaw_host=yaw_host)
        hit = self.loop.detect(idx)
        if hit is None:
            return None
        self.loop_stats["hits"] += 1
        if not self._stage_loop_from_hit(hit):
            self.loop.optimize()
        return hit.old_idx

    def _stage_loop_from_hit(self, hit) -> bool:
        """Stage a verified hit as a LoopInput for the following window
        solves: join the old keyframe's matched observations to the
        backend landmark slots by track id. False when fewer than 10
        resolve; a new hit supersedes (and optimizes) a pending one."""
        slot_ids = self.est.feats.track_id.cpu().numpy()
        tids = np.asarray(hit.tids)
        ok_rows = np.asarray(hit.match_ok) & (tids >= 0)
        eq = ((slot_ids[:, None] == tids[None, :])
              & ok_rows[None, :] & (slot_ids[:, None] >= 0))
        ok_by_slot = eq.any(axis=1)
        row = eq.argmax(axis=1)
        obs_by_slot = np.where(ok_by_slot[:, None],
                               np.asarray(hit.obs_old)[row],
                               0.0).astype(np.float32)
        if ok_by_slot.sum() < 10:
            return False
        if self._pending_loop is not None:
            self.loop.optimize()
        F = self.cfg.window.num_frames
        dev = self.device
        # Attached at its first good window solve, as a ride-time attach
        # in block mode.
        self._pending_loop = {
            "edge_abs": hit.edge_abs, "old_idx": hit.old_idx, "ttl": F,
            "attached": False,
            "dev": LoopInput(
                obs_old=torch.as_tensor(obs_by_slot, device=dev),
                ok=torch.as_tensor(ok_by_slot, device=dev),
                ids=torch.as_tensor(slot_ids.astype(np.int32), device=dev),
                p_init=torch.as_tensor(np.asarray(hit.p_old, np.float32),
                                       device=dev),
                q_init=torch.as_tensor(np.asarray(hit.q_old, np.float32),
                                       device=dev),
                ttl=torch.full((), F, dtype=torch.int32, device=dev),
                weight=torch.ones((), device=dev))}
        self.loop_stats["staged"] += 1
        return True

    def _sync_pnp_from_backend(self):
        if self.use_pnp:
            self.pnp = stream_mod._sync_pnp(self.pnp, self.est, self.cfg,
                                            self.ext)

    # -- streaming block mode -------------------------------------------------

    def _scan_state(self) -> stream_mod.ScanState:
        N = self.cfg.window.max_imu_per_edge
        pending = (self._pending_chunk if self._pending_chunk is not None
                   else pre_mod.ImuChunk.empty(N, device=self.device))
        return stream_mod.ScanState(
            tracker=self.tracker.state, pnp=self.pnp, est=self.est,
            pending=pending, has_pending=self._pending_chunk is not None,
            phase=self.frame_idx % self.cfg.freq,
            loop=self._scan_loop(),
            anchor=(self._anchor_dev if self._anchor_dev is not None
                    else self._anchor_inactive),
            anchor_live=self._anchor_live,
            solver_budget=self.solver_budget)

    def _scan_loop(self) -> LoopInput:
        """The loop block a scan starts from: a constraint staged on the
        interactive path re-injected with its host TTL mirror, else the
        device-carried lifecycle state, else the inactive block."""
        pl = self._pending_loop
        if pl is not None and "dev" in pl:
            return pl["dev"]._replace(ttl=torch.full(
                (), pl["ttl"], dtype=torch.int32, device=self.device))
        if self._loop_dev is not None:
            return self._loop_dev
        return self._loop_inactive

    def dispatch_block(self, imgs: torch.Tensor, chunks: pre_mod.ImuChunk,
                       ts=None, gumbel: Optional[torch.Tensor] = None):
        """Run the block pipeline over imgs [N, H, W] and commit the state
        (device work is enqueued; the host syncs only on keyframe
        branches). Returns a handle for sync_block."""
        if not self.initialized:
            raise RuntimeError("block mode requires an initialized system")
        t0 = time.perf_counter()
        imgs = imgs.to(self.device, torch.float32)
        state2, outs = stream_mod.run_vio_scan(
            self._scan_state(), imgs, chunks, self.cfg, self.ext,
            self.gravity, use_pnp=self.use_pnp, gumbel=gumbel)
        n = int(imgs.shape[0])
        self.tracker.state = state2.tracker
        self.pnp = state2.pnp
        self.est = state2.est
        self._loop_dev = state2.loop
        self._anchor_dev = state2.anchor
        self._pending_chunk = state2.pending if state2.has_pending else None
        if self.use_pnp and self.cfg.solver.pnp_stream_solve == "deadreckon":
            self._pnp_preints_stale = True
        self.frame_idx += n
        self.timings["dispatch"] += time.perf_counter() - t0
        self.timings["blocks"] += 1
        # One keyframe-branch sync per backend frame (core/estimator.py).
        self.timings["host_syncs"] += int(sum(
            1 for k in range(n) if (self.frame_idx - n + k) % self.cfg.freq
            == 0))
        # Stamp the staged constraint with this dispatch: at depth 2 a
        # constraint staged at sync k first rides block k+2, and sync k+1
        # (a block that did not carry it) must not charge it.
        seq = self._dispatch_seq
        self._dispatch_seq += 1
        if self._pending_loop is not None:
            self._pending_loop.setdefault("rode", set()).add(seq)
        return (outs, imgs, n, ts, seq)

    def sync_block(self, handle):
        """Fetch, in one device-to-host copy, the block's packed per-frame
        rows and sparse map with the previous block's detection scores,
        verify results, the drift and the anchor's pending flag; run the
        failure bookkeeping and the loop-edge lifecycle of the constraint
        that rode the block (by the dispatch stamps), finish
        verification, and stage the newest verified hit as an anchor for
        the next dispatch (at depth 2 the block after next)."""
        t0 = time.perf_counter()
        outs, imgs, n, ts, seq = handle
        pl = self._pending_loop
        loop_rode = pl is not None and seq in pl.get("rode", ())
        pending_detect, self._pending_detect = self._pending_detect, []
        pending_scores, self._pending_scores = self._pending_scores, None
        scores_dev, floor = None, 0.0
        if pending_detect and self.use_loop:
            if pending_scores is None:
                pending_scores = self.loop.dispatch_scores(pending_detect)
            scores_dev, floor = pending_scores
        pend_verify, self._pending_verify = self._pending_verify, None
        vhandles = (self.loop.pending_verify_handles(pend_verify)
                    if pend_verify is not None else [])
        leaves = [outs.packed, outs.point_cloud, outs.point_valid]
        if self.use_loop:
            # The anchor the next dispatch starts from (the latest state).
            anchor = (self._anchor_dev if self._anchor_dev is not None
                      else self._anchor_inactive)
            leaves += [self.loop._r_drift_dev, self.loop._t_drift_dev,
                       anchor.pending]
        n_fixed = len(leaves)
        if scores_dev is not None:
            leaves.append(scores_dev)
        got = _fetch_flat(leaves + list(vhandles))
        self.timings["host_syncs"] += 1
        packed_h, pcl_h, pok_h = got[:3]
        scores_h = got[n_fixed] if scores_dev is not None else None
        vfetched = got[n_fixed + (scores_dev is not None):]
        S = stream_mod
        p_h = packed_h[:, S.PACK_P]
        q_h = packed_h[:, S.PACK_Q]
        fail_h = packed_h[:, S.PACK_FAIL] > 0.5
        is_be_h = packed_h[:, S.PACK_IS_BE] > 0.5
        lgood_h = packed_h[:, S.PACK_LGOOD] > 0.5
        lry_h = packed_h[:, S.PACK_LYAW]
        lret_h = packed_h[:, S.PACK_LRET] > 0.5
        lrt_h = packed_h[:, S.PACK_LREL_T]
        if self.use_loop:
            self.loop.sync_drift(got[3], got[4])
            # A sync that shows the anchor done lets the next blocks skip
            # the attach (stream.ScanState.anchor_live).
            self._anchor_live = bool(got[5])
        fail_idx = np.flatnonzero(fail_h)
        fail_at = int(fail_idx[0]) if len(fail_idx) else None
        n_ok = fail_at if fail_at is not None else n
        self.loop_stats["good_frames"] += int(np.sum(lgood_h[:n_ok]))

        # Loop-edge lifecycle of the constraint that rode this block: its
        # last good readout refines the edge once this block's keyframes
        # have rows (insert_block_keyframes); retirement or a failure
        # closes it and schedules the pose graph.
        if loop_rode:
            ret_idx = np.flatnonzero(lret_h[:n_ok])
            stop = int(ret_idx[0]) + 1 if len(ret_idx) else n_ok
            good_idx = np.flatnonzero(lgood_h[:stop])
            if len(good_idx):
                if not pl["attached"]:
                    pl["attached"] = True
                    self.loop_stats["attached"] += 1
                g = int(good_idx[-1])
                self._pending_refine = {
                    "edge_abs": pl["edge_abs"], "g": g, "t": lrt_h[g],
                    "ryaw": float(lry_h[g]), "p_g": p_h[g],
                    "yaw_g": _np_yaw(q_h[g])}
            if len(ret_idx) or fail_at is not None:
                self.loop_stats["retired"] += int(len(ret_idx) > 0)
                self._needs_optimize = True
                self._pending_loop = None
            else:
                pl["ttl"] -= int(np.sum(is_be_h[:n_ok]))

        loop_hits = {}
        if pend_verify is not None:
            hits = self.loop.finish_detect(pend_verify, vfetched)
            for idx, hit in zip(pend_verify[0], hits):
                if hit is not None:
                    loop_hits[-1 - idx] = hit.old_idx
                    self._stage_queue.append(hit)
                    self.loop_stats["hits"] += 1
            self._stage_queue = self._stage_queue[-4:]
        if pending_detect and self.use_loop and scores_h is not None:
            self._pending_gate = (pending_detect, scores_h, floor)
        # One constraint in flight at a time: stage the newest queued hit.
        if self._pending_loop is None and self._stage_queue:
            hit = self._stage_queue.pop()
            self._stage_queue.clear()
            self._stage_anchor_from_hit(hit)

        if fail_at is not None:
            if fail_at >= 1:
                self._last_good = (p_h[fail_at - 1],
                                   _np_yaw(q_h[fail_at - 1]))
            self._fail_reset()
        elif n_ok >= 1:
            self._last_good = (p_h[n_ok - 1], _np_yaw(q_h[n_ok - 1]))
        self.timings["sync"] += time.perf_counter() - t0
        return dict(outs=outs, imgs=imgs, n=n, n_ok=n_ok, fail_at=fail_at,
                    p=p_h, q=q_h, is_kf=packed_h[:, S.PACK_IS_KF] > 0.5,
                    is_be=is_be_h, cost=packed_h[:, S.PACK_COST],
                    ntr=packed_h[:, S.PACK_NTRACK].astype(np.int32),
                    loop_hits=loop_hits, ts=ts, pcl=pcl_h, pok=pok_h)

    def insert_block_keyframes(self, prep) -> None:
        """Gate the fetched scores and dispatch verification, run a
        deferred pose graph, insert every loop_freq-th keyframe of the
        block into the loop DB, apply a deferred edge refinement and
        dispatch the new rows' scores (fetched by the next sync)."""
        if not self.use_loop:
            return
        t0 = time.perf_counter()
        pending_gate, self._pending_gate = self._pending_gate, None
        if pending_gate is not None:
            self._pending_verify = self.loop.gate_and_dispatch(
                *pending_gate, slim=True)
        if self._needs_optimize:
            self.loop.optimize(defer_fetch=True)
            self._needs_optimize = False
        outs, imgs, ts = prep["outs"], prep["imgs"], prep["ts"]
        # UIDs, not rows: an insert at capacity resamples and compacts the
        # rows of keyframes inserted earlier in this loop.
        ins_uids = []
        for k in range(prep["n_ok"]):
            if not bool(prep["is_kf"][k]):
                continue
            self.kf_count += 1
            if self.kf_count % self.cfg.loop.loop_freq != 0:
                continue
            idx = self.loop.add_keyframe(
                imgs[k], outs.p[k], outs.q[k], outs.kf_pts_px[k],
                outs.kf_valid[k], outs.kf_pts_w[k], outs.kf_w_ok[k],
                window_ids=outs.kf_ids[k],
                t=float(ts[k]) if ts is not None else 0.0,
                p_host=prep["p"][k], yaw_host=_np_yaw(prep["q"][k]))
            ins_uids.append((k, self.loop.uid_of(idx)))
        pairs = [(k, self.loop.row_of(u)) for k, u in ins_uids]
        pairs = [(k, r) for k, r in pairs if r >= 0]
        inserted = [r for _, r in pairs]
        self._apply_pending_refine(pairs)
        self._pending_detect = inserted
        if inserted:
            self._pending_scores = self.loop.dispatch_scores(inserted)
        # In-stream global BA over the harvested map (opt-in), its cost
        # fetch deferred like the pose graph's drift.
        if self._ba_every and \
                self.loop.count - self._last_ba_count >= self._ba_every:
            self._last_ba_count = self.loop.count
            self.loop.global_ba(mesh=self._ba_mesh, defer_fetch=True)
            self.ba_runs += 1
        self.timings["insert"] += time.perf_counter() - t0

    def _apply_pending_refine(self, pairs) -> None:
        """Apply a deferred edge refinement: re-point the edge at the
        keyframe inserted nearest the readout frame (or the newest row),
        composing the raw-odometry gap, and schedule the pose graph.
        pairs: [(frame offset in the block, DB row)] of this block."""
        pr, self._pending_refine = self._pending_refine, None
        if pr is None or self.loop is None:
            return
        e = self.loop.edge_index(pr["edge_abs"])
        if e < 0:
            return
        if pairs:
            _, j = min(pairs, key=lambda kr: abs(kr[0] - pr["g"]))
        elif self.loop.count >= 1:
            j = self.loop.count - 1
        else:
            return
        self._refine_edge_to_kf(e, pr["t"], pr["ryaw"], pr["p_g"],
                                pr["yaw_g"], j)
        self._needs_optimize = True

    def _refine_edge_to_kf(self, e, t_g, ryaw_g, p_g, yaw_g, j) -> None:
        """Re-point edge e at keyframe row j: compose the raw-odometry gap
        between the readout frame (raw pose p_g, yaw_g) and keyframe j
        into the (t, yaw) measurement, in the solved old pose's yaw
        frame."""
        p_j = self.loop._kf_p_np[j]
        yaw_j = float(self.loop._kf_yaw_np[j])
        yaw_old = yaw_g - ryaw_g
        c, s = np.cos(yaw_old), np.sin(yaw_old)
        Rz_T = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]],
                        np.float32)
        t_j = np.asarray(t_g, np.float32) + Rz_T @ (
            np.asarray(p_j, np.float32) - np.asarray(p_g, np.float32))
        dyaw = ryaw_g + (yaw_j - yaw_g)
        dyaw = float(np.arctan2(np.sin(dyaw), np.cos(dyaw)))
        self.loop.update_loop_edge(e, t_j, dyaw, j=j)

    def _stage_anchor_from_hit(self, hit) -> None:
        """Stage a verified hit for ride-time attachment in the next
        block's backend frames: the old keyframe's rows (a device copy)
        and its PnP-refined pose (written by fill_, no upload)."""
        lp = self.cfg.loop
        F = self.cfg.window.num_frames
        dev = self.device
        desc_o, ok_o, obs_o = self.loop.anchor_rows(hit.old_idx)
        p_init = torch.empty(3, device=dev)
        q_init = torch.empty(4, device=dev)
        _fill(p_init, np.asarray(hit.p_old, np.float32))
        _fill(q_init, np.asarray(hit.q_old, np.float32))
        self._anchor_dev = stream_mod.LoopAnchor(
            desc_old=desc_o, ok_old=ok_o, obs_old=obs_o, p_init=p_init,
            q_init=q_init,
            ttl=torch.full((), lp.attach_ttl, dtype=torch.int32, device=dev),
            pending=torch.ones((), dtype=torch.bool, device=dev))
        self._anchor_live = True
        self._pending_loop = {"edge_abs": hit.edge_abs,
                              "old_idx": hit.old_idx,
                              "ttl": lp.attach_ttl + F, "attached": False}
        self.loop_stats["staged"] += 1

    def publish_block(self, prep, ts=None) -> List[PipelineOutput]:
        """Assemble the per-frame outputs of a synced block, with the
        pose-graph drift applied to poses and backend-frame point clouds.
        ts: the block's timestamps (default: those given at dispatch)."""
        t0 = time.perf_counter()
        if ts is None:
            ts = prep["ts"]
        results = []
        for k in range(prep["n_ok"]):
            t = float(ts[k]) if ts is not None else 0.0
            pcl = pval = None
            if prep["is_be"][k]:
                pcl = self._drift_correct_points(
                    prep["pcl"][k].astype(np.float32))
                pval = prep["pok"][k]
            p_raw = prep["p"][k]
            p, q = self._drift_correct(p_raw, prep["q"][k])
            results.append(PipelineOutput(
                t=t, p=p, q=q, p_raw=p_raw,
                is_keyframe=bool(prep["is_kf"][k]), initialized=True,
                n_tracked=int(prep["ntr"][k]),
                solver_cost=float(prep["cost"][k]),
                loop_hit=prep["loop_hits"].get(k),
                point_cloud=pcl, point_valid=pval))
            self.trajectory.append(p)
        fail_at = prep["fail_at"]
        if fail_at is not None:
            t = float(ts[fail_at]) if ts is not None else 0.0
            results.append(PipelineOutput(
                t=t, p=np.zeros(3, np.float32),
                q=np.array([1, 0, 0, 0], np.float32),
                p_raw=np.zeros(3, np.float32), is_keyframe=False,
                initialized=False, n_tracked=0, solver_cost=0.0,
                loop_hit=None, status="FAILURE"))
        self.timings["publish"] += time.perf_counter() - t0
        return results

    def prepare_block(self, handle):
        """sync_block and insert_block_keyframes in one call."""
        prep = self.sync_block(handle)
        self.insert_block_keyframes(prep)
        return prep

    def finalize_block(self, handle, ts=None) -> List[PipelineOutput]:
        """prepare_block, then publish_block."""
        return self.publish_block(self.prepare_block(handle), ts)

    def process_block(self, imgs: torch.Tensor, chunks: pre_mod.ImuChunk,
                      ts=None, gumbel: Optional[torch.Tensor] = None
                      ) -> List[PipelineOutput]:
        """One block dispatched and finalized: imgs [N, H, W], chunks
        stacked [N, ...]."""
        return self.finalize_block(self.dispatch_block(imgs, chunks, ts,
                                                       gumbel))

    def drain_loop_work(self) -> None:
        """End of a stream: gate and verify what is pending, detect the
        last inserted keyframes, close a pending constraint, run the pose
        graph once if anything changed, and fetch the drift."""
        if not self.use_loop:
            return
        t0 = time.perf_counter()
        pending, self._pending_detect = self._pending_detect, []
        pending_scores, self._pending_scores = self._pending_scores, None
        n_hits = 0
        pending_gate, self._pending_gate = self._pending_gate, None
        if pending_gate is not None and self._pending_verify is None:
            self._pending_verify = self.loop.gate_and_dispatch(
                *pending_gate)
        pend_verify, self._pending_verify = self._pending_verify, None
        if pend_verify is not None:
            vfetched = _fetch(self.loop.pending_verify_handles(pend_verify))
            vh = [h for h in self.loop.finish_detect(pend_verify, vfetched)
                  if h is not None]
            n_hits += len(vh)
            self._stage_queue.extend(vh)
        if pending:
            if pending_scores is not None:
                hits_all = self.loop.detect_from_scores(
                    pending, pending_scores[0].cpu().numpy(),
                    pending_scores[1])
            else:
                hits_all = self.loop.detect_many(pending)
            hits = [h for h in hits_all if h is not None]
            n_hits += len(hits)
            self._stage_queue.extend(hits)
            self._stage_queue = self._stage_queue[-4:]
        self.loop_stats["hits"] += n_hits
        if self._pending_loop is not None:
            self.loop.optimize()
            self._pending_loop = None
        elif n_hits or self._needs_optimize:
            self.loop.optimize()
        self._needs_optimize = False
        self.loop.sync_drift()
        self.timings["drain"] += time.perf_counter() - t0

    def process_stream(self, imgs: torch.Tensor, chunks: pre_mod.ImuChunk,
                       block: int = 48, ts=None, realtime: bool = False,
                       depth: int = 2,
                       gumbel: Optional[torch.Tensor] = None
                       ) -> List[PipelineOutput]:
        """A staged sequence: interactive frames until initialized, then
        blocks of `block` frames with up to `depth` dispatched before the
        oldest is synced. For block k: sync k, its keyframes inserted, its
        outputs published, then block k+depth dispatched, so a hit staged
        at sync k first rides block k+depth. An in-block failure publishes
        the good prefix, discards the blocks in flight behind it,
        re-enters INITIAL and reprocesses from the frame after the
        failure. realtime (needs ts): after each sync, a wall time between
        syncs above the block's sensor span lowers solver_budget by one
        (not below cfg.solver.min_iters), one under 0.7 of the span raises
        it (not above max_iters). Pending loop work is drained at the end.
        gumbel: optional per-frame RANSAC noise [n, n_hyps, M]. Returns
        one output per input frame."""
        n = int(imgs.shape[0])
        results: List[PipelineOutput] = []
        i = 0
        inflight = []                # (handle, start, end), oldest first
        last_sync_t = None

        def dispatch_next():
            nonlocal i
            e = min(i + block, n)
            handle = self.dispatch_block(
                imgs[i:e], pre_mod.ImuChunk(*[x[i:e] for x in chunks]),
                ts=ts[i:e] if ts is not None else None,
                gumbel=None if gumbel is None else gumbel[i:e])
            inflight.append((handle, i, e))
            i = e

        while i < n or inflight:
            # A failure empties `inflight` first, so interactive frames
            # never run beside a block in flight.
            if not self.initialized and not inflight:
                results.append(self.process_frame(
                    imgs[i],
                    pre_mod.ImuChunk(*[x[i] for x in chunks]),
                    t=float(ts[i]) if ts is not None else 0.0,
                    gumbel=None if gumbel is None else gumbel[i]))
                i += 1
                continue
            while i < n and self.initialized and len(inflight) < depth:
                dispatch_next()
            handle, s0, e0 = inflight.pop(0)
            prep = self.sync_block(handle)
            self.insert_block_keyframes(prep)
            results.extend(self.publish_block(prep))
            if prep["fail_at"] is not None:
                # The blocks behind it started from the frozen state;
                # _fail_reset has replaced the committed state.
                inflight.clear()
                last_sync_t = None
                i = s0 + prep["fail_at"] + 1
                continue
            now = time.perf_counter()
            if realtime and ts is not None and e0 - s0 >= 2 \
                    and last_sync_t is not None:
                span = float(ts[e0 - 1] - ts[s0]) * (e0 - s0) / (e0 - s0 - 1)
                wall = now - last_sync_t
                if span > 0:
                    if wall > span and \
                            self.solver_budget > self._budget_floor:
                        self.solver_budget -= 1
                    elif wall < 0.7 * span and \
                            self.solver_budget < self.cfg.solver.max_iters:
                        self.solver_budget += 1
            last_sync_t = now
        self.drain_loop_work()
        return results

    def _null_output(self, t, front, status: str = "",
                     initialized: bool = False) -> PipelineOutput:
        return PipelineOutput(
            t=t, p=np.zeros(3, np.float32),
            q=np.array([1, 0, 0, 0], np.float32),
            p_raw=np.zeros(3, np.float32), is_keyframe=False,
            initialized=initialized, n_tracked=int(front.n_tracked),
            solver_cost=0.0, loop_hit=None, status=status)
