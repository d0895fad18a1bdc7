"""Full-system orchestration without loop closure (port of the
use_loop=False subset of vins_tpu/pipeline.VinsSystem).

INITIAL: interactive frames through the tracker; every freq-th frame
joins the boot window, and once it holds F frames the `initializer`
bootstraps the backend (the port of core/initialization.py is still to
come — ROADMAP item 17 — so the caller supplies it, e.g.
io.synthetic.ground_truth_initializer). NON_LINEAR: blocks of frames
through stream.run_vio_scan; an in-block failure re-enters INITIAL and
the tail of the stream is reprocessed. With no loop closure the drift
correction is the identity, so published poses are the raw VIO poses.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from .config import VinsConfig
from .core import feature_manager as fm
from .core import marginalization as marg
from .core import pnp as pnp_mod
from .core import preintegration as pre_mod
from .core.estimator import BackendState, LoopInput
from .core.factors import Extrinsics
from .core.state import FeatureTable, WindowState
from .frontend.tracker import FeatureTracker
from .utils import lie
from . import stream as stream_mod

# initializer(feats, chunks, frames) -> solved WindowState, or None when
# the boot window cannot be initialized (the oldest frame is then dropped
# and the next backend frame retries). frames: the stream indices of the
# F boot frames; chunks: their F-1 merged IMU edges, stacked.
Initializer = Callable[[FeatureTable, pre_mod.ImuChunk, List[int]],
                       Optional[WindowState]]


class PipelineOutput(NamedTuple):
    t: float
    p: np.ndarray            # [3] published position
    q: np.ndarray            # [4]
    p_raw: np.ndarray        # [3] raw VIO position (equal to p here)
    is_keyframe: bool
    initialized: bool
    n_tracked: int
    solver_cost: float
    loop_hit: Optional[int]  # always None without loop closure
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


def default_extrinsics(cfg: VinsConfig, device="cpu") -> Extrinsics:
    cam = cfg.camera
    return Extrinsics(
        tic=torch.tensor(cam.tic, dtype=torch.float32, device=device),
        qic=lie.rotmat_to_quat(torch.tensor(cam.ric_matrix(),
                                            device=device)))


class VinsSystem:
    """End-to-end VIO on one device, loop closure off."""

    def __init__(self, cfg: VinsConfig, seed: int = 0, use_pnp: bool = True,
                 use_loop: bool = False, ext: Optional[Extrinsics] = None,
                 device="cpu", initializer: Optional[Initializer] = None):
        if use_loop:
            raise NotImplementedError(
                "loop closure is not ported yet (ROADMAP items 18-20); "
                "construct VinsSystem with use_loop=False")
        self.cfg = cfg
        self.device = torch.device(device)
        self.ext = ext if ext is not None else default_extrinsics(
            cfg, self.device)
        self.gravity = torch.tensor([0.0, 0.0, cfg.imu.gravity],
                                    device=self.device)
        self.initializer = initializer
        self.tracker = FeatureTracker(cfg, seed, self.device)
        self.use_pnp = use_pnp
        self.use_loop = False
        self.loop = None
        self.solver_budget = cfg.solver.max_iters
        self._loop_inactive = LoopInput.inactive(cfg.window.max_landmarks,
                                                 device=self.device)
        self.timings = {"dispatch": 0.0, "sync": 0.0, "publish": 0.0,
                        "blocks": 0, "host_syncs": 0}
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
        self._pending_chunk: Optional[pre_mod.ImuChunk] = None
        self._loop_state = self._loop_inactive
        if not keep_trajectory:
            self.trajectory: List[np.ndarray] = []
            self._recover_anchor = None
            self._last_good = None

    def _fail_reset(self):
        """Failure recovery (VINS.cpp:463-467): re-enter INITIAL, keep the
        trajectory, re-anchor the next init at the last good pose."""
        anchor = self._last_good
        self.reset(keep_trajectory=True)
        self._recover_anchor = anchor

    def _merge_pending(self, chunk: pre_mod.ImuChunk) -> pre_mod.ImuChunk:
        if self._pending_chunk is None:
            return chunk
        return marg.merge_chunks(self._pending_chunk, chunk)

    # -- interactive entry (INITIAL) -----------------------------------------

    def process_frame(self, img: torch.Tensor, chunk: pre_mod.ImuChunk,
                      t: float = 0.0,
                      gumbel: Optional[torch.Tensor] = None
                      ) -> PipelineOutput:
        """One camera frame + the IMU chunk since the previous frame, while
        the system is not initialized. gumbel: optional RANSAC noise."""
        if self.initialized:
            raise NotImplementedError(
                "interactive NON_LINEAR frames (_process_nonlinear) are not "
                "ported yet; feed initialized frames through process_stream")
        is_backend_frame = (self.frame_idx % self.cfg.freq) == 0
        front = self.tracker.process(img, do_topup=True, gumbel=gumbel)
        frame = self.frame_idx
        self.frame_idx += 1
        out = self._process_boot(front, chunk, t, is_backend_frame, frame)
        self.trajectory.append(out.p)
        return out

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
        if self.initializer is None:
            raise NotImplementedError(
                "visual-inertial initialization (core/initialization.py) "
                "is not ported yet (ROADMAP item 17): pass an initializer, "
                "e.g. io.synthetic.ground_truth_initializer(seq, cfg)")

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
        window = self.initializer(feats, chunks,
                                  [bf.frame for bf in self.boot])
        if window is None:
            self.boot.pop(0)
            return self._null_output(t, front, status="FAIL_INIT")

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
        p_raw = window.p[F - 1].cpu().numpy()
        q_raw = window.q[F - 1].cpu().numpy()
        self._last_good = (p_raw, lie.np_yaw(q_raw))
        return PipelineOutput(
            t=t, p=p_raw, q=q_raw, p_raw=p_raw, is_keyframe=True,
            initialized=True, n_tracked=int(front.n_tracked),
            solver_cost=0.0, loop_hit=None)

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
            phase=self.frame_idx % self.cfg.freq, loop=self._loop_state,
            solver_budget=self.solver_budget)

    def dispatch_block(self, imgs: torch.Tensor, chunks: pre_mod.ImuChunk,
                       ts=None, gumbel: Optional[torch.Tensor] = None):
        """Run the block pipeline over imgs [N, H, W] and commit the state
        (device work is enqueued; the host syncs only on keyframe
        branches). Returns a handle for sync_block."""
        if not self.initialized:
            raise RuntimeError("block mode requires an initialized system")
        t0 = time.perf_counter()
        state2, outs = stream_mod.run_vio_scan(
            self._scan_state(), imgs.to(self.device, torch.float32), chunks,
            self.cfg, self.ext, self.gravity, use_pnp=self.use_pnp,
            gumbel=gumbel)
        n = int(imgs.shape[0])
        self.tracker.state = state2.tracker
        self.pnp = state2.pnp
        self.est = state2.est
        self._loop_state = state2.loop
        self._pending_chunk = state2.pending if state2.has_pending else None
        self.frame_idx += n
        self.timings["dispatch"] += time.perf_counter() - t0
        self.timings["blocks"] += 1
        # One keyframe-branch sync per backend frame (core/estimator.py).
        self.timings["host_syncs"] += int(sum(
            1 for k in range(n) if (self.frame_idx - n + k) % self.cfg.freq
            == 0))
        return (outs, n, ts)

    def sync_block(self, handle):
        """Fetch the block's packed per-frame rows (one device-to-host copy
        plus the sparse map) and run the failure bookkeeping."""
        t0 = time.perf_counter()
        outs, n, ts = handle
        packed_h = outs.packed.cpu().numpy()
        pcl_h = outs.point_cloud.cpu().numpy()
        pok_h = outs.point_valid.cpu().numpy()
        self.timings["host_syncs"] += 1
        S = stream_mod
        p_h = packed_h[:, S.PACK_P]
        q_h = packed_h[:, S.PACK_Q]
        fail_h = packed_h[:, S.PACK_FAIL] > 0.5
        fail_idx = np.flatnonzero(fail_h)
        fail_at = int(fail_idx[0]) if len(fail_idx) else None
        n_ok = fail_at if fail_at is not None else n
        if fail_at is not None:
            if fail_at >= 1:
                self._last_good = (p_h[fail_at - 1],
                                   lie.np_yaw(q_h[fail_at - 1]))
            self._fail_reset()
        elif n_ok >= 1:
            self._last_good = (p_h[n_ok - 1], lie.np_yaw(q_h[n_ok - 1]))
        self.timings["sync"] += time.perf_counter() - t0
        return dict(n=n, n_ok=n_ok, fail_at=fail_at, p=p_h, q=q_h,
                    is_kf=packed_h[:, S.PACK_IS_KF] > 0.5,
                    is_be=packed_h[:, S.PACK_IS_BE] > 0.5,
                    cost=packed_h[:, S.PACK_COST],
                    ntr=packed_h[:, S.PACK_NTRACK].astype(np.int32),
                    ts=ts, pcl=pcl_h, pok=pok_h)

    def publish_block(self, prep) -> List[PipelineOutput]:
        """Assemble the per-frame outputs of a synced block."""
        t0 = time.perf_counter()
        ts = prep["ts"]
        results = []
        for k in range(prep["n_ok"]):
            t = float(ts[k]) if ts is not None else 0.0
            pcl = pval = None
            if prep["is_be"][k]:
                pcl = prep["pcl"][k].astype(np.float32)
                pval = prep["pok"][k]
            p = prep["p"][k]
            results.append(PipelineOutput(
                t=t, p=p, q=prep["q"][k], p_raw=p,
                is_keyframe=bool(prep["is_kf"][k]), initialized=True,
                n_tracked=int(prep["ntr"][k]),
                solver_cost=float(prep["cost"][k]), loop_hit=None,
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

    def process_stream(self, imgs: torch.Tensor, chunks: pre_mod.ImuChunk,
                       block: int = 48, ts=None,
                       gumbel: Optional[torch.Tensor] = None
                       ) -> List[PipelineOutput]:
        """A staged sequence: interactive frames until initialized, then
        blocks of `block` frames; an in-block failure re-enters INITIAL
        and reprocesses from the frame after the failure. gumbel:
        optional per-frame RANSAC noise [n, n_hyps, M]. Returns one
        output per input frame."""
        n = int(imgs.shape[0])
        results: List[PipelineOutput] = []
        i = 0
        while i < n:
            g = None if gumbel is None else gumbel
            if not self.initialized:
                results.append(self.process_frame(
                    imgs[i].to(self.device, torch.float32),
                    pre_mod.ImuChunk(*[x[i] for x in chunks]),
                    t=float(ts[i]) if ts is not None else 0.0,
                    gumbel=None if g is None else g[i]))
                i += 1
                continue
            e = min(i + block, n)
            handle = self.dispatch_block(
                imgs[i:e], pre_mod.ImuChunk(*[x[i:e] for x in chunks]),
                ts=ts[i:e] if ts is not None else None,
                gumbel=None if g is None else g[i:e])
            prep = self.sync_block(handle)
            results.extend(self.publish_block(prep))
            i = i + prep["fail_at"] + 1 if prep["fail_at"] is not None \
                else e
        return results

    def _null_output(self, t, front, status: str = "",
                     initialized: bool = False) -> PipelineOutput:
        return PipelineOutput(
            t=t, p=np.zeros(3, np.float32),
            q=np.array([1, 0, 0, 0], np.float32),
            p_raw=np.zeros(3, np.float32), is_keyframe=False,
            initialized=initialized, n_tracked=int(front.n_tracked),
            solver_cost=0.0, loop_hit=None, status=status)
