"""Keyframe database, loop detection, the loop-edge lifecycle and the
global BA on one device (port of vins_tpu/loop/keyframe_db.py).

Keyframes are rows of fixed-capacity device tensors (FAST + BRIEF
keypoints, their world points and track ids, drift-corrected and raw
poses). Place recognition scores a keyframe's tf-idf BoW row against
every stored row (or the grid global descriptor); host-side gating
applies the similarity floor, the dislocal window, segment separation,
island grouping and temporal consistency; geometric verification matches
descriptors, runs F-RANSAC on normalized coordinates and a Gauss–Newton
PnP of the old keyframe against the current keyframe's world points. A
verified hit becomes a tentative pose-graph edge, promoted when the
window solve refines it; the 4-DoF graph yields the drift correction.

Rows are written in place (the JAX module rebuilds each array); the DB
row count, segments, capture stamps, keyframe UIDs, raw positions and
yaws, and the loop-edge endpoints and weights are kept as host mirrors
so the streaming path never reads the device mid-block. Host scalars go
to the device as fill_ launches, not host-to-device copies, which would
synchronize the stream.

RANSAC hypotheses come from an injected Gumbel-noise source
(`ransac_noise(C) -> [C, hyps, Nf]`; the tests replay JAX's key chain
into it) or from the closer's torch.Generator.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..config import VinsConfig
from ..ops import brief as brief_mod
from ..ops import corners as corners_mod
from ..ops import ransac as ransac_mod
from ..utils import camera as cam_mod
from ..utils import lie
from . import vocabulary as vocab_mod
from .pose_graph import PoseGraph, drift_from_solution, optimize_pose_graph


class KeyframeDB(NamedTuple):
    """Fixed-capacity keyframe store (the live row count is the host
    mirror LoopCloser.count). Nf = features per keyframe."""

    p: torch.Tensor          # [K, 3] drift-corrected positions
    q: torch.Tensor          # [K, 4] drift-corrected attitudes
    p_origin: torch.Tensor   # [K, 3] poses at insertion (PnP prior)
    q_origin: torch.Tensor   # [K, 4]
    gdesc: torch.Tensor      # [K, 1024] global descriptors
    desc: torch.Tensor       # [K, Nf, 8] int32 packed BRIEF words
    kp_norm: torch.Tensor    # [K, Nf, 2] normalized image coordinates
    kp_px: torch.Tensor      # [K, Nf, 2] pixel coordinates
    pts_w: torch.Tensor      # [K, Nf, 3] world points (uncorrected)
    pts_ok: torch.Tensor     # [K, Nf] bool world point valid
    kp_ok: torch.Tensor      # [K, Nf] bool keypoint valid
    segment: torch.Tensor    # [K] int32 trajectory segment
    tid: torch.Tensor        # [K, Nf] int32 track id of window rows, or -1

    @staticmethod
    def empty(K: int, Nf: int, dtype=torch.float32,
              device="cpu") -> "KeyframeDB":
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        qi = lie.quat_identity(dtype, device)[None].repeat(K, 1)
        return KeyframeDB(
            p=z(K, 3), q=qi, p_origin=z(K, 3), q_origin=qi.clone(),
            gdesc=z(K, 1024),
            desc=torch.zeros((K, Nf, 8), dtype=torch.int32, device=device),
            kp_norm=z(K, Nf, 2), kp_px=z(K, Nf, 2), pts_w=z(K, Nf, 3),
            pts_ok=torch.zeros((K, Nf), dtype=torch.bool, device=device),
            kp_ok=torch.zeros((K, Nf), dtype=torch.bool, device=device),
            segment=torch.zeros(K, dtype=torch.int32, device=device),
            tid=torch.full((K, Nf), -1, dtype=torch.int32, device=device))


class LoopHit(NamedTuple):
    old_idx: int            # matched keyframe row
    cur_idx: int            # query keyframe row
    n_inliers: int
    t_rel: np.ndarray       # [3] current body pose in the old frame
    yaw_rel: float
    pts_w: np.ndarray = None       # [Nf, 3] current-keyframe world points
    obs_old: np.ndarray = None     # [Nf, 2] matched normalized obs, old kf
    match_ok: np.ndarray = None    # [Nf] bool
    p_old: np.ndarray = None       # [3] PnP-refined old body pose (raw)
    q_old: np.ndarray = None       # [4]
    p_cur: np.ndarray = None       # [3] current keyframe's raw pose
    q_cur: np.ndarray = None       # [4]
    tids: np.ndarray = None        # [Nf] int32 track ids of the cur rows
    edge_abs: int = -1             # absolute pose-graph edge id, -1 none


def _fill(dst: torch.Tensor, values) -> None:
    """Write host scalars into a small device view, one fill_ each (no
    host-to-device copy, so no stream synchronization)."""
    flat = dst.reshape(-1)
    for k, v in enumerate(np.asarray(values).reshape(-1)):
        flat[k:k + 1].fill_(v.item())


def extract_keyframe_features(img: torch.Tensor, cfg: VinsConfig,
                              n_feat: int, window_pts_px: torch.Tensor,
                              window_pts_ok: torch.Tensor):
    """The window's tracked features topped up with FAST corners to
    n_feat keypoints, those within PATCH_HALF + 4 px of a border dropped,
    and their BRIEF descriptors. Returns (pts_px [Nf,2], ok [Nf],
    desc [Nf,8])."""
    Mw = window_pts_px.shape[0]
    n_new = n_feat - Mw
    assert n_new >= 0, "keyframe feature budget below window feature count"
    resp = corners_mod.fast_score(img)
    occ = corners_mod.occupancy_cells(tuple(img.shape), window_pts_px,
                                      window_pts_ok,
                                      cfg.frontend.min_distance)
    pick = corners_mod.select_corners_grid(resp, occ, n_new,
                                           cfg.frontend.min_distance)
    n_pick = min(n_new, pick.pts.shape[0])
    pad = n_new - n_pick
    dev = img.device
    pts = torch.cat([window_pts_px, pick.pts[:n_pick],
                     torch.zeros((pad, 2), dtype=pick.pts.dtype,
                                 device=dev)])
    ok = torch.cat([window_pts_ok, pick.valid[:n_pick],
                    torch.zeros((pad,), dtype=torch.bool, device=dev)])
    border = brief_mod.PATCH_HALF + 4
    H, W = img.shape
    inb = ((pts[:, 0] >= border) & (pts[:, 0] < W - border)
           & (pts[:, 1] >= border) & (pts[:, 1] < H - border))
    ok = ok & inb
    desc = brief_mod.extract_brief(img, pts, ok)
    return pts, ok, desc


# Column layout of a slim verify row (one [21] float32 row per candidate).
_SLIM_NIN, _SLIM_YAW, _SLIM_GOOD, _SLIM_MSR = 0, 1, 2, 3
_SLIM_T = slice(4, 7)
_SLIM_P_OLD = slice(7, 10)
_SLIM_Q_OLD = slice(10, 14)
_SLIM_P_CUR = slice(14, 17)
_SLIM_Q_CUR = slice(17, 21)

# At most this many candidates are verified per gating round (the JAX
# module's fixed verify batch width; extra candidates re-detect later).
_VERIFY_PAD = 4


class LoopCloser:
    """Keyframe insertion, loop detection and the 4-DoF pose graph, on
    one device. device=None means the first CUDA card."""

    W_TENTATIVE = 0.02   # detection-time PnP edge, nearly inert
    W_REFINED = 1.0      # refined by the window solve

    def __init__(self, cfg: VinsConfig, seed: int = 0,
                 ext: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 vocab: Optional[vocab_mod.Vocabulary] = None, device=None,
                 ransac_noise: Optional[Callable[[int], torch.Tensor]] = None):
        """ext: (tic, qic) camera-IMU extrinsics, identity if None; vocab:
        the BoW tree, the shipped asset if None and place recognition is
        "bow"; ransac_noise: optional source of verify-RANSAC Gumbel
        noise [C, hyps, Nf] for C candidates."""
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        dev = self.device
        if vocab is None and cfg.loop.place_recognition == "bow":
            vocab = vocab_mod.default_vocabulary(dev)
        if ext is None:
            self.tic = torch.zeros(3, device=dev)
            self.qic = lie.quat_identity(device=dev)
        else:
            self.tic, self.qic = (x.to(dev) for x in ext)
        lp = cfg.loop
        K = lp.max_keyframes
        self.Nf = lp.max_kf_features
        self.db = KeyframeDB.empty(K, self.Nf, device=dev)
        self.graph = PoseGraph.empty(K, 64, device=dev)
        self.n_loops = 0          # live loop edges
        self.n_optimizes = 0      # pose-graph runs
        self.n_inserts = 0        # keyframes inserted
        # Detection funnel: queries gated, candidates verified, hits.
        self.detect_stats = {"queries": 0, "gated": 0, "verified": 0}
        self._loop_i_host = []
        self._loop_w_host = []
        self._edge_abs_host = []
        self._next_edge_abs = 0
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        self.ransac_noise = ransac_noise
        self.last_match: Optional[int] = None
        self.r_drift = np.eye(3, dtype=np.float32)
        self.t_drift = np.zeros(3, dtype=np.float32)
        self._drift_dirty = False
        self.segment = 0
        self.vocab = vocab
        n_words = (vocab.n_words if vocab is not None
                   else lp.vocab_k ** lp.vocab_levels)
        self.bow = torch.zeros((K, n_words), device=dev)
        self.count = 0
        self._segments_np = np.zeros(K, np.int32)
        self._kf_t_np = np.zeros(K, np.float64)
        self.generation = 0
        self._uid_np = np.full(K, -1, np.int64)
        self._next_uid = 0
        self._kf_p_np = np.zeros((K, 3), np.float32)
        self._kf_yaw_np = np.zeros(K, np.float32)
        self.n_edges_evicted = 0
        self._r_drift_dev = torch.eye(3, device=dev)
        self._t_drift_dev = torch.zeros(3, device=dev)
        self._thresh_sq = float(np.float32(
            (lp.geo_ransac_px / cfg.camera.focal) ** 2))

    def warm(self) -> None:
        """Run every steady-state loop program once before the stream needs
        it (the JAX closer's warm, which compiles them ahead of time): the
        kernel library is built on the card, then the keyframe insert's
        features, BRIEF words, global descriptor and BoW row, the batched
        scoring at 1 and _VERIFY_PAD queries, one geometric verify with its
        relative-pose PnP, and the pose graph with its drift run on dummy
        inputs of the steady-state shapes. The results are discarded; the
        DB, the graph and self.gen's state are left as they were."""
        from ..ops import native

        cfg, lp, dev = self.cfg, self.cfg.loop, self.device
        if dev.type == "cuda":
            native.library()
        gen_state = self.gen.get_state()
        H, W = cfg.camera.height, cfg.camera.width
        Mw = cfg.frontend.max_features
        with torch.no_grad():
            img = torch.zeros((H, W), device=dev)
            pts, ok, desc = extract_keyframe_features(
                img, cfg, self.Nf, torch.zeros((Mw, 2), device=dev),
                torch.zeros((Mw,), dtype=torch.bool, device=dev))
            cam_mod.pixel_to_normalized(cfg.camera, pts)
            brief_mod.global_descriptor(desc, ok, pts, (H, W))
            if self.vocab is not None:
                vocab_mod.transform(self.vocab, desc, ok)
            for q in (1, _VERIFY_PAD):
                self.dispatch_scores(list(range(min(q, self.db.p.shape[0]))))
            self._verify_hit(0, min(1, self.db.p.shape[0] - 1), None)
            g, _ = optimize_pose_graph(self.graph, 0,
                                       iters=lp.pose_graph_iters,
                                       n_back=lp.sequential_edges)
            drift_from_solution(g, 0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.gen.set_state(gen_state)

    # -- vocabulary --------------------------------------------------------

    def _bow_row(self, idx: int) -> None:
        _, bow = vocab_mod.transform(self.vocab, self.db.desc[idx],
                                     self.db.kp_ok[idx])
        self.bow[idx] = bow

    def _maybe_train_vocab(self) -> None:
        """Train the tree from the stored descriptors once enough
        keyframes exist (only without a shipped vocabulary), then fill
        every stored row's BoW vector."""
        lp = self.cfg.loop
        n = self.count
        if (self.vocab is not None or lp.place_recognition != "bow"
                or n < lp.vocab_train_after):
            return
        desc = self.db.desc[:n].cpu().numpy().reshape(-1, 8)
        ok = self.db.kp_ok[:n].cpu().numpy().reshape(-1)
        img_ids = np.repeat(np.arange(n), self.Nf)
        self.vocab = vocab_mod.train_vocabulary(
            desc[ok], k=lp.vocab_k, levels=lp.vocab_levels,
            iters=lp.vocab_train_iters, image_ids=img_ids[ok],
            device=self.device)
        for i in range(n):
            self._bow_row(i)

    # -- insertion ---------------------------------------------------------

    def _insert(self, idx, img, p, q, w_px, w_ok, w_w, w_wok, w_ids):
        """Feature extraction, descriptors, drift compose, DB row, graph
        node and BoW row of keyframe row idx, written in place."""
        cfg, Nf = self.cfg, self.Nf
        pts_px, kp_ok, desc = extract_keyframe_features(img, cfg, Nf, w_px,
                                                        w_ok)
        kp_norm = cam_mod.pixel_to_normalized(cfg.camera, pts_px)
        gdesc = brief_mod.global_descriptor(desc, kp_ok, pts_px,
                                            tuple(img.shape))
        Mw = w_px.shape[0]
        db, g = self.db, self.graph
        p_corr = self._r_drift_dev @ p + self._t_drift_dev
        q_corr = lie.rotmat_to_quat(self._r_drift_dev
                                    @ lie.quat_to_rotmat(q))
        # As the JAX module's _add_row writes them, the DB's origin columns
        # take the drift-composed pose too; the graph's origin columns
        # below keep the raw odometry.
        db.p[idx] = p_corr
        db.q[idx] = q_corr
        db.p_origin[idx] = p_corr
        db.q_origin[idx] = q_corr
        db.gdesc[idx] = gdesc
        db.desc[idx] = desc
        db.kp_norm[idx] = kp_norm
        db.kp_px[idx] = pts_px
        db.pts_w[idx].zero_()
        db.pts_w[idx, :Mw] = w_w
        db.pts_ok[idx].zero_()
        db.pts_ok[idx, :Mw] = w_wok & w_ok
        db.kp_ok[idx] = kp_ok
        db.segment[idx:idx + 1].fill_(self.segment)
        db.tid[idx].fill_(-1)
        db.tid[idx, :Mw] = torch.where(w_ok, w_ids.to(torch.int32), -1)
        # The node starts at the corrected pose; the origin columns keep
        # the raw odometry for the sequential measurements.
        ypr = lie.rotmat_to_ypr(lie.quat_to_rotmat(q_corr))
        ypr_raw = lie.rotmat_to_ypr(lie.quat_to_rotmat(q))
        g.t[idx] = p_corr
        g.yaw[idx] = ypr[0]
        g.pitch[idx] = ypr[1]
        g.roll[idx] = ypr[2]
        g.t_origin[idx] = p
        g.yaw_origin[idx] = ypr_raw[0]
        g.node_ok[idx:idx + 1].fill_(True)
        if self.vocab is not None:
            _, row = vocab_mod.transform(self.vocab, desc, kp_ok)
            self.bow[idx] = row

    def add_keyframe(self, img, p, q, window_pts_px, window_pts_ok,
                     window_pts_w, window_pts_w_ok, window_ids=None,
                     t: float = 0.0, p_host=None, yaw_host=None) -> int:
        """Insert a keyframe; returns its row. p/q: raw VIO body pose;
        window_*: the tracker's features with their world points and
        track ids; p_host/yaw_host: host copies of the raw pose and yaw
        (fetched from p/q when None, which synchronizes)."""
        idx = self.count
        K = self.db.p.shape[0]
        if idx >= K:
            self.resample()
            idx = self.count
        Mw = window_pts_px.shape[0]
        if window_ids is None:
            window_ids = torch.full((Mw,), -1, dtype=torch.int32,
                                    device=self.device)
        self._insert(idx, img.to(torch.float32), p, q, window_pts_px,
                     window_pts_ok, window_pts_w, window_pts_w_ok,
                     window_ids)
        self.n_inserts += 1
        self._segments_np[idx] = self.segment
        self._kf_t_np[idx] = t
        self._kf_p_np[idx] = (np.asarray(p_host, np.float32)
                              if p_host is not None
                              else p.cpu().numpy().astype(np.float32))
        if yaw_host is None:
            w, x, y, z = q.cpu().numpy().astype(np.float32)
            yaw_host = np.arctan2(2 * (w * z + x * y),
                                  1 - 2 * (y * y + z * z))
        self._kf_yaw_np[idx] = float(yaw_host)
        self._uid_np[idx] = self._next_uid
        self._next_uid += 1
        self.count = max(self.count, idx + 1)
        if self.vocab is None:
            self._maybe_train_vocab()
        return idx

    def anchor_rows(self, old_idx: int):
        """Device copies of keyframe old_idx's (desc, kp_ok, kp_norm) rows:
        the ride-time attach payload (stream.LoopAnchor)."""
        db = self.db
        return (db.desc[old_idx].clone(), db.kp_ok[old_idx].clone(),
                db.kp_norm[old_idx].clone())

    # -- stable identity ---------------------------------------------------

    def uid_of(self, idx: int) -> int:
        return int(self._uid_np[idx])

    def row_of(self, uid: int) -> int:
        rows = np.flatnonzero(self._uid_np[:self.count] == uid)
        return int(rows[0]) if len(rows) else -1

    def rows_of(self, uids) -> list:
        """Current rows for a UID list, dropping resampled-away frames."""
        return [r for r in (self.row_of(u) for u in uids) if r >= 0]

    def edge_index(self, edge_abs: int) -> int:
        """Live edge-table row of an absolute edge id, -1 if evicted."""
        if edge_abs < 0:
            return -1
        try:
            return self._edge_abs_host.index(edge_abs)
        except ValueError:
            return -1

    # -- detection ---------------------------------------------------------

    def dispatch_scores(self, idxs):
        """Similarity [Q, K] of each query row to every DB row (device
        tensor, fetched later by the caller) and the score floor."""
        lp = self.cfg.loop
        if lp.place_recognition == "bow" and self.vocab is not None:
            scores = torch.stack([vocab_mod.score_database(self.bow,
                                                           self.bow[i])
                                  for i in idxs])
            return scores, lp.min_similarity_bow
        rows = torch.stack([self.db.gdesc[i] for i in idxs])
        return rows @ self.db.gdesc.T, lp.min_similarity

    def detect(self, cur_idx: int) -> Optional[LoopHit]:
        return self.detect_many([cur_idx])[0]

    def detect_many(self, idxs) -> list:
        """Detect loops for several inserted keyframes (one scoring pass,
        then gating in query order and verification)."""
        if len(idxs) == 0:
            return []
        scores, floor = self.dispatch_scores(idxs)
        return self.detect_from_scores(idxs, scores.cpu().numpy(), floor)

    def detect_from_scores(self, idxs, scores_all, floor) -> list:
        pend = self.gate_and_dispatch(idxs, scores_all, floor)
        return self.finish_detect(pend, _fetch(
            self.pending_verify_handles(pend)))

    def gate_and_dispatch(self, idxs, scores_all, floor, slim: bool = False):
        """Gate each query in order (host numpy), then verify up to
        _VERIFY_PAD gated candidates, best scores first. Returns a pend
        object for finish_detect; its device results
        (pending_verify_handles) are fetched by the caller."""
        scores_all = np.asarray(scores_all)
        best_of = [self._gate(int(cur), scores_all[i].copy(), floor)
                   for i, cur in enumerate(idxs)]
        if sum(b is not None for b in best_of) > _VERIFY_PAD:
            scored = sorted(
                (i for i, b in enumerate(best_of) if b is not None),
                key=lambda i: -float(scores_all[i][best_of[i]]))
            for i in scored[_VERIFY_PAD:]:
                best_of[i] = None
        gated = [(int(cur), best) for cur, best in zip(idxs, best_of)
                 if best is not None]
        self.detect_stats["queries"] += len(best_of)
        self.detect_stats["gated"] += len(gated)
        uid_pairs = [None if best is None
                     else (self.uid_of(int(cur)), self.uid_of(best))
                     for cur, best in zip(idxs, best_of)]
        batch = self._dispatch_verify_batch(gated, slim) if gated else None
        markers, j = [], 0
        for best in best_of:
            markers.append(None if best is None else j)
            j += best is not None
        return (list(idxs), best_of, (markers, batch, slim),
                self.generation, uid_pairs)

    @staticmethod
    def pending_verify_handles(pend) -> list:
        _, batch, _slim = pend[2]
        return [batch] if batch is not None else []

    def finish_detect(self, pend, fetched) -> list:
        """Thresholds and LoopHit assembly from fetched verify results;
        rows captured before a resample() are re-resolved by UID."""
        idxs, best_of, (markers, _batch, slim), gen, uid_pairs = pend
        stale = gen != self.generation
        batch_h = fetched[0] if fetched else None
        out = []
        for cur, best, mk, up in zip(idxs, best_of, markers, uid_pairs):
            if mk is None:
                out.append(None)
                continue
            cur_r, best_r = int(cur), best
            if stale:
                cur_r, best_r = self.row_of(up[0]), self.row_of(up[1])
                if cur_r < 0 or best_r < 0:
                    out.append(None)
                    continue
            if slim:
                out.append(self._finish_verify_slim(cur_r, best_r,
                                                    batch_h[mk]))
            else:
                row = tuple(leaf[mk] for leaf in batch_h)
                out.append(self._finish_verify(cur_r, best_r, row))
        self.detect_stats["verified"] += sum(h is not None for h in out)
        return out

    def _gate(self, cur_idx: int, scores: np.ndarray,
              floor: float) -> Optional[int]:
        """Similarity gate (alpha x the previous keyframe's score, with a
        floor), dislocal window, segment separation, best entry of the
        best island, temporal consistency by entry id or by place."""
        lp = self.cfg.loop
        n = self.count
        if cur_idx < 1 or n <= lp.dislocal:
            self.last_match = None
            return None
        ns = float(scores[cur_idx - 1]) if cur_idx >= 1 else 1.0
        gate = max(lp.similarity_alpha * ns, floor)
        scores[max(0, cur_idx - lp.dislocal):] = -1.0
        seg = self._segments_np
        scores[seg != seg[cur_idx]] = -1.0
        cand = np.where(scores[:n] >= gate)[0]
        if len(cand) == 0:
            self.last_match = None
            return None
        splits = np.where(np.diff(cand) > lp.island_gap)[0] + 1
        islands = np.split(cand, splits)
        best_island = max(islands, key=lambda isl: scores[isl].sum())
        best = int(best_island[np.argmax(scores[best_island])])
        consistent = (self.last_match is not None
                      and (abs(self.last_match - best) <= lp.temporal_radius
                           or np.linalg.norm(self._kf_p_np[self.last_match]
                                             - self._kf_p_np[best])
                           <= lp.temporal_spatial_m))
        self.last_match = best
        if lp.temporal_k > 0 and not consistent:
            return None
        return best

    def _loop_relative_pose(self, cur: int, old: int, match_idx, match_ok):
        """PnP of the old keyframe's camera against the current keyframe's
        world points; returns (t_rel in the refined old body frame,
        yaw_rel, good, msr, p_old, q_old) between BODY poses."""
        db, tic, qic = self.db, self.tic, self.qic
        pts = db.pts_w[cur]
        ok = match_ok & db.pts_ok[cur]
        obs_old = db.kp_norm[old][match_idx.long()]
        p0_b, q0_b = db.p_origin[old], db.q_origin[old]
        q0_c = lie.quat_mul(q0_b, qic)
        p0_c = p0_b + lie.quat_rotate(q0_b, tic)
        p_c, q_c, msr = ransac_mod.pnp_gn(pts, obs_old, ok, p0_c, q0_c,
                                          iters=10)
        good = ((torch.sum(ok) >= 10) & torch.isfinite(msr)
                & (msr < self.cfg.loop.pnp_max_msr))
        q_old_new = lie.quat_mul(q_c, lie.quat_conj(qic))
        p_old_new = p_c - lie.quat_rotate(q_old_new, tic)
        p_cur, q_cur = db.p_origin[cur], db.q_origin[cur]
        R_old = lie.quat_to_rotmat(q_old_new)
        t_rel = R_old.T @ (p_cur - p_old_new)
        yaw_rel = (lie.rotmat_to_ypr(lie.quat_to_rotmat(q_cur))[0]
                   - lie.rotmat_to_ypr(R_old)[0])
        return t_rel, yaw_rel, good, msr, p_old_new, q_old_new

    def _verify_hit(self, cur: int, old: int, gumbel):
        """Descriptor matching, F-RANSAC and the relative-pose PnP of one
        (cur, old) pair: a tuple of device tensors (the _finish_verify
        order)."""
        lp, db = self.cfg.loop, self.db
        m = brief_mod.match_descriptors(
            db.desc[cur], db.desc[old], db.kp_ok[cur], db.kp_ok[old],
            max_dist=lp.match_max_dist, ratio=lp.match_ratio)
        obs_old = db.kp_norm[old][m.idx.long()]
        rr = ransac_mod.ransac_fundamental(
            db.kp_norm[cur], obs_old, m.ok, lp.geo_ransac_hyps,
            self._thresh_sq, gumbel=gumbel, generator=self.gen)
        mok = m.ok & rr.inliers
        n_in = torch.sum(mok)
        t_rel, yaw_rel, good, msr, p_old, q_old = self._loop_relative_pose(
            cur, old, m.idx, mok)
        return (n_in, t_rel, yaw_rel, good, msr, p_old, q_old, db.pts_w[cur],
                obs_old, mok & db.pts_ok[cur], db.p_origin[cur],
                db.q_origin[cur], db.tid[cur])

    def _dispatch_verify_batch(self, pairs, slim: bool = False):
        """Verify every gated (cur, old) pair. Returns device results: a
        [C, 21] slim row per candidate, or the full tuple stacked [C,
        ...]."""
        noise = (self.ransac_noise(len(pairs))
                 if self.ransac_noise is not None else None)
        rows = [self._verify_hit(c, o, None if noise is None else noise[k])
                for k, (c, o) in enumerate(pairs)]
        if not slim:
            return tuple(torch.stack(f) for f in zip(*rows))
        f32 = torch.float32
        return torch.stack([torch.cat([
            torch.stack([n_in.to(f32), yaw.to(f32), good.to(f32),
                         msr.to(f32)]),
            t_rel, p_old, q_old, p_cur, q_cur])
            for (n_in, t_rel, yaw, good, msr, p_old, q_old, _pts, _obs,
                 _mok, p_cur, q_cur, _tid) in rows])

    def _finish_verify_slim(self, cur_idx: int, best: int,
                            row: np.ndarray) -> Optional[LoopHit]:
        lp = self.cfg.loop
        if int(row[_SLIM_NIN]) < lp.min_loop_matches:
            return None
        if row[_SLIM_GOOD] < 0.5:
            return None
        yaw_rel = float(row[_SLIM_YAW])
        t_rel = np.asarray(row[_SLIM_T])
        if (abs(yaw_rel) > np.deg2rad(lp.yaw_reject_deg)
                or float(np.linalg.norm(t_rel)) > lp.trans_reject_m):
            return None
        hit = LoopHit(
            old_idx=best, cur_idx=cur_idx, n_inliers=int(row[_SLIM_NIN]),
            t_rel=t_rel, yaw_rel=yaw_rel,
            p_old=np.asarray(row[_SLIM_P_OLD]),
            q_old=np.asarray(row[_SLIM_Q_OLD]),
            p_cur=np.asarray(row[_SLIM_P_CUR]),
            q_cur=np.asarray(row[_SLIM_Q_CUR]))
        return hit._replace(edge_abs=self._add_loop_edge(hit))

    def _finish_verify(self, cur_idx: int, best: int,
                       fetched) -> Optional[LoopHit]:
        lp = self.cfg.loop
        (n_in, t_rel, yaw_rel, good, msr, p_old, q_old, pts_w_cur,
         obs_old_g, match_ok_g, p_cur, q_cur, tid_cur) = fetched
        if int(n_in) < lp.min_loop_matches or not bool(good):
            return None
        if (abs(float(yaw_rel)) > np.deg2rad(lp.yaw_reject_deg)
                or float(np.linalg.norm(t_rel)) > lp.trans_reject_m):
            return None
        hit = LoopHit(
            old_idx=best, cur_idx=cur_idx, n_inliers=int(n_in),
            t_rel=t_rel, yaw_rel=float(yaw_rel), pts_w=pts_w_cur,
            obs_old=obs_old_g, match_ok=match_ok_g, p_old=p_old,
            q_old=q_old, p_cur=p_cur, q_cur=q_cur, tids=tid_cur)
        return hit._replace(edge_abs=self._add_loop_edge(hit))

    # -- pose graph --------------------------------------------------------

    def _set_loop_edge(self, e: int, i: int, j: int, t, yaw: float,
                       w: float) -> None:
        g = self.graph
        _fill(g.loop_i[e:e + 1], [i])
        _fill(g.loop_j[e:e + 1], [j])
        self._refine_loop_edge(e, t, yaw, w)

    def _refine_loop_edge(self, e: int, t, yaw: float, w: float) -> None:
        g = self.graph
        _fill(g.loop_t[e], np.asarray(t, np.float32))
        _fill(g.loop_yaw[e:e + 1], [np.float32(yaw)])
        _fill(g.loop_w[e:e + 1], [np.float32(w)])

    def _evict_edge(self, v: int) -> None:
        """Remove edge row v, shifting later rows down, zeroing the last."""
        g = self.graph
        for a in (g.loop_i, g.loop_j, g.loop_t, g.loop_yaw, g.loop_w):
            a[v:-1] = a[v + 1:].clone()
            a[-1:].zero_()

    def _add_loop_edge(self, hit: LoopHit) -> int:
        """Record the hit as a tentative edge (evicting the lowest-weight,
        oldest edge when the table is full); returns its absolute id."""
        e = self.n_loops
        E = self.graph.loop_w.shape[0]
        if e >= E:
            v = int(np.argmin(self._loop_w_host))
            self._evict_edge(v)
            self.n_loops = e = E - 1
            self._loop_i_host.pop(v)
            self._loop_w_host.pop(v)
            self._edge_abs_host.pop(v)
            self.n_edges_evicted += 1
        self._set_loop_edge(e, hit.old_idx, hit.cur_idx, hit.t_rel,
                            hit.yaw_rel, self.W_TENTATIVE)
        self.n_loops += 1
        self._loop_i_host.append(int(hit.old_idx))
        self._loop_w_host.append(self.W_TENTATIVE)
        abs_id = self._next_edge_abs
        self._next_edge_abs += 1
        self._edge_abs_host.append(abs_id)
        return abs_id

    def update_loop_edge(self, e: int, t_rel: np.ndarray, yaw_rel: float,
                         j: int = None):
        """Refine edge e with the window solve's relative pose, promoting
        it to full weight; j re-points its current endpoint."""
        if e < 0 or e >= self.n_loops:
            return
        if e < len(self._loop_w_host):
            self._loop_w_host[e] = self.W_REFINED
        if j is not None:
            self._set_loop_edge(e, self._loop_i_host[e], j, t_rel, yaw_rel,
                                self.W_REFINED)
            return
        self._refine_loop_edge(e, t_rel, yaw_rel, self.W_REFINED)

    def optimize(self, defer_fetch: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Run the 4-DoF pose graph from the earliest loop node, write the
        optimized poses back to the DB and update the drift (its host copy
        now, or at the caller's next fetch with defer_fetch)."""
        if self.n_loops == 0:
            return self.r_drift, self.t_drift
        self.n_optimizes += 1
        lp = self.cfg.loop
        first = (min(self._loop_i_host) if self._loop_i_host
                 else int(torch.min(self.graph.loop_i[:self.n_loops])))
        g_after, _cost = optimize_pose_graph(
            self.graph, first, iters=lp.pose_graph_iters,
            n_back=lp.sequential_edges)
        R_d, t_d = drift_from_solution(g_after, self.count - 1)
        self.graph = g_after
        q_new = lie.rotmat_to_quat(lie.ypr_to_rotmat(torch.stack(
            [g_after.yaw, g_after.pitch, g_after.roll], -1)))
        self.db = self.db._replace(p=g_after.t.clone(), q=q_new)
        self._r_drift_dev, self._t_drift_dev = R_d, t_d
        if defer_fetch:
            self._drift_dirty = True
        else:
            self.r_drift = R_d.cpu().numpy()
            self.t_drift = t_d.cpu().numpy()
            self._drift_dirty = False
        return self.r_drift, self.t_drift

    def sync_drift(self, r_host=None, t_host=None) -> None:
        """Install host copies of the drift from a caller's fetch, or fetch
        them now if none are given."""
        if not self._drift_dirty:
            return
        if r_host is None:
            r_host = self._r_drift_dev.cpu().numpy()
            t_host = self._t_drift_dev.cpu().numpy()
        self.r_drift = np.asarray(r_host)
        self.t_drift = np.asarray(t_host)
        self._drift_dirty = False

    def global_ba(self, mesh=None, iters: int = 8, max_keyframes: int = 64,
                  max_landmarks: int = 512, defer_fetch: bool = False):
        """Global refinement over the map: the newest max_keyframes rows'
        poses and their multi-keyframe tracks harvested into a BAProblem
        and solved. The refined raw poses go to p_origin/q_origin and the
        pose graph's origin columns, their drift-composed version to p/q;
        with live loop edges the pose graph runs again to re-publish them.
        Returns the final cost (None with defer_fetch, or when the map has
        no multi-keyframe track).

        mesh=None solves on this device (parallel.dist_ba.solve_ba). A
        torch.distributed mesh with a `block` axis makes this a collective
        call: this LoopCloser, on the first rank of its block group, owns
        the DB, harvests the problem, pads L to a multiple of the block
        size and broadcasts it with `iters`; every rank of the group
        solves its landmark shard (solve_ba_sharded), the others through
        parallel.dist_ba.global_ba_follower, and the result is written
        back here."""
        from ..parallel.dist_ba import (share_ba_problem, solve_ba,
                                        solve_ba_sharded)
        from ..parallel.harvest import (apply_ba_result, harvest_ba_problem,
                                        pad_landmarks_to)
        from ..parallel.mesh import BLOCK_AXIS, axis_size

        res = harvest_ba_problem(self.db, self.count, self.tic, self.qic,
                                 max_keyframes=max_keyframes,
                                 max_landmarks=max_landmarks)
        if mesh is not None:
            padded = (() if res is None else pad_landmarks_to(
                res.state, res.prob, axis_size(mesh, BLOCK_AXIS)))
            shared = share_ba_problem(mesh, *padded, iters=iters)
            if shared is None:
                return None
            state, prob, _ = shared
            solved, cost, _ = solve_ba_sharded(state, prob, mesh,
                                               iters=iters)
        elif res is None:
            return None
        else:
            solved, cost, _ = solve_ba(res.state, res.prob, iters=iters)
        self.db = apply_ba_result(self.db, res, solved, self.tic, self.qic,
                                  r_drift=self._r_drift_dev,
                                  t_drift=self._t_drift_dev)
        idx = torch.as_tensor(res.kf_indices, device=self.device)
        p_o = self.db.p_origin[idx]
        yaw = lie.rotmat_to_ypr(lie.quat_to_rotmat(self.db.q_origin[idx]))
        self.graph = self.graph._replace(
            t_origin=self.graph.t_origin.index_copy(0, idx, p_o),
            yaw_origin=self.graph.yaw_origin.index_copy(0, idx, yaw[:, 0]))
        if self.n_loops > 0:
            self.optimize(defer_fetch=defer_fetch)
        if defer_fetch:
            return None
        return float(cost)

    def new_segment(self):
        """Failure recovery: later keyframes form a new segment."""
        self.segment += 1

    def trajectory(self):
        """(t [n], p [n,3], q [n,4]) of the corrected keyframe path."""
        n = self.count
        return (self._kf_t_np[:n].copy(), self.db.p[:n].cpu().numpy(),
                self.db.q[:n].cpu().numpy())

    # -- capacity ----------------------------------------------------------

    def resample(self):
        """Distance-based decimation when the DB is full: keep frames at
        least min_dist from the last kept one (raised until a quarter of
        the slots free up), protecting loop-edge endpoints, the first and
        the most recent `dislocal` frames; compact every row and remap the
        edges. Reads the DB on the host (rare)."""
        n = self.count
        K = self.db.p.shape[0]
        p = self.db.p[:n].cpu().numpy()
        protected = np.zeros(n, bool)
        protected[max(0, n - self.cfg.loop.dislocal):] = True
        protected[0] = True
        li_all = self.graph.loop_i.cpu().numpy()
        lj_all = self.graph.loop_j.cpu().numpy()
        li, lj = li_all[:self.n_loops], lj_all[:self.n_loops]
        protected[li[li < n]] = True
        protected[lj[lj < n]] = True

        seg_len = np.linalg.norm(np.diff(p, axis=0), axis=1)
        min_dist = max(float(np.median(seg_len)) * 2.0, 1e-3)
        keep = np.ones(n, bool)
        target_free = K // 4
        for _ in range(8):
            keep = protected.copy()
            last = p[0]
            for i in range(1, n):
                if protected[i]:
                    last = p[i]
                    continue
                if np.linalg.norm(p[i] - last) >= min_dist:
                    keep[i] = True
                    last = p[i]
            if (n - keep.sum()) >= target_free:
                break
            min_dist *= 1.6
        if (n - keep.sum()) < 1:
            keep = protected.copy()

        old_idx = np.where(keep)[0]
        m = len(old_idx)
        remap = -np.ones(n, np.int64)
        remap[old_idx] = np.arange(m)
        sel = torch.as_tensor(old_idx, device=self.device)

        def compact(a):
            out = torch.zeros_like(a)
            out[:m] = a[sel]
            return out

        self.db = KeyframeDB(*[compact(a) for a in self.db])
        self.bow = compact(self.bow)
        g = self.graph

        def remap_edges(e):
            return torch.as_tensor(np.where(
                e < n, remap[np.clip(e, 0, n - 1)], e).astype(np.int32),
                device=self.device)

        self.graph = g._replace(
            t=compact(g.t), yaw=compact(g.yaw), pitch=compact(g.pitch),
            roll=compact(g.roll), node_ok=compact(g.node_ok),
            t_origin=compact(g.t_origin), yaw_origin=compact(g.yaw_origin),
            loop_i=remap_edges(li_all), loop_j=remap_edges(lj_all))
        if self.last_match is not None:
            nm = remap[self.last_match] if self.last_match < n else -1
            self.last_match = int(nm) if nm >= 0 else None
        self._loop_i_host = [
            int(remap[i]) if i < n and remap[i] >= 0 else int(i)
            for i in self._loop_i_host]
        self.count = m

        def compact_np(a, fill=0):
            out = np.full_like(a, fill)
            out[:m] = a[old_idx]
            return out

        self._segments_np = compact_np(self._segments_np)
        self._kf_t_np = compact_np(self._kf_t_np)
        self._uid_np = compact_np(self._uid_np, -1)
        self._kf_p_np = compact_np(self._kf_p_np)
        self._kf_yaw_np = compact_np(self._kf_yaw_np)
        self.generation += 1


def _fetch(tree):
    """A nested list/tuple of tensors as host numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fetch(x) for x in tree)
    return tree
