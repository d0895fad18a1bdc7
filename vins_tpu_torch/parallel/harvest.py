"""A global BA problem harvested from the live keyframe database (port of
vins_tpu/parallel/harvest.py): the DB's raw keyframe poses, the
per-keyframe window features with their world points, and their global
track ids become a BAProblem; the solved poses are written back; a
problem is padded for a landmark-sharded solve.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import fetch_flat
from ..utils import lie
from .dist_ba import BAProblem, BAState

# A landmark is a track seen in at least this many keyframes.
_MIN_OBS = 2


class HarvestResult(NamedTuple):
    state: BAState          # camera poses + landmark points (initial)
    prob: BAProblem
    kf_indices: np.ndarray  # [K] DB rows the poses correspond to
    track_ids: np.ndarray   # [L] global track id per landmark row


def harvest_ba_problem(db, count: int, ext_tic, ext_qic,
                       max_keyframes: int = 64, max_landmarks: int = 512
                       ) -> Optional[HarvestResult]:
    """A (BAState, BAProblem) from the newest `max_keyframes` of the
    `count` live rows of a KeyframeDB, on the DB's device; None without a
    usable track.

    Landmarks are tracks seen in >= _MIN_OBS keyframes (the most observed
    max_landmarks); observations are the stored normalized keypoints; a
    track's initial point is the mean of its stored world points. Body
    poses become CAMERA poses (T_wc = T_wb · T_bc). The first two poses
    are frozen (gauge and scale anchors) and every pose carries a
    position prior of weight 0.3 per meter at its VIO estimate, which
    keeps the IMU-metric scale. The DB columns come to the host in one
    copy."""
    n = int(count)
    if n < 2:
        return None
    k0 = max(0, n - max_keyframes)
    sel = np.arange(k0, n)
    K = len(sel)
    tids, kp_ok, pts_ok, kp, ptsw = fetch_flat([
        db.tid[k0:n], db.kp_ok[k0:n], db.pts_ok[k0:n], db.kp_norm[k0:n],
        db.pts_w[k0:n]])
    ok = kp_ok & pts_ok & (tids >= 0)

    flat = tids[ok]
    if flat.size == 0:
        return None
    uniq, cnt = np.unique(flat, return_counts=True)
    good = uniq[cnt >= _MIN_OBS]
    if len(good) == 0:
        return None
    if len(good) > max_landmarks:
        good = good[np.argsort(-cnt[cnt >= _MIN_OBS],
                               kind="stable")[:max_landmarks]]
    L = len(good)

    tid2row = {int(t): i for i, t in enumerate(good)}
    obs = np.zeros((L, K, 2), np.float32)
    mask = np.zeros((L, K), np.float32)
    pts_sum = np.zeros((L, 3), np.float64)
    pts_cnt = np.zeros((L,), np.int64)
    for k in range(K):
        for r in np.flatnonzero(ok[k]):
            i = tid2row.get(int(tids[k, r]))
            if i is None:
                continue
            obs[i, k] = kp[k, r]
            mask[i, k] = 1.0
            pts_sum[i] += ptsw[k, r]
            pts_cnt[i] += 1
    pts0 = (pts_sum / np.maximum(pts_cnt, 1)[:, None]).astype(np.float32)

    dev = db.p.device
    q_b = db.q_origin[k0:n]
    q_c = lie.quat_mul(q_b, ext_qic.to(dev))
    p_c = db.p_origin[k0:n] + lie.quat_rotate(q_b, ext_tic.to(dev))
    pose_free = torch.ones(K, device=dev)
    pose_free[:2] = 0.0
    T = lambda x: torch.as_tensor(x, device=dev)
    state = BAState(p=p_c, q=q_c, pts=T(pts0))
    prob = BAProblem(obs=T(obs), mask=T(mask), pose_free=pose_free,
                     prior_p=p_c.clone(),
                     prior_w=torch.tensor(0.3, device=dev))
    return HarvestResult(state=state, prob=prob, kf_indices=sel,
                         track_ids=good)


def apply_ba_result(db, res: HarvestResult, solved: BAState,
                    ext_tic, ext_qic, r_drift=None, t_drift=None):
    """The DB with the refined CAMERA poses written back as BODY poses:
    the raw columns (p_origin, q_origin) get them as solved (the BA runs
    in the raw odometry frame), the published columns (p, q) their
    drift-composed version (identical without a drift)."""
    dev = db.p.device
    q_b = lie.quat_mul(solved.q, lie.quat_conj(ext_qic.to(dev)))
    p_b = solved.p - lie.quat_rotate(q_b, ext_tic.to(dev))
    idx = torch.as_tensor(res.kf_indices, device=dev)
    if r_drift is None:
        p_pub, q_pub = p_b, q_b
    else:
        r_drift = torch.as_tensor(r_drift, dtype=p_b.dtype, device=dev)
        t_drift = torch.as_tensor(t_drift, dtype=p_b.dtype, device=dev)
        p_pub = p_b @ r_drift.T + t_drift[None, :]
        q_pub = lie.quat_mul(lie.rotmat_to_quat(r_drift)[None], q_b)
    return db._replace(
        p=db.p.index_copy(0, idx, p_pub), q=db.q.index_copy(0, idx, q_pub),
        p_origin=db.p_origin.index_copy(0, idx, p_b),
        q_origin=db.q_origin.index_copy(0, idx, q_b))


def pad_landmarks_to(state: BAState, prob: BAProblem, multiple: int):
    """(state, prob) with L padded by masked zero rows up to a multiple of
    `multiple` (the block size of a sharded solve). A padded row has no
    observation: the solve leaves its point at zero, and its cost and
    normal equations are zero."""
    L = prob.mask.shape[0]
    n = -(-L // multiple) * multiple - L
    if n == 0:
        return state, prob
    pad = lambda a: torch.cat([a, a.new_zeros((n,) + a.shape[1:])], 0)
    return (state._replace(pts=pad(state.pts)),
            prob._replace(obs=pad(prob.obs), mask=pad(prob.mask)))
