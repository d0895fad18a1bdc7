"""Trajectory accuracy (port of vins_tpu/io/evaluate.py, numpy only):
ATE after Umeyama alignment, the relative-pose translation error over a
fixed frame delta, and the path length."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class AteResult(NamedTuple):
    rmse: float
    mean: float
    median: float
    max: float
    R: np.ndarray       # alignment rotation
    t: np.ndarray       # alignment translation
    s: float            # alignment scale


def umeyama(src: np.ndarray, dst: np.ndarray,
            with_scale: bool = False) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform dst ≈ s·R·src + t."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float((D * np.diagonal(S)).sum() / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(est_p: np.ndarray, gt_p: np.ndarray,
             with_scale: bool = False) -> AteResult:
    """Absolute trajectory error after alignment. est_p/gt_p: [N, 3]."""
    est_p = np.asarray(est_p, np.float64)
    gt_p = np.asarray(gt_p, np.float64)
    R, t, s = umeyama(est_p, gt_p, with_scale)
    d = np.linalg.norm(gt_p - (s * est_p @ R.T + t), axis=1)
    return AteResult(rmse=float(np.sqrt((d ** 2).mean())),
                     mean=float(d.mean()), median=float(np.median(d)),
                     max=float(d.max()), R=R, t=t, s=s)


def rpe(est_p: np.ndarray, gt_p: np.ndarray, delta: int = 10
        ) -> Tuple[float, float]:
    """Relative pose (translation) error over a fixed frame delta.
    Returns (rmse, mean) of the per-pair relative-translation error norms."""
    est_p = np.asarray(est_p, np.float64)
    gt_p = np.asarray(gt_p, np.float64)
    if len(est_p) - delta <= 0:
        return 0.0, 0.0
    de = est_p[delta:] - est_p[:-delta]
    dg = gt_p[delta:] - gt_p[:-delta]
    err = np.linalg.norm(de - dg, axis=1)
    return float(np.sqrt((err ** 2).mean())), float(err.mean())


def trajectory_length(p: np.ndarray) -> float:
    p = np.asarray(p, np.float64)
    return float(np.linalg.norm(np.diff(p, axis=0), axis=1).sum())
