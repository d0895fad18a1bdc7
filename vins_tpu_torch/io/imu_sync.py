"""Accel/gyro stream alignment and IMU-to-image batching (port of
vins_tpu/io/imu_sync.py).

The reference fuses accelerometer and gyroscope callbacks by linearly
interpolating acceleration to each gyro stamp
(ViewController.mm:1020-1173), then gives every image all IMU samples up
to its stamp (getMeasurements, ViewController.mm:604-638). Host-side
numpy, run once per dataset or stream; only the packed chunks go to the
device.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..core.preintegration import ImuChunk


def interpolate_imu(t_gyro: np.ndarray, gyro: np.ndarray,
                    t_accel: np.ndarray, accel: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fuse async accel/gyro streams at the gyro stamps: accel linearly
    interpolated to each gyro stamp, gyro samples outside the accel span
    dropped. Returns (t [N], accel [N, 3], gyro [N, 3]) with t strictly
    increasing."""
    t_gyro = np.asarray(t_gyro, np.float64)
    t_accel = np.asarray(t_accel, np.float64)
    gyro = np.asarray(gyro, np.float64)
    accel = np.asarray(accel, np.float64)
    keep = (t_gyro >= t_accel[0]) & (t_gyro <= t_accel[-1])
    t = t_gyro[keep]
    g = gyro[keep]
    a = np.stack([np.interp(t, t_accel, accel[:, i]) for i in range(3)],
                 axis=1)
    order = np.argsort(t, kind="stable")
    t, a, g = t[order], a[order], g[order]
    uniq = np.concatenate([[True], np.diff(t) > 0])
    return t[uniq], a[uniq], g[uniq]


def align_measurements(t_imu: np.ndarray, t_img: np.ndarray
                       ) -> List[Tuple[int, int]]:
    """For each image k the half-open IMU index range [lo, hi) of the
    samples with t_img[k-1] < t <= t_img[k] (empty before the first IMU
    sample)."""
    t_imu = np.asarray(t_imu, np.float64)
    t_img = np.asarray(t_img, np.float64)
    his = np.searchsorted(t_imu, t_img, side="right")
    ranges = []
    lo = 0
    for hi in his:
        ranges.append((lo, int(hi)))
        lo = int(hi)
    return ranges


def chunk_imu(t_imu: np.ndarray, accel: np.ndarray, gyro: np.ndarray,
              t_img: np.ndarray, max_per_edge: int,
              device=None) -> ImuChunk:
    """Per-image IMU ranges packed into stacked fixed-size chunks on
    `device` (None: the first CUDA card): dt [F, M], acc/gyr [F, M, 3].
    Row 0 of each edge is the seed sample at the previous image stamp
    (dt = 0), rows 1..k integrate, padding rows have dt = 0. The last
    sub-interval extends to the image stamp (zero-order hold, send_imu of
    ViewController.mm:661-681); samples beyond M accumulate their dt into
    the final row so the integration time is kept."""
    dev = device_mod.resolve(device)
    t_imu = np.asarray(t_imu, np.float64)
    F = len(t_img)
    M = max_per_edge
    dt = np.zeros((F, M), np.float32)
    acc = np.zeros((F, M, 3), np.float32)
    gyr = np.zeros((F, M, 3), np.float32)
    for k, (lo, hi) in enumerate(align_measurements(t_imu, t_img)):
        if hi <= lo:
            continue
        t_prev = t_img[k - 1] if k > 0 else t_imu[lo]
        seed = max(lo - 1, 0) if k > 0 else lo
        acc[k, 0] = accel[seed]
        gyr[k, 0] = gyro[seed]
        j = 1
        for i in range(lo, hi):
            d = t_imu[i] - t_prev
            t_prev = t_imu[i]
            if d < 0:
                continue
            if j >= M:
                dt[k, M - 1] += d
                acc[k, M - 1] = accel[i]
                gyr[k, M - 1] = gyro[i]
                continue
            dt[k, j] = d
            acc[k, j] = accel[i]
            gyr[k, j] = gyro[i]
            j += 1
        tail = t_img[k] - t_prev
        if tail > 1e-9:
            if j < M:
                dt[k, j] = tail
                acc[k, j] = acc[k, j - 1]
                gyr[k, j] = gyr[k, j - 1]
            else:
                dt[k, M - 1] += tail
    return ImuChunk(*(torch.as_tensor(x, device=dev) for x in (dt, acc, gyr)))
