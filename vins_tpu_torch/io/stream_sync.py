"""Live-sensor entry: accel, gyro and image stamps pushed as they arrive,
one IMU chunk polled per image (port of the pure-Python StreamSync of
vins_tpu/io/native_runtime.py; the C++ runtime behind ctypes is
io/native_runtime.NativeStreamSync).

Accel is interpolated to each gyro stamp as it becomes bracketed; an
image is ready once a fused sample at or after its stamp exists, and
polling it packs the fused samples since the previous image exactly as
io/imu_sync.chunk_imu does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..core.preintegration import ImuChunk


class StreamSync:
    """Bounded queues of accel, gyro, fused IMU samples and image stamps;
    poll() returns (image id, stamp, ImuChunk on `device`) or None.
    device=None means the first CUDA card."""

    def __init__(self, max_per_edge: int, imu_capacity: int = 4096,
                 img_capacity: int = 64, device=None):
        self.N = max_per_edge
        self.device = device_mod.resolve(device)
        self.accel: list = []
        self.gyro: list = []
        self.fused: list = []   # (t, acc[3], gyr[3])
        self.images: list = []
        self.last_img_t: Optional[float] = None
        self.imu_capacity = imu_capacity
        self.img_capacity = img_capacity

    def push_accel(self, t, xyz) -> bool:
        if self.accel and t <= self.accel[-1][0]:
            return False
        self.accel.append((float(t), np.asarray(xyz, np.float64)))
        self._fuse()
        return True

    def push_gyro(self, t, xyz) -> bool:
        if self.gyro and t <= self.gyro[-1][0]:
            return False
        self.gyro.append((float(t), np.asarray(xyz, np.float64)))
        self._fuse()
        return True

    def push_image(self, t, image_id) -> bool:
        if len(self.images) >= self.img_capacity:
            return False
        if self.images and t <= self.images[-1][0]:
            return False
        self.images.append((float(t), int(image_id)))
        return True

    def _fuse(self):
        while self.gyro and len(self.accel) >= 2:
            tg, g = self.gyro[0]
            if tg < self.accel[0][0]:
                self.gyro.pop(0)
                continue
            while len(self.accel) >= 2 and self.accel[1][0] < tg:
                self.accel.pop(0)
            if len(self.accel) < 2:
                break
            (t0, a0), (t1, a1) = self.accel[0], self.accel[1]
            if tg < t0:
                self.gyro.pop(0)
                continue
            w = (tg - t0) / (t1 - t0) if t1 > t0 else 0.0
            fa = a0 + w * (a1 - a0)
            if not self.fused or tg > self.fused[-1][0]:
                self.fused.append((tg, fa, g))
                if len(self.fused) > self.imu_capacity:
                    self.fused.pop(0)
            self.gyro.pop(0)

    def pending(self) -> int:
        """Images whose IMU interval is complete."""
        if not self.fused:
            return 0
        t_max = self.fused[-1][0]
        return sum(1 for (t, _) in self.images if t <= t_max)

    def poll(self) -> Optional[Tuple[int, float, ImuChunk]]:
        if not self.images:
            return None
        t_img, img_id = self.images[0]
        if not self.fused or self.fused[-1][0] < t_img:
            return None
        self.images.pop(0)
        N = self.N
        dt = np.zeros(N, np.float32)
        acc = np.zeros((N, 3), np.float32)
        gyr = np.zeros((N, 3), np.float32)

        t_prev = self.last_img_t
        seed = None
        win = []
        while self.fused and self.fused[0][0] <= t_img:
            s = self.fused.pop(0)
            if t_prev is not None and s[0] <= t_prev:
                seed = s
                continue
            win.append(s)
        if t_prev is None:
            t_prev = win[0][0] if win else t_img
        if seed is None and win:
            seed = win[0]
        if seed is not None:
            acc[0] = seed[1]
            gyr[0] = seed[2]

        j = 1
        t_cursor = t_prev
        for (t, a, g) in win:
            d = t - t_cursor
            t_cursor = t
            if d < 0:
                continue
            if j >= N:
                dt[N - 1] += d
                acc[N - 1] = a
                gyr[N - 1] = g
                continue
            dt[j] = d
            acc[j] = a
            gyr[j] = g
            j += 1
        tail = t_img - t_cursor
        if tail > 1e-9 and j > 1:
            if j < N:
                dt[j] = tail
                acc[j] = acc[j - 1]
                gyr[j] = gyr[j - 1]
            else:
                dt[N - 1] += tail

        self.last_img_t = t_img
        return img_id, t_img, ImuChunk(*(torch.as_tensor(x, device=self.device)
                                         for x in (dt, acc, gyr)))
