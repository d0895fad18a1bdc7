"""ctypes wrapper for the native streaming runtime (native/runtime.cpp;
port of vins_tpu/io/native_runtime.py): sensor ring buffers, accel→gyro
interpolation and per-image IMU chunk packing in C++, without Python
between a sensor callback and the chunk.

NativeStreamSync binds the library io/native_build compiles from the
shared source into the port's _build/ at first use (never at import, and
never into native/); its poll() returns the port's ImuChunk tensors on
its device, as the pure-Python StreamSync (io/stream_sync.py, re-exported
here) does. make_stream_sync picks the native one when it builds.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..core.preintegration import ImuChunk
from . import native_build
from .stream_sync import StreamSync

__all__ = ["NativeStreamSync", "StreamSync", "make_stream_sync"]

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = native_build.load("vinsruntime")
            lib.vr_create.restype = ctypes.c_void_p
            lib.vr_create.argtypes = [ctypes.c_int, ctypes.c_long,
                                      ctypes.c_long]
            for name in ("vr_push_accel", "vr_push_gyro"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p] + [ctypes.c_double] * 4
            lib.vr_push_image.restype = ctypes.c_int
            lib.vr_push_image.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                          ctypes.c_long]
            lib.vr_pending.restype = ctypes.c_long
            lib.vr_pending.argtypes = [ctypes.c_void_p]
            f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            lib.vr_poll_chunk.restype = ctypes.c_long
            lib.vr_poll_chunk.argtypes = [ctypes.c_void_p, f32, f32, f32,
                                          f64]
            lib.vr_destroy.restype = None
            lib.vr_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


class NativeStreamSync:
    """Streaming IMU↔image alignment backed by native/runtime.cpp;
    poll() returns (image id, stamp, ImuChunk on `device`) or None.
    device=None means the first CUDA card."""

    def __init__(self, max_per_edge: int, imu_capacity: int = 4096,
                 img_capacity: int = 64, device=None):
        self.device = device_mod.resolve(device)
        self.lib = _load()
        self.N = max_per_edge
        self.handle = self.lib.vr_create(max_per_edge, imu_capacity,
                                         img_capacity)
        if not self.handle:
            raise RuntimeError("vr_create failed")

    def push_accel(self, t: float, xyz) -> bool:
        return self.lib.vr_push_accel(
            self.handle, float(t), float(xyz[0]), float(xyz[1]),
            float(xyz[2])) == 0

    def push_gyro(self, t: float, xyz) -> bool:
        return self.lib.vr_push_gyro(
            self.handle, float(t), float(xyz[0]), float(xyz[1]),
            float(xyz[2])) == 0

    def push_image(self, t: float, image_id: int) -> bool:
        return self.lib.vr_push_image(self.handle, float(t),
                                      int(image_id)) == 0

    def pending(self) -> int:
        """Images whose IMU interval is complete."""
        return int(self.lib.vr_pending(self.handle))

    def poll(self) -> Optional[Tuple[int, float, ImuChunk]]:
        N = self.N
        dt = np.zeros(N, np.float32)
        acc = np.zeros(3 * N, np.float32)
        gyr = np.zeros(3 * N, np.float32)
        t_img = np.zeros(1, np.float64)
        idx = self.lib.vr_poll_chunk(self.handle, dt, acc, gyr, t_img)
        if idx < 0:
            return None
        return int(idx), float(t_img[0]), ImuChunk(*(
            torch.as_tensor(x, device=self.device)
            for x in (dt, acc.reshape(N, 3), gyr.reshape(N, 3))))

    def close(self):
        if getattr(self, "handle", None):
            self.lib.vr_destroy(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def make_stream_sync(max_per_edge: int, **kw):
    """NativeStreamSync if its library builds, else the pure-Python
    StreamSync with the same arguments."""
    try:
        return NativeStreamSync(max_per_edge, **kw)
    except (native_build.BuildError, OSError):
        return StreamSync(max_per_edge, **kw)
