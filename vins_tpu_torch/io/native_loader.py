"""ctypes wrapper for the port's prefetching dataset loader
(vins_tpu_torch/csrc/host/dataloader.cpp; port of
vins_tpu/io/native_loader.py): threaded PNG decode into float32 numpy
frames, delivered in order while the device computes the previous frame.

The library is built by io/native_build at first use (g++, zlib), never
at import; a missing toolchain raises native_build.BuildError. The
source is the port's own copy of native/dataloader.cpp with the in-order
deadlock repaired (a decoded frame is admitted by its index, so the next
frame to deliver always fits).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Iterator, Tuple

import numpy as np

from ..config import VinsConfig
from . import euroc as euroc_mod
from . import native_build

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = native_build.load("vinsloader")
            lib.vl_open.restype = ctypes.c_void_p
            lib.vl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                    ctypes.c_long, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.vl_next.restype = ctypes.c_long
            lib.vl_next.argtypes = [ctypes.c_void_p,
                                    np.ctypeslib.ndpointer(
                                        np.float32, flags="C_CONTIGUOUS")]
            lib.vl_close.restype = None
            lib.vl_close.argtypes = [ctypes.c_void_p]
            lib.vl_decode_png.restype = ctypes.c_int
            lib.vl_decode_png.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")]
            _lib = lib
        return _lib


def decode_png_native(path: str, width: int, height: int) -> np.ndarray:
    """One 8-bit grayscale PNG of the given size as float32 [H, W] in
    [0, 1]; IOError when it is not one."""
    lib = _load()
    out = np.empty((height, width), np.float32)
    if lib.vl_decode_png(path.encode(), width, height, out) != 0:
        raise IOError(f"native PNG decode failed: {path}")
    return out


class PrefetchingImageLoader:
    """Ordered, threaded image prefetcher over a path list: n_workers
    threads decode ahead, at most queue_cap + n_workers frames held. A
    file that does not decode at the given size yields a frame of zeros,
    as in the JAX package."""

    def __init__(self, paths, width: int, height: int, n_workers: int = 2,
                 queue_cap: int = 4):
        self.lib = _load()
        self.paths = [p.encode() for p in paths]
        self._arr = (ctypes.c_char_p * len(self.paths))(*self.paths)
        self.width, self.height = width, height
        self.handle = self.lib.vl_open(self._arr, len(self.paths), width,
                                       height, n_workers, queue_cap)
        self.n = len(self.paths)
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._i >= self.n or not self.handle:
            raise StopIteration
        out = np.empty((self.height, self.width), np.float32)
        if self.lib.vl_next(self.handle, out) < 0:
            raise StopIteration
        self._i += 1
        return out

    def close(self):
        if self.handle:
            self.lib.vl_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeEurocLoader:
    """Aligned (frame, image) pairs of a EuRoC sequence: the IMU chunks
    from euroc.align_measurements on `device` (None: the first CUDA card),
    the images from the native prefetcher as numpy [H, W]."""

    def __init__(self, data: euroc_mod.EurocData, cfg: VinsConfig,
                 start: int = 0, count=None, n_workers: int = 2,
                 device=None):
        self.frames = list(euroc_mod.align_measurements(
            data, cfg, start=start, count=count, device=device))
        self.images = PrefetchingImageLoader(
            [f.image_path for f in self.frames],
            cfg.camera.width, cfg.camera.height, n_workers=n_workers)

    def __iter__(self) -> Iterator[Tuple[euroc_mod.AlignedFrame, np.ndarray]]:
        return zip(self.frames, self.images)

    def close(self):
        self.images.close()
