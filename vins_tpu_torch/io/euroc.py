"""EuRoC MAV dataset reader, ASL layout (port of vins_tpu/io/euroc.py):

    <root>/mav0/cam0/data.csv + data/<t>.png
    <root>/mav0/imu0/data.csv
    <root>/mav0/state_groundtruth_estimate0/data.csv

The index and the alignment are numpy; each aligned frame's IMU chunk is
a port ImuChunk of tensors on the caller's device, shaped like the
synthetic generator's, so the pipeline consumes either. Images load
through imageio when it is installed, else through a pure-Python decoder
of 8-bit grayscale PNGs (every filter type; filter-0 rows are one numpy
copy, the adaptive filters of real EuRoC files a per-pixel Python loop).
"""
from __future__ import annotations

import csv
import os
import struct
import zlib
from typing import Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from .. import device as device_mod
from ..config import VinsConfig
from ..core.preintegration import ImuChunk


class EurocData(NamedTuple):
    """In-memory index of one EuRoC sequence."""

    cam_ts: np.ndarray        # [Nc] seconds
    cam_files: List[str]
    imu_ts: np.ndarray        # [Ni] seconds
    acc: np.ndarray           # [Ni, 3]
    gyr: np.ndarray           # [Ni, 3]
    gt_ts: Optional[np.ndarray]   # [Ng] seconds (None if unavailable)
    gt_p: Optional[np.ndarray]    # [Ng, 3]
    gt_q: Optional[np.ndarray]    # [Ng, 4] wxyz


def _read_csv(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            rows.append([float(x) for x in row])
    return np.asarray(rows, np.float64)


def _read_cam_csv(path: str):
    """cam0/data.csv rows are `timestamp_ns,filename` (a string)."""
    ts, names = [], []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ts.append(int(row[0]))
            names.append(row[1].strip() if len(row) > 1 and row[1].strip()
                         else f"{int(row[0]):d}.png")
    return np.asarray(ts, np.int64), names


def load_euroc(root: str) -> EurocData:
    mav = os.path.join(root, "mav0")
    cam_ns, cam_names = _read_cam_csv(os.path.join(mav, "cam0", "data.csv"))
    cam_ts = cam_ns.astype(np.float64) * 1e-9
    cam_files = [os.path.join(mav, "cam0", "data", n) for n in cam_names]
    imu_csv = _read_csv(os.path.join(mav, "imu0", "data.csv"))
    imu_ts = imu_csv[:, 0] * 1e-9
    gyr = imu_csv[:, 1:4]
    acc = imu_csv[:, 4:7]
    gt_path = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
    gt_ts = gt_p = gt_q = None
    if os.path.exists(gt_path):
        gt = _read_csv(gt_path)
        gt_ts = gt[:, 0] * 1e-9
        gt_p = gt[:, 1:4]
        gt_q = gt[:, 4:8]  # EuRoC stores wxyz
    return EurocData(cam_ts, cam_files, imu_ts, acc, gyr, gt_ts, gt_p, gt_q)


def load_gray_png(path: str) -> np.ndarray:
    """An 8-bit grayscale PNG as float32 [H, W] in [0, 1]."""
    try:
        import imageio.v3 as iio  # type: ignore

        img = iio.imread(path)
        if img.ndim == 3:
            img = img.mean(-1)
        return img.astype(np.float32) / 255.0
    except ImportError:
        pass
    return _decode_png_gray8(path)


def _decode_png_gray8(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    W = H = None
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            W, H, bit_depth, color_type = struct.unpack(">IIBB", chunk[:10])
            assert bit_depth == 8 and color_type == 0, \
                "minimal decoder handles 8-bit grayscale only"
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = W + 1
    out = np.zeros((H, W), np.uint8)
    prev = np.zeros(W, np.uint8)
    for y in range(H):
        row = raw[y * stride:(y + 1) * stride]
        ft, line = row[0], np.frombuffer(row[1:], np.uint8).copy()
        if ft == 1:  # Sub
            for x in range(1, W):
                line[x] = (line[x] + line[x - 1]) & 0xFF
        elif ft == 2:  # Up
            line = (line + prev) & 0xFF
        elif ft == 3:  # Average
            for x in range(W):
                left = line[x - 1] if x else 0
                line[x] = (line[x] + ((int(left) + int(prev[x])) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for x in range(W):
                a = int(line[x - 1]) if x else 0
                b = int(prev[x])
                c = int(prev[x - 1]) if x else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[x] = (line[x] + pred) & 0xFF
        out[y] = line
        prev = line
    return out.astype(np.float32) / 255.0


class AlignedFrame(NamedTuple):
    t: float
    image_path: str
    chunk: ImuChunk            # IMU samples since the previous frame
    gt_p: Optional[np.ndarray]
    gt_q: Optional[np.ndarray]


def align_measurements(data: EurocData, cfg: VinsConfig, start: int = 0,
                       count: Optional[int] = None, device=None
                       ) -> Iterator[AlignedFrame]:
    """Per-camera-frame IMU chunks (getMeasurements,
    ViewController.mm:604-638) on `device` (None: the first CUDA card),
    padded to cfg.window.max_imu_per_edge with dt = 0 rows; row 0 seeds
    with the sample at the previous frame."""
    dev = device_mod.resolve(device)
    N = cfg.window.max_imu_per_edge
    cam_ts = data.cam_ts
    end = len(cam_ts) if count is None else min(start + count, len(cam_ts))
    for k in range(start + 1, end):
        t0, t1 = cam_ts[k - 1], cam_ts[k]
        i0 = np.searchsorted(data.imu_ts, t0, "left")
        i1 = np.searchsorted(data.imu_ts, t1, "right")
        idx = np.arange(max(i0 - 1, 0), i1)
        ts = np.clip(data.imu_ts[idx], t0, t1)
        dts = np.zeros(N, np.float32)
        accs = np.zeros((N, 3), np.float32)
        gyrs = np.zeros((N, 3), np.float32)
        n = min(len(idx), N)
        dts[1:n] = np.diff(ts)[:n - 1]
        accs[:n] = data.acc[idx[:n]]
        gyrs[:n] = data.gyr[idx[:n]]
        gt_p = gt_q = None
        if data.gt_ts is not None:
            j = min(np.searchsorted(data.gt_ts, t1), len(data.gt_ts) - 1)
            gt_p, gt_q = data.gt_p[j], data.gt_q[j]
        chunk = ImuChunk(*(torch.as_tensor(x, device=dev)
                           for x in (dts, accs, gyrs)))
        yield AlignedFrame(t=float(t1), image_path=data.cam_files[k],
                           chunk=chunk, gt_p=gt_p, gt_q=gt_q)
