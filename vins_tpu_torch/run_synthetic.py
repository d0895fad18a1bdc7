"""End-to-end demo of the port on the rendered synthetic world, the port's
counterpart of examples/run_synthetic.py:

    python -m vins_tpu_torch.run_synthetic [--frames 120] [--out DIR] \
        [--loop] [--device D]

Renders the textured-cylinder sequence on the device, then runs every
frame through VinsSystem.process_frame: KLT tracking on the rendered
pixels, visual-inertial initialization, the 30 Hz motion-only solve, the
backend every third frame and, with --loop, loop closure. Prints the ATE
after initialization and writes trajectory.png (the trajectory view),
ar_overlay.png (an AR cube on the last frame), run.npz and
estimator.ckpt under --out. --device defaults to the first CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import struct
import sys
import time
import zlib
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from . import default_config
from . import device as device_mod
from .config import VinsConfig
from .core.preintegration import ImuChunk
from .io import evaluate
from .io.replay import Recorder, save_checkpoint
from .io.synthetic import (SyntheticSequence, make_synthetic_sequence,
                           render_sequence_images)
from .pipeline import PipelineOutput, VinsSystem
from .utils import lie
from .viz import TrajectoryRenderer, draw_ar_overlay

SEED = 13


class DemoRun(NamedTuple):
    outs: List[PipelineOutput]
    seq: SyntheticSequence
    imgs: torch.Tensor            # [N, H, W] rendered frames on the device
    system: VinsSystem
    frame_s: List[float]          # host wall of each process_frame call


def run(cfg: VinsConfig, frames: int, use_loop: bool, device) -> DemoRun:
    """Render `frames` frames of the demo's sequence (60 landmarks, seed
    13, 30 Hz, the w = 0.35 circle, 4 IMU samples a frame) on `device`
    and run them through VinsSystem.process_frame."""
    dev = device_mod.resolve(device)
    seq = make_synthetic_sequence(
        cfg, n_frames=frames, n_landmarks=60, seed=SEED,
        frame_dt=1.0 / 30.0, traj_kwargs=dict(w=0.35, bob=0.15),
        imu_per_frame=4, device=dev)
    print(f"rendering {frames} frames on {dev}...", flush=True)
    imgs = render_sequence_images(seq, cfg, seed=SEED, device=dev)
    ts = seq.timestamps.cpu().numpy()

    sys_ = VinsSystem(cfg, use_loop=use_loop, ext=seq.ext, device=dev)
    outs, frame_s = [], []
    for k in range(frames):
        t0 = time.perf_counter()
        out = sys_.process_frame(imgs[k], ImuChunk(*[x[k] for x in
                                                     seq.chunks]),
                                 t=float(ts[k]))
        frame_s.append(time.perf_counter() - t0)
        outs.append(out)
        if k % 30 == 0:
            print(f"  frame {k}: init={out.initialized} "
                  f"tracked={out.n_tracked}", flush=True)
    return DemoRun(outs, seq, imgs, sys_, frame_s)


def init_frame(outs: List[PipelineOutput]) -> Optional[int]:
    return next((i for i, o in enumerate(outs) if o.initialized), None)


def ar_pose(out: PipelineOutput, seq: SyntheticSequence):
    """(R_wc, t_wc, cube center) of the AR overlay on the frame of `out`:
    the camera of the estimated body pose, the cube 3 m ahead of it and
    0.5 m below its optical axis."""
    qic, tic = device_mod.fetch_flat([seq.ext.qic, seq.ext.tic])
    R_wb = lie.np_quat_to_rotmat(out.q)
    R_wc = R_wb @ lie.np_quat_to_rotmat(qic)
    t_wc = out.p + R_wb @ tic
    center = out.p + R_wc @ np.array([0.0, 0.5, 3.0])
    return R_wc, t_wc, center


def write_outputs(out_dir: str, cfg: VinsConfig, seq: SyntheticSequence,
                  imgs, outs: List[PipelineOutput], est,
                  init_at: int) -> dict:
    """Write trajectory.png (the poses from init_at on), ar_overlay.png
    (the cube on the last frame), run.npz (t, p, q, initialized of every
    output) and estimator.ckpt (the backend state `est`) under out_dir.
    Returns their paths by name."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {name: os.path.join(out_dir, name) for name in (
        "trajectory.png", "ar_overlay.png", "run.npz", "estimator.ckpt")}
    est_p = np.stack([o.p for o in outs[init_at:]])
    _save_png(paths["trajectory.png"], TrajectoryRenderer().render(est_p))

    k = len(outs) - 1
    R_wc, t_wc, center = ar_pose(outs[k], seq)
    cam = cfg.camera
    ar = draw_ar_overlay(imgs[k], R_wc, t_wc, cam.fx, cam.fy, cam.cx,
                         cam.cy, center)
    _save_png(paths["ar_overlay.png"], ar)

    rec = Recorder()
    for o in outs:
        rec.add(t=o.t, p=o.p, q=o.q, initialized=o.initialized)
    rec.save(paths["run.npz"])
    save_checkpoint(paths["estimator.ckpt"], est)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--out", default="synthetic_out")
    ap.add_argument("--loop", action="store_true", help="enable loop closure")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)

    cfg = default_config()
    t0 = time.perf_counter()
    r = run(cfg, args.frames, args.loop, args.device)
    wall = time.perf_counter() - t0
    print(f"processed {args.frames} frames in {wall:.1f}s "
          f"({args.frames / wall:.1f} fps incl. rendering)")

    init_at = init_frame(r.outs)
    if init_at is None:
        print("never initialized")
        return 1
    est_p = np.stack([o.p for o in r.outs[init_at:]])
    gt_p = r.seq.p.cpu().numpy()[init_at:args.frames]
    after = r.frame_s[init_at + 1:]
    print(json.dumps({
        "init_frame": init_at,
        "ate_rmse": evaluate.ate_rmse(est_p, gt_p).rmse,
        "traj_len": evaluate.trajectory_length(gt_p),
        "frames_per_s_after_init": (len(after) / sum(after) if after
                                    else None)}))
    write_outputs(args.out, cfg, r.seq, r.imgs, r.outs, r.system.est,
                  init_at)
    print(f"outputs in {args.out}")
    return 0


def _save_png(path, img):
    """Minimal PNG writer (8-bit RGB), no external deps."""
    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, 2)
    H, W, _ = arr.shape
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(H))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


if __name__ == "__main__":
    sys.exit(main())
