"""Run the full VIO/SLAM system on a EuRoC MAV sequence (ASL layout), the
port's counterpart of examples/run_euroc.py:

    python -m vins_tpu_torch.run_euroc --root /data/euroc/MH_01_easy \
        [--frames 500] [--stream] [--global-ba] [--native-loader] \
        [--out DIR] [--device cpu]

Frames go through VinsSystem.process_frame until the system has
initialized; with --stream the rest go through process_stream (blocks of
48, depth 2) in super-blocks of 480 frames. Evaluates the ATE and RPE
against the sequence's ground truth when it has one, and the keyframe
trajectory before and after the optional end-of-run global BA. Writes
run.npz and keyframe_trajectory.npz under --out and prints the result
dict as one JSON line. --device defaults to the first CUDA card. With
--native-loader the PNGs are decoded ahead by the native prefetcher
(io/native_loader.NativeEurocLoader, built with g++ at first use) instead
of in Python.

Launched with more than one rank (WORLD_SIZE > 1, e.g. `torchrun
--nproc_per_node=N -m vins_tpu_torch.run_euroc ...` on N cards), rank 0
runs the stream on cuda:LOCAL_RANK and every rank joins the global BA,
its landmarks sharded over a mesh of all ranks (NCCL, one card per rank;
gloo with --device cpu); the other ranks wait for it inside the process
group's timeout (--dist-timeout). With one rank nothing changes.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from . import device as device_mod
from . import euroc_config
from .core.preintegration import ImuChunk
from .io import euroc, evaluate
from .io.replay import Recorder
from .pipeline import VinsSystem

SUPER = 48 * 10   # frames staged per process_stream call


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--frames", type=int, default=0, help="0 = all")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--out", default="euroc_out")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--stream", action="store_true",
                    help="block-mode process_stream once initialized")
    ap.add_argument("--dislocal", type=int, default=0,
                    help="override the loop dislocal window (keyframe "
                         "rows)")
    ap.add_argument("--loop-freq", type=int, default=0,
                    help="override the loop insertion cadence (every Nth "
                         "keyframe)")
    ap.add_argument("--global-ba", action="store_true",
                    help="end-of-run global bundle adjustment over the "
                         "keyframe map (LoopCloser.global_ba; sharded over "
                         "the ranks when WORLD_SIZE > 1)")
    ap.add_argument("--native-loader", action="store_true",
                    help="decode the PNGs ahead on native threads "
                         "(io/native_loader)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--dist-timeout", type=float, default=7200.0,
                    help="seconds the ranks other than 0 may wait for "
                         "rank 0's stream (WORLD_SIZE > 1)")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh = None
    if world > 1:
        dev, mesh = _join_world(args, world)
        if dist.get_rank() != 0:
            return _follow(args, mesh)
    else:
        dev = device_mod.resolve(args.device)
    os.makedirs(args.out, exist_ok=True)

    cfg = euroc_config()
    over = {}
    if args.dislocal:
        over["dislocal"] = args.dislocal
    if args.loop_freq:
        over["loop_freq"] = args.loop_freq
    if over:
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, **over))
    data = euroc.load_euroc(args.root)
    n = len(data.cam_ts) - args.start if args.frames == 0 else args.frames
    print(f"{len(data.cam_ts)} frames, {len(data.imu_ts)} IMU samples; "
          f"running {n} from {args.start} on {dev}")
    if args.native_loader:
        from .io.native_loader import NativeEurocLoader
        frames = NativeEurocLoader(data, cfg, start=args.start, count=n,
                                   device=dev)
    else:
        frames = euroc.align_measurements(data, cfg, start=args.start,
                                          count=n, device=dev)
        frames = ((f, euroc.load_gray_png(f.image_path)) for f in frames)

    sys_ = VinsSystem(cfg, use_loop=not args.no_loop, device=dev)
    rec = Recorder()
    gt_pairs = []
    gt_by_t = {}
    t0 = time.perf_counter()
    k = 0

    def publish(out, gt_p):
        nonlocal k
        rec.add(t=out.t, p=out.p, q=out.q, initialized=out.initialized)
        if out.initialized and gt_p is not None:
            # (drift-corrected p, raw VIO p, ground truth): the raw column
            # is the same run without the loop correction.
            gt_pairs.append((out.p, out.p_raw, gt_p))
            gt_by_t[round(float(out.t), 6)] = gt_p
        if k % 100 == 0 or (not out.initialized and out.status):
            print(f"  frame {k}: init={out.initialized} "
                  f"tracked={out.n_tracked} status={out.status}", flush=True)
        k += 1

    buf = []

    def flush_block():
        if not buf:
            return
        fs, ims = zip(*buf)
        buf.clear()
        imgs = torch.as_tensor(np.stack(ims), dtype=torch.float32,
                               device=dev)
        chunks = ImuChunk(*[torch.stack(xs) for xs in zip(
            *[f.chunk for f in fs])])
        outs = sys_.process_stream(imgs, chunks, block=48,
                                   ts=np.asarray([f.t for f in fs]))
        for out, f in zip(outs, fs):
            publish(out, f.gt_p)

    for f, img in frames:
        if args.stream and sys_.initialized:
            buf.append((f, img))
            if len(buf) == SUPER:
                flush_block()
        else:
            out = sys_.process_frame(torch.as_tensor(img, device=dev),
                                     f.chunk, t=f.t)
            publish(out, f.gt_p)
    if args.native_loader:
        frames.close()
    flush_block()
    if sys_.loop is not None:
        sys_.drain_loop_work()
    wall = time.perf_counter() - t0
    print(f"{k} frames in {wall:.1f}s ({k / wall:.2f} frames/s)")

    result = {"frames": k, "wall_s": round(wall, 1)}
    if gt_pairs:
        est_p = np.stack([a for a, _, _ in gt_pairs])
        raw_p = np.stack([b for _, b, _ in gt_pairs])
        gt_p = np.stack([c for _, _, c in gt_pairs])
        result["ate_rmse"] = round(evaluate.ate_rmse(est_p, gt_p).rmse, 4)
        result["ate_rmse_raw"] = round(
            evaluate.ate_rmse(raw_p, gt_p).rmse, 4)
        rpe_r, _ = evaluate.rpe(est_p, gt_p, delta=30)
        result["rpe_30"] = round(rpe_r, 4)
    lc = sys_.loop
    if lc is not None:
        result["loop_hits"] = lc.n_loops
        result["keyframes"] = lc.count
        result["pose_graph_runs"] = lc.n_optimizes
        result["drift_t_norm"] = round(float(np.linalg.norm(lc.t_drift)), 4)

    def kf_ate(p_all):
        est, gt = [], []
        for i in range(lc.count):
            g = gt_by_t.get(round(float(lc._kf_t_np[i]), 6))
            if g is not None:
                est.append(p_all[i])
                gt.append(g)
        if len(est) < 3:
            return None
        return evaluate.ate_rmse(np.stack(est), np.stack(gt)).rmse

    if lc is not None and lc.count >= 2 and gt_by_t:
        # Raw odometry keyframes against the pose-graph-corrected map: the
        # pose graph corrects the past trajectory, so this pair measures
        # the loop closure's effect.
        raw = kf_ate(lc.db.p_origin[:lc.count].cpu().numpy())
        pre = kf_ate(lc.db.p[:lc.count].cpu().numpy())
        if raw is not None:
            result["kf_ate_raw"] = round(raw, 4)
        if pre is not None:
            result["kf_ate_corrected"] = round(pre, 4)

    # With a mesh every rank waits in the BA, so rank 0 joins it whatever
    # the map holds (an empty harvest releases them).
    if args.global_ba and lc is not None and (lc.count >= 2
                                              or mesh is not None):
        cost = lc.global_ba(mesh=mesh)
        result["global_ba_cost"] = (round(cost, 4)
                                    if cost is not None else None)
        result["global_ba_devices"] = world
        if "kf_ate_corrected" in result:
            post = kf_ate(lc.db.p[:lc.count].cpu().numpy())
            result["kf_ate_pre_ba"] = result["kf_ate_corrected"]
            if post is not None:
                result["kf_ate_post_ba"] = round(post, 4)

    print(json.dumps(result))
    rec.save(os.path.join(args.out, "run.npz"))
    if lc is not None and lc.count:
        kt, kp, kq = lc.trajectory()
        np.savez(os.path.join(args.out, "keyframe_trajectory.npz"),
                 t=kt, p=kp, q=kq)
    if mesh is not None:
        dist.destroy_process_group()
    return result


def _join_world(args, world: int):
    """Join the process group torchrun describes (env://) and make the
    (1, world) mesh. Returns (this rank's device, mesh)."""
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    if args.device is None:
        device_mod.resolve(None)          # raises without a card
        dev = torch.device("cuda", local)
    else:
        dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        timeout=datetime.timedelta(seconds=args.dist_timeout))
    from .parallel.mesh import make_mesh
    return dev, make_mesh(block=world, device_type=dev.type)


def _follow(args, mesh):
    """A rank other than 0: its landmark shards of rank 0's global BA."""
    from .parallel.dist_ba import global_ba_follower

    cost = None
    if args.global_ba and not args.no_loop:
        cost = global_ba_follower(mesh)
    result = {"rank": dist.get_rank(), "global_ba_cost": cost}
    dist.destroy_process_group()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
