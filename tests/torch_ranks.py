"""Rank processes for the port's multi-rank tests, and the keyframe map
they share with the single-process tests.

    python tests/torch_ranks.py WORLD RANK INIT_FILE OUT_DIR

joins a gloo world of WORLD CPU processes (init_method file://INIT_FILE,
a 60 s timeout), runs the scale-out layer in it and writes this rank's
results to OUT_DIR/rank<RANK>.pt: the mesh shapes, solve_ba_sharded at
block = WORLD (with and without a position prior), the landmark-sharded
LoopCloser.global_ba on fake_keyframe_db's map (rank 0 owns the DB and
names the iteration count, the others follow), scaling_report at the
blocks the world can form, and the batched backend step with the streams
split over the `batch` axis.
Imports torch, numpy and vins_tpu_torch only: no jax, no vins_tpu.
"""
from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch

# The batched step's streams: two synthetic worlds, tiled to B streams.
N_STREAMS = 8
STREAM_SEEDS = (0, 1)


def tiny_config():
    """tests/test_parallel.py's tiny_config() in the port's config."""
    from vins_tpu_torch import default_config
    cfg = default_config()
    return cfg.replace(
        window=cfg.window.__class__(window_size=4, max_imu_per_edge=8,
                                    max_landmarks=32),
        frontend=cfg.frontend.__class__(max_features=32,
                                        target_features=16))


def stream_problems(cfg, device="cpu"):
    """(states, inputs, ext, gravity): N_STREAMS bootstrapped backend
    states and their next frame, from make_synthetic_window with the
    STREAM_SEEDS tiled (tests/test_parallel.py's batched-step setup)."""
    from vins_tpu_torch.core.estimator import BackendState, FrameInput
    from vins_tpu_torch.io import synthetic

    F = cfg.window.num_frames
    wins = [synthetic.make_synthetic_window(cfg, n_landmarks=24, seed=s,
                                            noise_px=0.3, device=device)
            for s in STREAM_SEEDS]
    states = [BackendState.bootstrap(cfg, w.state, w.feats, w.chunks,
                                     w.ext, w.gravity) for w in wins]
    inputs = [FrameInput(chunk=type(w.chunks)(*[x[-1] for x in w.chunks]),
                         ids=w.feats.track_id, obs=w.feats.obs[F - 1],
                         obs_valid=w.feats.mask[F - 1] & w.feats.valid)
              for w in wins]
    tile = lambda xs: [xs[b % len(xs)] for b in range(N_STREAMS)]
    return tile(states), tile(inputs), wins[0].ext, wins[0].gravity


def fake_keyframe_db(n_kf=12, n_lms=80, seed=3, pose_noise=0.03,
                     point_noise=0.08):
    """The port's copy of tests/test_parallel.py's _fake_keyframe_db: a
    LoopCloser (on the CPU) whose DB holds a consistent synthetic map
    written directly (no image insertion): a circle of body poses
    observing annulus landmarks, identity camera-IMU extrinsics, stored
    world points and poses perturbed like accumulated VIO drift.
    Returns (LoopCloser, ground-truth positions [n_kf, 3])."""
    from vins_tpu_torch.config import VinsConfig
    from vins_tpu_torch.io.synthetic import _traj
    from vins_tpu_torch.loop.keyframe_db import LoopCloser
    from vins_tpu_torch.utils import lie

    rng = np.random.default_rng(seed)
    lc = LoopCloser(VinsConfig(), seed, device="cpu")
    t = np.linspace(0.0, 2.2, n_kf)
    p_f, _, _, yaw_f, _ = _traj(t)
    R_cam = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    R_wc = lie.np_quat_to_rotmat(lie.np_yaw_quat(yaw_f)) @ R_cam
    q_wc = lie.np_rotmat_to_quat(R_wc)

    ang = rng.uniform(0, 2 * np.pi, n_lms)
    rad = rng.uniform(5.0, 9.0, n_lms)
    h = rng.uniform(-1.5, 1.5, n_lms)
    lms = np.stack([rad * np.cos(ang), rad * np.sin(ang), h], -1)

    Nf, db = lc.Nf, lc.db
    T = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt)
    for k in range(n_kf):
        pc = (lms - p_f[k]) @ R_wc[k]
        z = pc[:, 2]
        ok = ((z > 0.5) & (np.abs(pc[:, 0] / np.maximum(z, 1e-6)) < 0.8)
              & (np.abs(pc[:, 1] / np.maximum(z, 1e-6)) < 0.8))
        xy = (pc[:, :2] / np.maximum(z[:, None], 1e-6)).astype(np.float32)
        rows = np.flatnonzero(ok)[:Nf]
        n = len(rows)
        ptsw = lms[rows] + rng.normal(size=(n, 3)) * point_noise
        p_noisy = p_f[k] + rng.normal(size=3) * pose_noise * (k >= 2)
        db.p[k] = db.p_origin[k] = T(p_noisy)
        db.q[k] = db.q_origin[k] = T(q_wc[k])
        db.kp_norm[k, :n] = T(xy[rows])
        db.pts_w[k, :n] = T(ptsw)
        db.kp_ok[k, :n] = True
        db.pts_ok[k, :n] = True
        db.tid[k, :n] = T(rows, torch.int32)
    lc.count = n_kf
    return lc, p_f


def run_rank(world: int, rank: int) -> dict:
    """Everything a rank of the test world computes (the process group is
    initialized)."""
    from vins_tpu_torch.io import synthetic
    from vins_tpu_torch.parallel import (make_batched_step, make_mesh,
                                         scaling_report, solve_ba_sharded,
                                         stack_inputs, stack_states)
    from vins_tpu_torch.parallel.dist_ba import global_ba_follower

    out = {"mesh": {}}
    for kw in (dict(block=world), dict(batch=world), dict(batch=2, block=2)):
        if kw.get("batch", 1) * kw.get("block", 1) == world:
            m = make_mesh(device_type="cpu", **kw)
            out["mesh"][str(sorted(kw.items()))] = (
                tuple(m.mesh.shape), tuple(m.mesh_dim_names))

    mesh = make_mesh(block=world, device_type="cpu")
    gt, init, prob = synthetic.make_ba_problem(
        n_poses=8, n_landmarks=64, seed=1, pose_noise=0.05,
        point_noise=0.2, device="cpu")
    prob_pr = prob._replace(prior_p=init.p,
                            prior_w=torch.tensor(0.1, dtype=torch.float32))
    for tag, pr in (("ba", prob), ("ba_prior", prob_pr)):
        st, cost, hist = solve_ba_sharded(init, pr, mesh, iters=8)
        out[tag] = dict(p=st.p, q=st.q, pts=st.pts, cost=cost, hist=hist)

    lc, _ = fake_keyframe_db(pose_noise=0.05, point_noise=0.1)
    if rank == 0:
        out["global_ba_cost"] = lc.global_ba(mesh=mesh, iters=8)
        out["global_ba_p"] = lc.db.p[:12].clone()
    else:
        out["global_ba_cost"] = global_ba_follower(mesh)
    # Again at an iteration count that only rank 0 names: the followers
    # take it from the broadcast.
    lc, _ = fake_keyframe_db(pose_noise=0.05, point_noise=0.1)
    out["global_ba_cost_3"] = (lc.global_ba(mesh=mesh, iters=3) if rank == 0
                               else global_ba_follower(mesh))

    out["scaling"] = scaling_report(blocks=(1, 2, 4), n_poses=8,
                                    n_landmarks=64, iters=3, n_rep=1,
                                    device_type="cpu")

    cfg = tiny_config()
    states, inputs, ext, gravity = stream_problems(cfg)
    step = make_batched_step(cfg, ext, gravity,
                             mesh=make_mesh(batch=world, device_type="cpu"))
    _, o = step(stack_states(states), stack_inputs(inputs))
    out["batched"] = dict(pose_p=o.pose_p, is_keyframe=o.is_keyframe,
                          failure=o.failure)
    return out


def main(argv) -> None:
    import torch.distributed as dist

    world, rank = int(argv[0]), int(argv[1])
    init_file, out_dir = argv[2], argv[3]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=60))
    try:
        out = run_rank(world, rank)
    finally:
        dist.destroy_process_group()
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "vins_tpu"))
    out["imported"] = bad
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1:])
