"""chip_smoke.py's streamed runs on one set of frames for both packages, on
the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/reference_loop_ate.py \
        [jax|port] [N] [--window W --levels L] [--w RATE] [--no-loop]

The JAX renderer draws the frames of the sequence chip_smoke.slice_phase
streams (default_config(), n_landmarks 300, seed 7, 30 Hz, 4 IMU samples
a frame; N frames, default 768) on a circle of RATE rad/s (default 0.7,
bench.py's; chip_smoke's loop-off and domain runs take 0.35). "jax" runs
vins_tpu's VinsSystem on them, "port" runs vins_tpu_torch's (device
"cpu"): loop closure on unless --no-loop, the system bootstrapping
itself, then blocks of 48. --window and --levels change only the
frontend's LK window and pyramid depth (chip_smoke.py's phase 11 runs 15
and 5 over 96 frames of the 0.35 circle, loop off). Prints one JSON line:
the init frame, the aligned and raw ATE after it with and without the
drift correction, and the pose-graph runs. On the same frames the two
packages' drift can be compared; the port's renderer draws other image
noise, so its runs on the card cannot.
"""
import argparse
import dataclasses
import json

import jax.numpy as jnp
import numpy as np

from vins_tpu.config import default_config
from vins_tpu.io import evaluate, synthetic


def _result(outs, p_gt, n_frames, pose_graph_runs) -> dict:
    init_at = next(i for i, o in enumerate(outs) if o.initialized)
    gt = p_gt[init_at:]
    res = dict(frames=n_frames, init_at=init_at,
               statuses=sorted({o.status for o in outs if o.status}),
               pose_graph_runs=pose_graph_runs)
    for key, attr in (("", "p"), ("_uncorrected", "p_raw")):
        est = np.stack([np.asarray(getattr(o, attr))
                        for o in outs[init_at:]])
        res["ate_raw_rmse_m" + key] = float(
            np.sqrt(np.mean(np.sum((est - gt) ** 2, -1))))
        res["ate_rmse_m" + key] = float(evaluate.ate_rmse(est, gt).rmse)
    return res


def _frontend(cfg, window, levels):
    """cfg with only the frontend's LK window and pyramid depth changed
    (chip_smoke._with_window)."""
    if window is None and levels is None:
        return cfg
    fe = cfg.frontend
    return dataclasses.replace(cfg, frontend=dataclasses.replace(
        fe, klt_window=window or fe.klt_window,
        pyramid_levels=levels or fe.pyramid_levels))


def main(which: str, n_frames: int, window=None, levels=None, rate=0.7,
         use_loop=True) -> None:
    cfg = _frontend(default_config(), window, levels)
    traj = dict(w=rate, bob=0.15)
    seq = synthetic.make_synthetic_sequence(
        cfg, n_frames=n_frames, n_landmarks=300, seed=7,
        frame_dt=1.0 / 30.0, traj_kwargs=traj, imu_per_frame=4)
    imgs = np.asarray(synthetic.render_sequence_images(seq, cfg, seed=7))
    ts = np.asarray(seq.timestamps)
    if which == "jax":
        from vins_tpu.pipeline import VinsSystem

        sys_ = VinsSystem(cfg, use_loop=use_loop, ext=seq.ext)
        outs = sys_.process_stream(jnp.asarray(imgs), seq.chunks, block=48,
                                   ts=ts)
    else:
        import torch

        from vins_tpu_torch import default_config as t_default_config
        from vins_tpu_torch.io import synthetic as t_synthetic
        from vins_tpu_torch.pipeline import VinsSystem

        tcfg = _frontend(t_default_config(), window, levels)
        tseq = t_synthetic.make_synthetic_sequence(
            tcfg, n_frames=n_frames, n_landmarks=300, seed=7,
            frame_dt=1.0 / 30.0, traj_kwargs=traj, imu_per_frame=4,
            device="cpu")
        sys_ = VinsSystem(tcfg, ext=tseq.ext, device="cpu",
                          use_loop=use_loop)
        outs = sys_.process_stream(torch.as_tensor(imgs), tseq.chunks,
                                   block=48, ts=ts)
    runs = sys_.loop.n_optimizes if sys_.loop is not None else None
    res = _result(outs, np.asarray(seq.p), n_frames, runs)
    print(json.dumps(dict(package=which, window=cfg.frontend.klt_window,
                          levels=cfg.frontend.pyramid_levels, w=rate,
                          loop=use_loop, **res)))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="?", default="jax",
                    choices=("jax", "port"))
    ap.add_argument("frames", nargs="?", type=int, default=768)
    ap.add_argument("--window", type=int)
    ap.add_argument("--levels", type=int)
    ap.add_argument("--w", type=float, default=0.7)
    ap.add_argument("--no-loop", action="store_true")
    a = ap.parse_args()
    main(a.which, a.frames, a.window, a.levels, a.w, not a.no_loop)
