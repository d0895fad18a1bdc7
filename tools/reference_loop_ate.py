"""chip_smoke.py's loop-on case on one set of frames for both packages, on
the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/reference_loop_ate.py \
        [jax|port] [N]

The JAX renderer draws the frames of the sequence chip_smoke.slice_phase
streams (default_config(), bench.py's w = 0.7 circle, n_landmarks 300,
seed 7, 30 Hz, 4 IMU samples a frame; N frames, default 768). "jax" runs
vins_tpu's VinsSystem on them, "port" runs vins_tpu_torch's (device
"cpu"): loop closure on, the system bootstrapping itself, then blocks of
48. Prints one JSON line: the init frame, the aligned and raw ATE after
it with and without the drift correction, and the pose-graph runs. On
the same frames the two packages' drift can be compared; the port's
renderer draws other image noise, so its runs on the card cannot.
"""
import json
import sys

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


def main(which: str, n_frames: int) -> None:
    cfg = default_config()
    seq = synthetic.make_synthetic_sequence(
        cfg, n_frames=n_frames, n_landmarks=300, seed=7,
        frame_dt=1.0 / 30.0, traj_kwargs=dict(w=0.7, bob=0.15),
        imu_per_frame=4)
    imgs = np.asarray(synthetic.render_sequence_images(seq, cfg, seed=7))
    ts = np.asarray(seq.timestamps)
    if which == "jax":
        from vins_tpu.pipeline import VinsSystem

        sys_ = VinsSystem(cfg, use_loop=True, ext=seq.ext)
        outs = sys_.process_stream(jnp.asarray(imgs), seq.chunks, block=48,
                                   ts=ts)
    else:
        import torch

        from vins_tpu_torch import default_config as t_default_config
        from vins_tpu_torch.io import synthetic as t_synthetic
        from vins_tpu_torch.pipeline import VinsSystem

        tcfg = t_default_config()
        tseq = t_synthetic.make_synthetic_sequence(
            tcfg, n_frames=n_frames, n_landmarks=300, seed=7,
            frame_dt=1.0 / 30.0, traj_kwargs=dict(w=0.7, bob=0.15),
            imu_per_frame=4, device="cpu")
        sys_ = VinsSystem(tcfg, ext=tseq.ext, device="cpu")
        outs = sys_.process_stream(torch.as_tensor(imgs), tseq.chunks,
                                   block=48, ts=ts)
    res = _result(outs, np.asarray(seq.p), n_frames, sys_.loop.n_optimizes)
    print(json.dumps(dict(package=which, **res)))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "jax",
         int(sys.argv[2]) if len(sys.argv) > 2 else 768)
