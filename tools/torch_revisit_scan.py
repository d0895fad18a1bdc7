"""Run the port's interactive path with loop closure over synthetic circles
and print one JSON line a run: where the system initialized, its failure
frames, every verify RANSAC readout, the loop counters and events by
frame, and the aligned ATE with and without the drift correction.

    python tools/torch_revisit_scan.py [--config default|test]
        [--device cuda|cpu] [--threads 2] RUN [RUN ...]

Each RUN is a JSON object: "traj" (the circle's keyword arguments, e.g.
{"r": 1.5, "w": 0.9, "bob": 0.05}), "n" (frames), "seed" (the room and
landmarks), and optionally "gt" (true: bootstrap from the ground truth),
"noise_sigma" (the renderer's pixel noise), "imu_per_frame" (4),
"use_loop" (true) and "give_up" (stop a run not initialized by this
frame, 90). Runs go one after another in this process; start several
processes for parallel runs. --config test is the revisit tests'
192x256 configuration (tests/test_torch_interactive_revisit_card.py's
TCFG), default is default_config(). This is how the revisit scenes of
the tests and of chip_smoke.py's phase 13 were chosen.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)


def _config(name: str):
    if name == "default":
        from vins_tpu_torch import default_config
        return default_config()
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_interactive_revisit_card import TCFG
    return TCFG


def scan(cfg, device, run: dict) -> dict:
    """One run (see the module docstring); returns its record."""
    from vins_tpu_torch import pipeline as t_pipe
    from vins_tpu_torch.core.preintegration import ImuChunk
    from vins_tpu_torch.io import synthetic as t_syn
    from vins_tpu_torch.io.evaluate import ate_rmse

    n, seed = run["n"], run["seed"]
    seq = t_syn.make_synthetic_sequence(
        cfg, n_frames=n, n_landmarks=300, seed=seed, frame_dt=1.0 / 30.0,
        traj_kwargs=run["traj"], imu_per_frame=run.get("imu_per_frame", 4),
        device=device)
    render = ({} if "noise_sigma" not in run
              else dict(noise_sigma=run["noise_sigma"]))
    imgs = t_syn.render_sequence_images(seq, cfg, seed=seed, device=device,
                                        **render)
    sys_ = t_pipe.VinsSystem(
        cfg, ext=seq.ext, device=device, use_loop=run.get("use_loop", True),
        initializer=(t_syn.ground_truth_initializer(seq, cfg)
                     if run.get("gt") else None))
    lc, verify, events, outs = sys_.loop, [], [], []
    if lc is not None:
        finish = lc.finish_detect

        def on_finish(pend, fetched):
            hits = finish(pend, fetched)
            if fetched:
                m = sum(b is not None for b in pend[1])
                n_in, _t, _yaw, good, msr = [np.asarray(x)[:m]
                                             for x in fetched[0][:5]]
                n_world = np.asarray(fetched[0][9])[:m].sum(-1)
                verify.append((len(outs), n_in.astype(int).tolist(),
                               good.astype(bool).tolist(),
                               n_world.astype(int).tolist(),
                               msr.astype(float).tolist()))
            return hits

        lc.finish_detect = on_finish
    ts = seq.timestamps.cpu().numpy()
    prev, t0 = None, time.perf_counter()
    for k in range(n):
        outs.append(sys_.process_frame(
            imgs[k], ImuChunk(*[x[k] for x in seq.chunks]), t=float(ts[k])))
        state = (dict(sys_.loop_stats), lc.n_optimizes if lc else 0)
        if state != prev:
            events.append((k, *state))
        prev = state
        if k == run.get("give_up", 90) and not sys_.initialized:
            break
    init_at = next((k for k, o in enumerate(outs) if o.initialized), None)
    rec = dict(run=run, init_at=init_at, wall_s=time.perf_counter() - t0,
               statuses=[(k, o.status) for k, o in enumerate(outs)
                         if o.status][:16],
               failures=[k for k, o in enumerate(outs)
                         if o.status == "FAILURE"],
               keyframes=sum(o.is_keyframe for o in outs),
               verify=verify, events=events[1:])
    if init_at is not None:
        gt = seq.p.cpu().numpy()[init_at:len(outs)]
        est = np.stack([o.p for o in outs[init_at:]])
        raw = np.stack([o.p_raw for o in outs[init_at:]])
        rec.update(ate_m=ate_rmse(est, gt).rmse,
                   ate_uncorrected_m=ate_rmse(raw, gt).rmse)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=("default", "test"),
                    default="default")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("runs", nargs="+", type=json.loads)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(args.threads)
    cfg = _config(args.config)
    for run in args.runs:
        print(json.dumps(scan(cfg, args.device, run), default=str),
              flush=True)


if __name__ == "__main__":
    main()
