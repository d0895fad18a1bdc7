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
processes for parallel runs.

Every backend frame prints one line to stderr, and the record holds
"gates": the frame, each reading of the backend's failure
detection (core/estimator._failure_detection, thresholds in
VinsConfig.fail_*; GATES names them), the gates that fired and the
detection's own decision. The readings are recomputed in float64 from
the detection's own inputs (gate_readings), so a reading within float32
round-off of its threshold may show a gate the float32 decision did not
take; "fired" beside "failure" shows it. --config test is the revisit tests'
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


# The failure detection's gates (VINS::failureDetection): the reading,
# its threshold's VinsConfig field, and the side on which it fires.
GATES = (("n_tracked", "fail_min_features", "<"),
         ("gyr_bias", "fail_max_gyr_bias", ">"),
         ("acc_bias", "fail_max_acc_bias", ">"),
         ("trans_jump", "fail_max_trans_jump", ">"),
         ("z_jump", "fail_max_z_jump", ">"),
         ("rot_jump_deg", "fail_max_rot_jump_deg", ">"),
         ("finite", None, "=="))


def gate_readings(prev_p, prev_q, cur_p, cur_q, cur_ba, cur_bg, mask_last,
                  valid, cfg) -> dict:
    """_failure_detection's seven readings in float64 from its inputs as
    numpy arrays (window positions [F, 3] and quaternions [F, 4] (w, x, y,
    z) before and after the solve, the solved biases [F, 3], the newest
    frame's observation mask [M] and the slots' valid [M]), and the gates
    they fire ("fired")."""
    f = lambda x: np.asarray(x, np.float64)
    F = f(cur_p).shape[0]
    qa, qb = f(prev_q)[F - 2], f(cur_q)[F - 1]
    w = qa[0] * qb[0] + qa[1:] @ qb[1:]
    v = qa[0] * qb[1:] - qb[0] * qa[1:] - np.cross(qa[1:], qb[1:])
    r = dict(n_tracked=int(np.sum(np.asarray(mask_last) & np.asarray(valid))),
             gyr_bias=float(np.linalg.norm(f(cur_bg)[F - 1])),
             acc_bias=float(np.linalg.norm(f(cur_ba)[F - 1])),
             trans_jump=float(np.linalg.norm(f(cur_p)[F - 1]
                                             - f(prev_p)[F - 2])),
             z_jump=float(abs(f(cur_p)[F - 1, 2] - f(prev_p)[F - 2, 2])),
             rot_jump_deg=float(np.degrees(2 * np.arctan2(
                 np.linalg.norm(v), abs(w)))),
             finite=bool(np.all(np.isfinite(f(cur_p)))))
    r["fired"] = [name for name, field, side in GATES
                  if (side == "<" and r[name] < getattr(cfg, field))
                  or (side == ">" and r[name] > getattr(cfg, field))
                  or (side == "==" and not r[name])]
    return r


def watch_gates(est_module, cfg, frame, rows, to_np=None) -> None:
    """Record in rows, on every call of est_module._failure_detection
    (the port's: eager; to_np None), gate_readings with the frame
    (frame[0]) and the decision ("failure")."""
    own = est_module._failure_detection
    to_np = to_np or (lambda x: x.detach().cpu().numpy())

    def watched(prev, cur, feats, cfg_):
        fail = own(prev, cur, feats, cfg_)
        F = cur.p.shape[0]
        rows.append(dict(frame=frame[0], **gate_readings(
            *[to_np(x) for x in (prev.p, prev.q, cur.p, cur.q, cur.ba,
                                 cur.bg, feats.mask[F - 1], feats.valid)],
            cfg), failure=bool(to_np(fail))))
        return fail

    est_module._failure_detection = watched


def gate_line(row) -> str:
    return (f"frame {row['frame']}: tracked {row['n_tracked']}, gyro bias "
            f"{row['gyr_bias']:.4g}, accel bias {row['acc_bias']:.4g}, "
            f"translation jump {row['trans_jump']:.4g} m, z jump "
            f"{row['z_jump']:.4g} m, rotation jump "
            f"{row['rot_jump_deg']:.4g} deg, finite {row['finite']}; fired "
            f"{row['fired'] or '-'}, failure {row['failure']}")


def scan(cfg, device, run: dict) -> dict:
    """One run (see the module docstring); returns its record."""
    from vins_tpu_torch import pipeline as t_pipe
    from vins_tpu_torch.core.preintegration import ImuChunk
    from vins_tpu_torch.io import synthetic as t_syn
    from vins_tpu_torch.io.evaluate import ate_rmse
    from vins_tpu_torch.core import estimator as t_est

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
    frame, gate_rows, printed = [0], [], 0
    own = t_est._failure_detection
    watch_gates(t_est, cfg, frame, gate_rows)
    ts = seq.timestamps.cpu().numpy()
    prev, t0 = None, time.perf_counter()
    try:
        for k in range(n):
            frame[0] = k
            outs.append(sys_.process_frame(
                imgs[k], ImuChunk(*[x[k] for x in seq.chunks]),
                t=float(ts[k])))
            for row in gate_rows[printed:]:
                print(gate_line(row), file=sys.stderr, flush=True)
            printed = len(gate_rows)
            state = (dict(sys_.loop_stats), lc.n_optimizes if lc else 0)
            if state != prev:
                events.append((k, *state))
            prev = state
            if k == run.get("give_up", 90) and not sys_.initialized:
                break
    finally:
        t_est._failure_detection = own
    init_at = next((k for k, o in enumerate(outs) if o.initialized), None)
    rec = dict(run=run, init_at=init_at, wall_s=time.perf_counter() - t0,
               statuses=[(k, o.status) for k, o in enumerate(outs)
                         if o.status][:16],
               failures=[k for k, o in enumerate(outs)
                         if o.status == "FAILURE"],
               keyframes=sum(o.is_keyframe for o in outs),
               verify=verify, events=events[1:], gates=gate_rows)
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
