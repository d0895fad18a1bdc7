"""The reference (vins_tpu) and the port in lockstep through process_frame
over one of tools/torch_revisit_scan.py's scenes, on the CPU, printing
every backend frame's failure-detection readings on both sides
(torch_revisit_scan.gate_readings) and the first frame where a decision
differs, at default_config() in both packages.

    JAX_PLATFORMS=cpu python tools/torch_revisit_reference.py
        [--deadline SECONDS] RUN

RUN is a scan's JSON object ("traj", "n", "seed", "noise_sigma",
"imu_per_frame"), run with loop closure off in both systems (the
failure detection fires on the tests' circle with it on or off) from a
ground-truth bootstrap (the visual-inertial initialization does not
bootstrap these circles). As tests/test_torch_interactive_revisit.py
does: the port renders the frames and both packages take them; the
reference bootstraps from the truth through a patched initializer, the
port through io.synthetic.ground_truth_initializer, and the reference's
state is carried into the port at the init frame (test_torch_interactive.
carry_state); the reference goes on from the port's priors
(test_torch_stream.carry_priors: its own can be NaN); the tracker's
RANSAC noise is replayed from the JAX key chains. There is no later
carry: the two float32 systems drift apart, and the readout says where
their decisions part.

Each backend frame prints one line per side to stderr; the last line of
stdout is one JSON object: the frames run, each side's failure frames,
the first frame whose decisions differ (init, keyframe, status, loop
hit) with both sides' gate readings there, each side's first failure's
readings, the largest position difference before the first differing
decision (the run goes on past it), the wall seconds and the process's
peak resident memory. --deadline stops the run early (reported as
"stopped_at"). The port runs on THREADS CPU threads, and the process
ends itself if its resident memory passes MAX_RSS_GIB.
"""
import argparse
import json
import os
import resource
import sys
import threading
import time

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "tools"))
THREADS = 2
MAX_RSS_GIB = 12.0


def _rss_guard(limit_gib: float) -> None:
    """End the process once its resident memory passes limit_gib."""
    def watch():
        while True:
            with open("/proc/self/status") as f:
                kb = next(int(ln.split()[1]) for ln in f
                          if ln.startswith("VmRSS:"))
            if kb > limit_gib * 2 ** 20:
                print(json.dumps({"ended": "rss", "rss_gib": kb / 2 ** 20}),
                      flush=True)
                os._exit(3)
            time.sleep(2.0)
    threading.Thread(target=watch, daemon=True).start()


def run(scene: dict, deadline: float = None) -> dict:
    import jax
    import jax.numpy as jnp
    import pytest
    import torch

    import test_torch_interactive as ti
    from test_torch_stream import carry_priors, jax_ransac_noise
    from torch_revisit_scan import gate_line, watch_gates
    from vins_tpu import pipeline as j_pipe
    from vins_tpu.core import estimator as j_est
    from vins_tpu.core import feature_manager as j_fm
    from vins_tpu.core.initialization import InitResult, InitStatus
    from vins_tpu.core.state import WindowState as JWindow
    from vins_tpu.config import default_config as j_default
    from vins_tpu.io.synthetic import make_synthetic_sequence
    from vins_tpu_torch import default_config
    from vins_tpu_torch import pipeline as t_pipe
    from vins_tpu_torch.core import estimator as t_est
    from vins_tpu_torch.core.preintegration import ImuChunk
    from vins_tpu_torch.io import synthetic as t_syn

    torch.set_num_threads(THREADS)
    cfg, tcfg = j_default(), default_config()
    n = scene["n"]
    kw = dict(n_frames=n, n_landmarks=300,
              seed=scene["seed"], frame_dt=1.0 / 30.0,
              traj_kwargs=scene["traj"],
              imu_per_frame=scene.get("imu_per_frame", 4))
    seq = make_synthetic_sequence(cfg, **kw)
    tseq = t_syn.make_synthetic_sequence(tcfg, device="cpu", **kw)
    render = ({} if "noise_sigma" not in scene
              else dict(noise_sigma=scene["noise_sigma"]))
    imgs = t_syn.render_sequence_images(tseq, tcfg, seed=scene["seed"],
                                        device="cpu", **render).numpy()
    F, M = cfg.window.num_frames, cfg.window.max_landmarks
    noise = jax_ransac_noise(0, n, cfg.frontend.f_ransac_hyps,
                             cfg.frontend.max_features)

    frame, gates_j, gates_t = [0], [], []
    mp = pytest.MonkeyPatch()
    own_j = j_est._failure_detection

    def host_gates(*xs):
        *inputs, fail = xs
        from torch_revisit_scan import gate_readings
        gates_j.append(dict(frame=frame[0], **gate_readings(*inputs, cfg),
                            failure=bool(fail)))

    def watched_j(prev, cur, feats, cfg_):
        fail = own_j(prev, cur, feats, cfg_)
        Fc = cur.p.shape[0]
        jax.debug.callback(host_gates, prev.p, prev.q, cur.p, cur.q, cur.ba,
                           cur.bg, feats.mask[Fc - 1], feats.valid, fail)
        return fail

    mp.setattr(j_est, "_failure_detection", watched_j)
    own_t = t_est._failure_detection
    watch_gates(t_est, tcfg, frame, gates_t)

    sys_j = j_pipe.VinsSystem(cfg, use_loop=False, ext=seq.ext)
    sys_t = t_pipe.VinsSystem(
        tcfg, ext=tseq.ext, device="cpu", use_loop=False,
        initializer=t_syn.ground_truth_initializer(tseq, tcfg))

    def gt_initialize(feats, chunks, ext, cfg_):
        cur = sys_j.frame_idx - 1
        idx = np.array([cur - cfg.freq * (F - 1 - f) for f in range(F)])
        win = JWindow(p=seq.p[idx], q=seq.q[idx], v=seq.v[idx],
                      ba=jnp.zeros((F, 3)), bg=jnp.zeros((F, 3)),
                      inv_depth=jnp.zeros(M))
        return InitResult(j_fm.triangulate(win, feats, ext, cfg_),
                          InitStatus.SUCCESS)

    mp.setattr(j_pipe.init_mod, "initialize", gt_initialize)
    carry_priors(mp, j_pipe, tcfg)
    sys_j._refine_init = lambda w, fe, ch: (w, 0.0)
    decide = lambda o: (bool(o.initialized), bool(o.is_keyframe), o.status,
                        o.loop_hit)
    outs_j, outs_t, first_diff, stopped_at, dp = [], [], None, None, 0.0
    printed = [0, 0]
    t0 = time.perf_counter()
    try:
        for k in range(n):
            frame[0] = k
            t = float(seq.timestamps[k])
            outs_j.append(sys_j.process_frame(
                jnp.asarray(imgs[k]), jax.tree.map(lambda x: x[k],
                                                   seq.chunks), t=t))
            outs_t.append(sys_t.process_frame(
                torch.as_tensor(imgs[k]),
                ImuChunk(*[x[k] for x in tseq.chunks]), t=t,
                gumbel=torch.as_tensor(noise[k])))
            jax.effects_barrier()
            if (len(outs_j) > 1 and outs_j[-1].initialized
                    and not outs_j[-2].initialized):
                ti.carry_state(sys_j, sys_t)
            for side, rows, i in (("reference", gates_j, 0),
                                  ("port", gates_t, 1)):
                for row in rows[printed[i]:]:
                    print(f"{side} {gate_line(row)}", file=sys.stderr,
                          flush=True)
                printed[i] = len(rows)
            if first_diff is None and decide(outs_j[-1]) != decide(
                    outs_t[-1]):
                first_diff = k
            if first_diff is None and outs_j[-1].initialized:
                dp = max(dp, float(np.abs(np.asarray(outs_j[-1].p)
                                          - np.asarray(outs_t[-1].p)).max()))
            if deadline and time.perf_counter() - t0 > deadline:
                stopped_at = k
                break
    finally:
        mp.undo()
        t_est._failure_detection = own_t

    def at(rows, k):
        return [r for r in rows if r["frame"] == k]

    fails_j = [k for k, o in enumerate(outs_j) if o.status == "FAILURE"]
    fails_t = [k for k, o in enumerate(outs_t) if o.status == "FAILURE"]
    rec = dict(scene=scene, frames_run=len(outs_j), stopped_at=stopped_at,
               init_at=next((k for k, o in enumerate(outs_j)
                             if o.initialized), None),
               failures_reference=fails_j, failures_port=fails_t,
               first_decision_differs=first_diff,
               decisions_there=(None if first_diff is None else dict(
                   reference=decide(outs_j[first_diff]),
                   port=decide(outs_t[first_diff]))),
               gates_there=(None if first_diff is None else dict(
                   reference=at(gates_j, first_diff),
                   port=at(gates_t, first_diff))),
               first_failure_gates=dict(
                   reference=at(gates_j, fails_j[0]) if fails_j else None,
                   port=at(gates_t, fails_t[0]) if fails_t else None),
               largest_position_difference_m=dp,
               wall_s=time.perf_counter() - t0,
               peak_rss_gib=resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss / 2 ** 20)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--deadline", type=float, default=None,
                    help="stop after this many seconds of stepping")
    ap.add_argument("scene", type=json.loads)
    args = ap.parse_args(argv)
    _rss_guard(MAX_RSS_GIB)
    print(json.dumps(run(args.scene, args.deadline), default=str),
          flush=True)


if __name__ == "__main__":
    main()
