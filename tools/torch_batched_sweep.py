"""The vmapped backend step's wall against the number of streams, on one
card.

    python tools/torch_batched_sweep.py [--batches 1,2,4,8,16,32]

At default_config(), for each B: B streams bootstrapped from
make_synthetic_window (seeds 0..B-1, 300 landmarks, 0.3 px; chip_smoke.py
phase 9's streams) take 1 warm-up and 3 timed steps of
parallel.make_batched_step (the select-variant backend step under
torch.func.vmap), each timed with the host clock between two
torch.cuda.synchronize() calls; prints the card's name and power limit,
then one JSON line per B: the median seconds a step, backend frames/s in
all and per stream, and the peak device memory of the steps.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    import torch
    from vins_tpu_torch import default_config
    from vins_tpu_torch.core.estimator import BackendState, FrameInput
    from vins_tpu_torch.core.preintegration import ImuChunk
    from vins_tpu_torch.io.synthetic import make_synthetic_window
    from vins_tpu_torch.parallel import (make_batched_step, stack_inputs,
                                         stack_states)

    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="1,2,4,8,16,32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_batched_sweep: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = default_config()
    dev = torch.device("cuda", 0)
    F = cfg.window.num_frames
    for B in (int(b) for b in args.batches.split(",")):
        states, steps = [], []
        for s in range(B):
            kw = dict(n_landmarks=300, seed=s, noise_px=0.3, device=dev)
            w = make_synthetic_window(cfg, **kw)
            states.append(BackendState.bootstrap(cfg, w.state, w.feats,
                                                 w.chunks, w.ext, w.gravity))
            frames = []
            for k in range(1, 5):
                wk = make_synthetic_window(cfg, t0=0.1 * k, **kw)
                frames.append(FrameInput(
                    chunk=ImuChunk(*[x[-1] for x in wk.chunks]),
                    ids=wk.feats.track_id, obs=wk.feats.obs[F - 1],
                    obs_valid=wk.feats.mask[F - 1] & wk.feats.valid))
            steps.append(frames)
        step = make_batched_step(cfg, w.ext, w.gravity)
        est = stack_states(states)
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for k in range(4):
            inp = stack_inputs([frames[k] for frames in steps])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est, out = step(est, inp)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        dt = sorted(times[1:])[1]
        print(json.dumps(dict(
            streams=B, step_s=dt, frames_per_s=B / dt,
            frames_per_s_per_stream=1 / dt,
            peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            failures=int(out.failure.sum()),
            finite=bool(torch.all(torch.isfinite(out.pose_p))))), flush=True)


if __name__ == "__main__":
    main()
