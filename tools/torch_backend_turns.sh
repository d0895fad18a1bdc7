#!/bin/bash
# The main path's backend step in turns on one card.
#
#   bash tools/torch_backend_turns.sh DIR_A DIR_B
#
# DIR_A and DIR_B are checkouts of two commits (for example each unpacked
# with `git archive` into a git-ignored directory of the repo). From
# DIR_A, DIR_B, DIR_B, DIR_A, each in its own process, the script runs
# bench.py's backend sequence at default_config() (make_synthetic_sequence,
# seed 0, 300 landmarks, 0.5 px noise, frames 0.1 s apart; the first F
# frames ingested, triangulated and bootstrapped at ground truth) for 24
# frames through core.estimator.backend_step as the main path calls it
# (the host branch on the keyframe flag), each frame timed with the host
# clock between two torch.cuda.synchronize() calls, and prints one JSON
# line per run: the median and mean seconds a frame, the first frame's,
# and the last pose's distance to the ground truth. The first line is the
# card's name and power limit.
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader || exit 1
for tree in "$1" "$2" "$2" "$1"; do
  (cd "$tree" && PYTHONPATH=. python3 - "$tree" <<'PY'
import json, sys, time
import torch
from vins_tpu_torch import default_config
from vins_tpu_torch.core import feature_manager as fm
from vins_tpu_torch.core.estimator import BackendState, FrameInput, backend_step
from vins_tpu_torch.core.preintegration import ImuChunk
from vins_tpu_torch.core.state import FeatureTable
from vins_tpu_torch.io.synthetic import make_synthetic_sequence

cfg = default_config(); dev = torch.device("cuda", 0); F = cfg.window.num_frames
N = 24
seq = make_synthetic_sequence(cfg, n_frames=F + N, n_landmarks=300, seed=0, noise_px=0.5, frame_dt=0.1, device=dev)
feats = FeatureTable.empty(F, cfg.window.max_landmarks, device=dev)
for f in range(F):
    feats = fm.ingest_frame(feats, f, seq.ids[f], seq.obs[f], seq.obs_valid[f])
win = BackendState.fresh(cfg, dev).window._replace(p=seq.p[:F], q=seq.q[:F], v=seq.v[:F])
win = fm.triangulate(win, feats, seq.ext, cfg)
est = BackendState.bootstrap(cfg, win, feats, ImuChunk(*[x[1:F] for x in seq.chunks]), seq.ext, seq.gravity)
times = []
for k in range(F, F + N):
    inp = FrameInput(chunk=ImuChunk(*[x[k] for x in seq.chunks]), ids=seq.ids[k], obs=seq.obs[k], obs_valid=seq.obs_valid[k])
    torch.cuda.synchronize(); t0 = time.perf_counter()
    est, out = backend_step(est, inp, cfg, seq.ext, seq.gravity)
    torch.cuda.synchronize(); times.append(time.perf_counter() - t0)
err = float(torch.linalg.norm(out.pose_p - seq.p[F + N - 1]))
print(json.dumps(dict(tree=sys.argv[1], median_s=sorted(times)[N // 2], mean_s=sum(times) / N, first_s=times[0], last_err_m=err)), flush=True)
PY
  ) || exit 1
done
