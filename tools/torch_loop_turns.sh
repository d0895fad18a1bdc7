#!/bin/bash
# The loop-on system run of chip_smoke.py in turns on one card.
#
#   bash tools/torch_loop_turns.sh DIR_A DIR_B
#
# DIR_A and DIR_B are checkouts of two commits (for example each unpacked
# with `git archive` into a git-ignored directory of the repo). The script
# runs chip_smoke.slice_phase with loop closure on (default_config(),
# bench.py's w = 0.7 circle, 751 frames: the bootstrap, by ground truth in
# trees that predate the port's initialization, then about 720 streamed
# frames) from
# DIR_A, DIR_B, DIR_B, DIR_A, each in its own process, and prints one JSON
# line per run: frames/s end to end and in block mode, the block stages'
# seconds, loop liveness and kernel launches. slice_phase fails the run
# as chip_smoke.py does (no hit, no attach, a kernel off its path). The
# first line is the card's name and power limit.
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader || exit 1
for tree in "$1" "$2" "$2" "$1"; do
  (cd "$tree" && python3 - "$tree" <<'PY'
import json, sys
import torch
import chip_smoke as c
from vins_tpu_torch import default_config
cfg = default_config()
n_boot = cfg.freq * (cfg.window.num_frames - 1) + 1
r = c.slice_phase(cfg, torch.device("cuda", 0), True, c.TRAJ_LOOP,
                  n_boot + c.N_AFTER_BOOT_LOOP)
t = r["timings"]
print(json.dumps(dict(tree=sys.argv[1], fps=r["system_frames_per_s"],
                      block_fps=r["block_frames_per_s"], wall_s=r["wall_s"],
                      dispatch_s=t["dispatch"], insert_s=t["insert"],
                      drain_s=t["drain"], hits=r["loop_stats"]["hits"],
                      good=r["loop_stats"]["good_frames"],
                      launches=r["launches"])), flush=True)
PY
  ) || exit 1
done
