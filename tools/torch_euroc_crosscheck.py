"""The EuRoC revisit run of both packages on both packages' trees, on the CPU.

    python tools/torch_euroc_crosscheck.py [--work smoke_out/euroc_crosscheck]
                                           [--threads 3]

Writes the revisit tree of tests/test_euroc_path.py (360 frames at 20 Hz,
seed 9, w = 0.42, bob = 0.2, bob_w = 1.9, euroc_config()) once with the
JAX package's generate_asl_fixture and once with the port's, then runs
examples/run_euroc.py and `python -m vins_tpu_torch.run_euroc` (both with
--stream --global-ba --loop-freq 1) on each tree: four runs, two at a
time, each in its own process so that no process imports both packages.
Prints one JSON line per run: the entry point's result dict plus where
its loop hits were verified (during the stream or in the end-of-stream
drain), how many verified hits were staged as anchors for a later
block, and how many pose-graph runs came before the drain.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ = dict(w=0.42, bob=0.2, bob_w=1.9)
FLAGS = ["--stream", "--global-ba", "--loop-freq", "1"]


def _fixture(package: str, root: str) -> None:
    if package == "jax":
        from vins_tpu.config import euroc_config
        from vins_tpu.io.asl_fixture import generate_asl_fixture
        kw = {}
    else:
        from vins_tpu_torch import euroc_config
        from vins_tpu_torch.io.asl_fixture import generate_asl_fixture
        kw = dict(device="cpu")
    generate_asl_fixture(root, euroc_config(), n_frames=360, cam_hz=20.0,
                         seed=9, traj_kwargs=TRAJ, **kw)


def _run(package: str, root: str, out: str) -> dict:
    if package == "jax":
        from examples import run_euroc
        from vins_tpu.pipeline import VinsSystem
        argv = ["--root", root, "--out", out] + FLAGS
    else:
        from vins_tpu_torch import run_euroc
        from vins_tpu_torch.pipeline import VinsSystem
        argv = ["--root", root, "--out", out, "--device", "cpu"] + FLAGS
    seen = dict(staged=0, hits_before_drain=None,
                pose_graph_runs_before_drain=None)
    stage, drain = VinsSystem._stage_anchor_from_hit, \
        VinsSystem.drain_loop_work

    def staged(self, hit):
        seen["staged"] += 1
        return stage(self, hit)

    def drained(self):
        if seen["hits_before_drain"] is None:
            seen["hits_before_drain"] = self.loop.n_loops
            seen["pose_graph_runs_before_drain"] = self.loop.n_optimizes
        return drain(self)

    VinsSystem._stage_anchor_from_hit = staged
    VinsSystem.drain_loop_work = drained
    result = run_euroc.main(argv)
    return dict(result, **seen)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", default=os.path.join("smoke_out",
                                                   "euroc_crosscheck"))
    ap.add_argument("--threads", type=int, default=3)
    ap.add_argument("--child", nargs=4,
                    metavar=("MODE", "PACKAGE", "ROOT", "OUT"))
    args = ap.parse_args(argv)
    if args.child:
        mode, package, root, out = args.child
        if mode == "fixture":
            _fixture(package, root)
        else:
            print("RESULT " + json.dumps(_run(package, root, out)),
                  flush=True)
        return

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS=str(args.threads),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    work = os.path.abspath(args.work)
    os.makedirs(work, exist_ok=True)

    def start(*child):
        log = open(os.path.join(work, "_".join(child[:2]) + "_"
                                + os.path.basename(child[2]) + ".log"), "w")
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", *child],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=log,
            text=True)

    trees = {p: os.path.join(work, f"tree_{p}") for p in ("jax", "torch")}
    makers = [start("fixture", p, trees[p], "-")
              for p in trees if not os.path.exists(
                  os.path.join(trees[p], "mav0", "state_groundtruth_estimate0",
                               "data.csv"))]
    for m in makers:
        if m.wait() != 0:
            raise SystemExit(f"fixture writer failed: {m.args}")
    runs = [(p, t) for p in ("jax", "torch") for t in ("jax", "torch")]
    for pair in (runs[:2], runs[2:]):
        procs = [(p, t, start("run", p, trees[t],
                              os.path.join(work, f"out_{p}_on_{t}")))
                 for p, t in pair]
        for p, t, proc in procs:
            out, _ = proc.communicate()
            line = next((x[len("RESULT "):] for x in out.splitlines()
                         if x.startswith("RESULT ")), None)
            if proc.returncode != 0 or line is None:
                raise SystemExit(f"{p} on the {t} tree failed "
                                 f"(rc {proc.returncode})")
            print(json.dumps(dict(package=p, tree=t, **json.loads(line))),
                  flush=True)


if __name__ == "__main__":
    main()
