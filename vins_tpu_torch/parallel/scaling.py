"""Strong scaling of the landmark-sharded BA (port of
vins_tpu/parallel/scaling.py).

Per LM iteration and shard (L landmarks over B shards, K poses): the
shard's residuals, Jacobians and local Schur contribution scale with
L/B, and the collective is one all_reduce of a [6K, 6K] + [6K] fp32
buffer (plus the cost), which does not shrink with B. The report times
solve_ba_sharded at each block count this world can form and gives the
payload beside it.
"""
from __future__ import annotations

import time
from typing import List

import torch
import torch.distributed as dist


class _Clock:
    """Seconds between start() and stop(): CUDA events on a card, the
    host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.ev = [torch.cuda.Event(enable_timing=True)
                       for _ in range(2)]

    def start(self) -> None:
        if self.cuda:
            self.ev[0].record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if not self.cuda:
            return time.perf_counter() - self.t0
        self.ev[1].record()
        self.ev[1].synchronize()
        return self.ev[0].elapsed_time(self.ev[1]) / 1e3


def scaling_report(blocks=(1, 2, 4, 8), n_poses: int = 16,
                   n_landmarks: int = 512, iters: int = 5, n_rep: int = 3,
                   device_type: str = "cuda") -> List[dict]:
    """One row per block count: the seconds of one solve_ba_sharded
    (make_ba_problem, seed 0), speedup and efficiency against the first
    row, and the all_reduce payload. A collective call: every rank of the
    initialized world runs it. A block count above the world size, or
    one that does not divide it, is skipped; at block b the world forms
    world/b groups that each solve the problem, and the seconds are this
    rank's."""
    from ..io.synthetic import make_ba_problem
    from .dist_ba import mesh_device, solve_ba_sharded
    from .mesh import make_mesh

    world = dist.get_world_size()
    rows = []
    t1 = None
    for b in blocks:
        if b > world or world % b:
            continue
        mesh = make_mesh(block=b, device_type=device_type)
        dev = mesh_device(mesh)
        gt, init, prob = make_ba_problem(
            n_poses=n_poses, n_landmarks=n_landmarks, seed=0,
            pose_noise=0.02, point_noise=0.05, device=dev)
        solve_ba_sharded(init, prob, mesh, iters=iters)     # warm
        clock = _Clock(dev)
        dist.barrier()
        clock.start()
        for _ in range(n_rep):
            st, cost, _ = solve_ba_sharded(init, prob, mesh, iters=iters)
        dt = clock.stop() / n_rep
        if t1 is None:
            t1 = dt
        K = n_poses
        rows.append({
            "block": b,
            "landmarks_per_shard": n_landmarks // b,
            "wall_s_per_solve": dt,
            "speedup": t1 / dt,
            "efficiency": t1 / dt / b,
            "psum_bytes_per_iter": 4 * ((6 * K) ** 2 + 6 * K),
            "final_cost": float(cost),
        })
    return rows


def format_scaling_md(rows: List[dict], header: str = "") -> str:
    lines = [header, "",
             "| block | lm/shard | s/solve | speedup | efficiency | "
             "H_s + g_s B/iter |",
             "|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['block']} | {r['landmarks_per_shard']} | "
            f"{r['wall_s_per_solve']:.5f} | {r['speedup']:.3f} | "
            f"{r['efficiency']:.3f} | {r['psum_bytes_per_iter']} |")
    return "\n".join(lines) + "\n"
