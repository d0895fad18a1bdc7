"""The port's marginalization on the card, tree against tree: what the
marginalization costs per call, what the loop-off system run reads, and
chip_smoke.py phase 9's gates under a variant of the bootstrap prior's
hold.

    python tools/torch_marg_ab.py --trees DIR_A,DIR_B,DIR_B,DIR_A \
        [--parts time,slice,phase9] [--holds gauge:1e-4,...] [--reps 50]

Each entry of --trees (default: this tree) runs in a child process of its
own, in the order given (parent, change, change, parent compares two
trees on one card), importing that tree's vins_tpu_torch and chip_smoke.py.
Parts:
  time    chip_smoke._stream_sequences' first stream at default_config()
          (its bootstrap, then N_BATCH_STEPS backend_steps of each stream in
          turn until both slides have run):
          every marginalize_old (bootstrap and keyframe) and
          marginalize_second_new call's arguments are captured, and each
          kind is timed again on them: the caller's wall per call
          (synchronized at the end of --reps calls) and the synchronizing
          CUDA calls in one call.
  slice   chip_smoke.slice_phase's loop-off run (N_FRAMES_OFF frames of
          TRAJ_OFF, as chip_smoke.py runs it): block frames/s, end-to-end
          frames/s, aligned ATE, the system's stage seconds (dispatch,
          sync, insert, publish, drain), synchronizing calls per block.
  phase9  chip_smoke._batched_part and _scan_part at default_config(),
          chip_smoke._fail collecting the failures instead of exiting:
          each step's pose error of the vmapped streams against each run
          alone (the first step's gate STREAM_STEP1_TOL), the scan against
          the host branch, and the bootstrap priors' least eigenvalues.
          It runs with the tree's own bootstrap hold, and again in a
          child of its own for each "gauge:W" of --holds (for a tree with
          marginalization.BOOT_HOLD): no hold in the bias and velocity
          directions, and position and yaw of the oldest kept frame held
          at W times the largest diagonal entry of the kept information.
Prints one JSON line per tree and part, with the card's name and power
limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gauge_hold(marg, weight: float) -> None:
    """Patch marg so that the bootstrap prior holds only the four gauge
    directions (position and yaw of the oldest kept frame; the rotation's
    tangent is local, so yaw is R(q)ᵀ e_z there) at weight times the
    largest diagonal entry, in place of BOOT_HOLD in every direction."""
    import torch
    from vins_tpu_torch.utils import lie

    marg.BOOT_HOLD = 0.0
    inner_old, inner_sqrt = marg.marginalize_old, marg._info_to_sqrt
    kept_q = []

    def old(state, prob, cfg, bootstrap=False):
        if bootstrap:
            kept_q.append(state.q[1])
        try:
            return inner_old(state, prob, cfg, bootstrap)
        finally:
            if bootstrap:
                kept_q.pop()

    def sqrt(H, g, eps, method="chol"):
        if kept_q:
            G = H.new_zeros((H.shape[0], 4))
            G[0:3, 0:3] = torch.eye(3, dtype=H.dtype, device=H.device)
            G[3:6, 3] = lie.quat_to_rotmat(kept_q[-1])[2, :]
            d_max = torch.max(torch.abs(torch.diagonal(H)))
            H = H + (weight * d_max) * (G @ G.T)
        return inner_sqrt(H, g, eps, method)

    marg.marginalize_old = old
    marg._info_to_sqrt = sqrt


def _time_part(c, reps: int, dev) -> dict:
    import torch
    from vins_tpu_torch import default_config
    from vins_tpu_torch.core import estimator as est
    from vins_tpu_torch.core import marginalization as marg

    cfg = default_config()
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    calls = {}
    inner = dict(marginalize_old=marg.marginalize_old,
                 marginalize_second_new=marg.marginalize_second_new)
    # The first call of each kind in each stage: "bootstrap" while the
    # streams bootstrap, then the backend steps' own.
    stage = ["bootstrap"]

    def capture(kind):
        def f(*args, **kwargs):
            key = stage[0] if stage[0] == "bootstrap" else kind
            calls.setdefault(key, (kind, args, kwargs))
            return inner[kind](*args, **kwargs)
        return f

    for kind in inner:
        setattr(marg, kind, capture(kind))
    try:
        states, seqs, ext, gravity = c._stream_sequences(cfg, dev)
        stage[0] = "step"
        for st, seq in zip(states, seqs):
            if len(calls) == 3:
                break
            for k in range(c.N_BATCH_STEPS):
                st, _ = est.backend_step(st, est.tree_index(seq, k), cfg,
                                         ext, gravity)
        sync()
    finally:
        for kind, f in inner.items():
            setattr(marg, kind, f)
    out = {}
    for key, (kind, args, kwargs) in sorted(calls.items()):
        fn = lambda: inner[kind](*args, **kwargs)
        for _ in range(5):
            fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        wall = (time.perf_counter() - t0) / reps * 1e3
        with c._SyncCounter(on_card) as counter:
            fn()
        sync()
        out[key] = dict(wall_ms=wall, syncs=counter.count(0))
    return out


def _slice_part(c) -> dict:
    import torch
    from vins_tpu_torch import default_config
    run = c.slice_phase(default_config(), torch.device("cuda", 0), False,
                        c.TRAJ_OFF, c.N_FRAMES_OFF,
                        max_init_at=c.INIT_AT_MAX_OFF)
    return dict(block_frames_per_s=run["block_frames_per_s"],
                system_frames_per_s=run["system_frames_per_s"],
                ate_rmse_m=run["ate_rmse_m"], init_at=run["init_at"],
                wall_s=run["wall_s"], timings=run["timings"],
                syncs=run["syncs"], prior_branches=run["prior_branches"])


def _phase9_part(c, hold: str) -> dict:
    import torch
    from vins_tpu_torch import default_config
    from vins_tpu_torch.core import marginalization as marg

    if hold.startswith("gauge:"):
        _gauge_hold(marg, float(hold.split(":")[1]))
    keeps, inner = [], marg._info_to_sqrt

    def probe(H, g, eps, method="chol"):
        if not torch._C._functorch.is_batchedtensor(H):
            keeps.append(H.detach().double().cpu())
        return inner(H, g, eps, method)

    marg._info_to_sqrt = probe
    fails = []
    c._fail = fails.append
    cfg = default_config()
    dev = torch.device("cuda", 0)
    b = c._batched_part(cfg, dev, torch.cuda.synchronize)
    s = c._scan_part(cfg, dev, torch.cuda.synchronize, True)
    least = [float(torch.linalg.eigvalsh(0.5 * (H + H.T))[0])
             for H in keeps[:c.N_STREAMS]]
    return dict(hold=hold, step1_tol=c.STREAM_STEP1_TOL,
                step_err=b["step_pose_err_m"],
                step1_err=[e[0] for e in b["stream_step_pose_err_m"]],
                scan_host_err=s["host_pose_err_m"], boot_least=least,
                fails=fails)


def child(tree: str, parts: list, hold: str, reps: int, device: str) -> None:
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as c
    from vins_tpu_torch.ops import native
    dev = torch.device(device)
    if dev.type == "cuda":
        native.library()
    for part in parts:
        if part == "time":
            res = _time_part(c, reps, dev)
        elif part == "slice":
            res = _slice_part(c)
        else:
            res = _phase9_part(c, hold)
        card = c._card_line() if dev.type == "cuda" else str(dev)
        print(json.dumps(dict(tree=tree, part=part, result=res, card=card)),
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", default=ROOT)
    ap.add_argument("--parts", default="time,slice")
    ap.add_argument("--holds", default="")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cpu: the time part only, to try the tool")
    ap.add_argument("--child", nargs=2, metavar=("TREE", "HOLD"))
    a = ap.parse_args()
    parts = a.parts.split(",")
    if a.child:
        child(a.child[0], parts, a.child[1], a.reps, a.device)
        return
    rc = 0
    for tree in a.trees.split(","):
        jobs = [(parts, "all")]
        if "phase9" in parts:
            jobs += [(["phase9"], h) for h in a.holds.split(",")
                     if h not in ("", "all")]
        for run, hold in jobs:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--parts",
                 ",".join(run), "--reps", str(a.reps), "--device",
                 a.device, "--child",
                 os.path.abspath(tree), hold])
            rc = rc or r.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
