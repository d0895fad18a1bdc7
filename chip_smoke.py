"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
  1. device  — requires torch.cuda.is_available(); prints the card's name
               and power limit as nvidia-smi reports them;
  2. build   — compiles vins_tpu_torch/csrc/*.cu with nvcc (sm_90a);
  3. kernels — K1 (pyramidal LK) and K2 (patch NCC) against their plain
               PyTorch versions on the card, at the main path's shapes
               (M = 128 slots, 640x480 frames, 3 levels, win 21, 10
               iterations, eps 0.01), with kernel and plain times;
  4. slice   — the streaming main path at default_config() with loop
               closure off: VinsSystem.process_stream over 192 rendered
               frames (bootstrap from ground truth, then blocks of 48),
               checked for finite poses, aligned ATE under 0.15 m and
               kernel launches on every tracked frame; prints frames/s
               and host syncs per block.
Then one JSON line with the kernels, and the last line
{"ok": true, "device": {...}}. Extra detail goes to
smoke_out/chip_smoke.json. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

N_FRAMES = 192          # 31 bootstrap frames, then 3 blocks of 48 and 17
BLOCK = 48
# The trajectory of tests/test_stream_parity.py (w = 0.35 rad/s), on which
# its 0.15 m bound on the aligned ATE was set. On bench.py's faster circle
# (w = 0.7) the reference's own estimate drifts past that bound after the
# first block, and the port tracks the reference there (PERF.md).
TRAJ = dict(w=0.35, bob=0.15)
SEED = 7
ATE_MAX = 0.15          # tests/test_stream_parity.py:242, after alignment
FLOW_TOL = 1e-3         # px
NCC_TOL = 1e-4
OK_AGREE = 0.99


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        _fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def frame_pair(cfg, device):
    """Two consecutive rendered frames of the slice's trajectory, prepared
    as the main path prepares them (CLAHE, pyramid, Scharr gradients),
    and 128 slots: Shi–Tomasi corners of the first frame, a third of them
    dead, plus border points."""
    import torch
    from vins_tpu_torch.io import synthetic
    from vins_tpu_torch.ops import corners
    from vins_tpu_torch.stream import precompute_block

    seq = synthetic.make_synthetic_sequence(
        cfg, n_frames=2, n_landmarks=50, seed=SEED, frame_dt=1.0 / 30.0,
        traj_kwargs=TRAJ, imu_per_frame=4, device=device)
    imgs = synthetic.render_sequence_images(seq, cfg, seed=SEED,
                                            device=device)
    pyrs, grads = precompute_block(imgs, cfg)
    M = cfg.frontend.max_features
    resp = corners.shi_tomasi_response(pyrs[0][0])
    pick = corners.select_corners_grid(
        resp, torch.zeros((resp.shape[0] // 8, resp.shape[1] // 8),
                          dtype=torch.bool, device=device), M, 8)
    pts = pick.pts.clone()
    H, W = resp.shape
    pts[:4] = torch.tensor([[0.0, 0.0], [W - 1.0, H - 1.0], [2.5, H - 3.0],
                            [W - 4.0, 1.5]], device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    valid = (torch.rand(M, generator=gen, device=device) > 0.33) & pick.valid
    valid[:4] = True
    level = lambda k: [p[k].contiguous() for p in pyrs]
    lgrad = lambda k: [(g[0][k].contiguous(), g[1][k].contiguous())
                       for g in grads]
    return level(0), lgrad(0), level(1), lgrad(1), pts.contiguous(), valid


def kernel_phase(cfg, device) -> list:
    import torch
    from vins_tpu_torch.ops import klt_cuda

    fe = cfg.frontend
    win, iters, eps = fe.klt_window, fe.klt_iters, fe.klt_eps
    pyr0, g0, pyr1, g1, pts, valid = frame_pair(cfg, device)

    # K1's forward pass, then the backward pass seeded with the negated
    # forward flow, as track_pyramid_fb runs them.
    p_k, ok_k, e_k = klt_cuda.track_pyramid(pyr0, g0, pyr1, pts, valid,
                                            win, iters, eps)
    p_p, ok_p, e_p = klt_cuda.track_pyramid_plain(pyr0, g0, pyr1, pts,
                                                  valid, win, iters, eps)
    bwd = (pyr1, g1, pyr0, p_k, ok_k, win, iters, eps, pts - p_k)
    b_k = klt_cuda.track_pyramid(*bwd)
    b_p = klt_cuda.track_pyramid_plain(*bwd)
    torch.cuda.synchronize()
    agree = torch.cat([ok_k == ok_p, b_k[1] == b_p[1]])
    flow_err = err_err = 0.0
    for (pk, okk, ek), (pp, okp, ep) in (((p_k, ok_k, e_k), (p_p, ok_p, e_p)),
                                         (b_k, b_p)):
        both = okk & okp
        if both.any():
            flow_err = max(flow_err, float((pk - pp)[both].abs().max()))
            err_err = max(err_err, float((ek - ep)[both].abs().max()))
    agree_frac = float(agree.float().mean())
    if agree_frac < 1.0:
        print(f"K1: ok differs on slots "
              f"{torch.nonzero(~agree).flatten().tolist()}")
    if flow_err > FLOW_TOL:
        _fail(f"K1 flow differs from its plain version by {flow_err} px")
    if agree_frac < OK_AGREE:
        _fail(f"K1 ok agrees on only {agree_frac:.3f} of slots")
    ms_k1 = _time_ms(lambda: klt_cuda.track_pyramid(
        pyr0, g0, pyr1, pts, valid, win, iters, eps))
    ms_p1 = _time_ms(lambda: klt_cuda.track_pyramid_plain(
        pyr0, g0, pyr1, pts, valid, win, iters, eps), reps=5)

    # K2 on the forward result, as track_pyramid_fb calls it.
    n_k = klt_cuda.patch_ncc(pyr0[0], pyr1[0], pts, p_k, win)
    n_p = klt_cuda.patch_ncc_plain(pyr0[0], pyr1[0], pts, p_k, win)
    torch.cuda.synchronize()
    ncc_err = float((n_k - n_p).abs().max())
    if not np.isfinite(ncc_err) or ncc_err > NCC_TOL:
        _fail(f"K2 differs from its plain version by {ncc_err}")
    ms_k2 = _time_ms(lambda: klt_cuda.patch_ncc(pyr0[0], pyr1[0], pts, p_k,
                                                win))
    ms_p2 = _time_ms(lambda: klt_cuda.patch_ncc_plain(pyr0[0], pyr1[0], pts,
                                                      p_k, win))
    print(f"K1 klt_pyramid: flow err {flow_err:.3g} px, err err "
          f"{err_err:.3g}, ok agree {agree_frac:.4f} "
          f"({int(ok_k.sum())} tracked of {int(valid.sum())} live); "
          f"{ms_k1:.4f} ms vs plain {ms_p1:.4f} ms")
    print(f"K2 patch_ncc: err {ncc_err:.3g}; {ms_k2:.4f} ms vs plain "
          f"{ms_p2:.4f} ms")
    return [
        {"name": "klt_pyramid", "route": "cuda",
         "source": "vins_tpu_torch/csrc/klt.cu",
         "replaces": "vins_tpu/ops/klt_pallas.py:191",
         "launches": 0, "max_abs_err": flow_err, "ms": ms_k1,
         "plain_ms": ms_p1},
        {"name": "patch_ncc", "route": "cuda",
         "source": "vins_tpu_torch/csrc/klt.cu",
         "replaces": "vins_tpu/ops/klt_pallas.py:368",
         "launches": 0, "max_abs_err": ncc_err, "ms": ms_k2,
         "plain_ms": ms_p2},
    ]


def slice_phase(cfg, device, n_frames: int = N_FRAMES,
                block: int = BLOCK) -> dict:
    """Drive VinsSystem.process_stream over a rendered sequence; returns
    the measurements. Runs on any device (the CPU takes the kernels'
    plain versions)."""
    import torch
    from vins_tpu_torch.io import synthetic
    from vins_tpu_torch.io.evaluate import ate_rmse
    from vins_tpu_torch.ops import klt_cuda
    from vins_tpu_torch.pipeline import VinsSystem

    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    seq = synthetic.make_synthetic_sequence(
        cfg, n_frames=n_frames, n_landmarks=300, seed=SEED,
        frame_dt=1.0 / 30.0, traj_kwargs=TRAJ, imu_per_frame=4,
        device=device)
    t0 = time.perf_counter()
    imgs = synthetic.render_sequence_images(seq, cfg, seed=SEED,
                                            device=device)
    sync()
    render_s = time.perf_counter() - t0
    ts = seq.timestamps.cpu().numpy()

    def system():
        return VinsSystem(cfg, ext=seq.ext, device=device,
                          initializer=synthetic.ground_truth_initializer(
                              seq, cfg))

    sys_ = system()
    klt_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    outs = sys_.process_stream(imgs, seq.chunks, block=block, ts=ts)
    sync()
    wall = time.perf_counter() - t0
    launches = {"klt_pyramid": klt_cuda.track_pyramid.launches,
                "patch_ncc": klt_cuda.patch_ncc.launches}

    if len(outs) != n_frames:
        _fail(f"{len(outs)} outputs for {n_frames} frames")
    init_at = next((i for i, o in enumerate(outs) if o.initialized), None)
    if init_at is None:
        _fail("the system never initialized")
    post = outs[init_at:]
    if not all(o.initialized for o in post):
        _fail("an output after bootstrap is not initialized")
    est = np.stack([o.p for o in post])
    quats = np.stack([o.q for o in post])
    if not (np.all(np.isfinite(est)) and np.all(np.isfinite(quats))):
        _fail("non-finite pose after bootstrap")
    gt = seq.p.cpu().numpy()[init_at:]
    ate = ate_rmse(est, gt).rmse
    ate_raw = float(np.sqrt(np.mean(np.sum((est - gt) ** 2, -1))))
    if ate >= ATE_MAX:
        _fail(f"aligned ATE RMSE {ate:.4f} m >= {ATE_MAX} m")
    tracked = n_frames - 1          # frame 0 only detects
    # Only CUDA launches count: on the CPU (a rehearsal at a tiny size)
    # every call takes the plain version.
    if torch.device(device).type == "cuda":
        if launches["klt_pyramid"] < 2 * tracked:
            _fail(f"K1 launched {launches['klt_pyramid']} times for "
                  f"{tracked} tracked frames")
        if launches["patch_ncc"] < tracked:
            _fail(f"K2 launched {launches['patch_ncc']} times for "
                  f"{tracked} tracked frames")
    n_stream = n_frames - init_at - 1
    block_s = (sys_.timings["dispatch"] + sys_.timings["sync"]
               + sys_.timings["publish"])
    return dict(
        frames=n_frames, init_at=init_at, ate_rmse_m=ate,
        ate_raw_rmse_m=ate_raw,
        wall_s=wall, render_s=render_s,
        system_frames_per_s=n_frames / wall,
        block_frames=n_stream, block_s=block_s,
        block_frames_per_s=n_stream / block_s if block_s > 0 else 0.0,
        blocks=sys_.timings["blocks"],
        keyframe_syncs_per_block=((sys_.timings["host_syncs"]
                                   - sys_.timings["blocks"])
                                  / max(sys_.timings["blocks"], 1)),
        launches=launches, system=system, seq=seq, imgs=imgs, ts=ts)


def count_block_syncs(run: dict, block: int = BLOCK) -> int:
    """Synchronizing CUDA calls in one steady-state block, counted with
    torch.cuda.set_sync_debug_mode("warn") on a fresh system."""
    import torch
    from vins_tpu_torch.core.preintegration import ImuChunk

    sys_ = run["system"]()
    seq, imgs, ts = run["seq"], run["imgs"], run["ts"]
    n_boot = run["init_at"] + 1
    sys_.process_stream(imgs[:n_boot], ImuChunk(*[x[:n_boot]
                                                  for x in seq.chunks]),
                        block=block, ts=ts[:n_boot])
    s, e = n_boot, n_boot + block
    chunks = ImuChunk(*[x[s:e] for x in seq.chunks])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            handle = sys_.dispatch_block(imgs[s:e], chunks, ts=ts[s:e])
            sys_.publish_block(sys_.sync_block(handle))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(1 for w in caught if "synchroniz" in str(w.message))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs "
              "an NVIDIA GPU")
    card = _card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    from vins_tpu_torch import default_config
    from vins_tpu_torch.ops import klt_cuda, native

    t0 = time.perf_counter()
    native.library()
    report["build"] = dict(native.build_info,
                           load_s=time.perf_counter() - t0)
    print(f"build: {report['build']['seconds']:.1f} s nvcc "
          f"({time.perf_counter() - t0:.1f} s to load)")

    cfg = default_config()
    device = torch.device("cuda", 0)
    kernels = kernel_phase(cfg, device)

    run = slice_phase(cfg, device)
    for k in kernels:
        k["launches"] = run["launches"][k["name"]]
    syncs = count_block_syncs(run)
    print(f"slice: {run['frames']} frames, init at frame {run['init_at']}, "
          f"ATE {run['ate_rmse_m']:.4f} m aligned, "
          f"{run['ate_raw_rmse_m']:.4f} m raw; "
          f"{run['system_frames_per_s']:.2f} frames/s end to end, "
          f"{run['block_frames_per_s']:.2f} frames/s in block mode, "
          f"{syncs} synchronizing CUDA calls per {BLOCK}-frame block "
          f"({run['keyframe_syncs_per_block']:.1f} keyframe-branch syncs); "
          f"{card}")
    report["slice"] = {k: v for k, v in run.items()
                       if k not in ("system", "seq", "imgs", "ts")}
    report["syncs_per_block"] = syncs
    report["kernels"] = kernels
    os.makedirs("smoke_out", exist_ok=True)
    with open(os.path.join("smoke_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
