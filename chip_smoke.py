"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
  1. device   — requires torch.cuda.is_available(); prints the card's name
                and power limit as nvidia-smi reports them;
  2. build    — compiles vins_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
                nvcc per source, all started together;
  3. kernels  — every kernel against its plain PyTorch version on the card,
                at the main path's shapes, with its device time (`ms`:
                20 calls captured in a CUDA graph, one replay timed with
                CUDA events; torch.profiler's kernel time beside it), its
                eager call time (`call_ms`), the plain version's time and
                the least time the card could take (bound):
                klt_fb_ncc, the main path's fused forward-backward-NCC
                tracking kernel (M = 128 slots, 640x480 frames, 3 levels,
                win 21, 10 iterations, eps 0.01; again bit for bit on
                planes that are not 16-byte aligned), timed in turns
                against the three launches it replaces (K1 forward, K1
                backward, K2) on the same inputs,
                K1 pyramidal LK and K2 patch NCC at the same shapes,
                K4 one LK level (level 0 of the same shapes),
                K3 BRIEF words from the raw 640x480 frame, the blur fused
                in (N = 512 keyframe keypoints and N = 128 tracked
                features, border keypoints and invalid rows included;
                words identical, again on a frame that is not 16-byte
                aligned), timed in turns against the route it replaces
                (gaussian_blur, then K3's blurred-input entry), and that
                blurred-input entry alone;
  4. loop     — the default system, VinsSystem(cfg) with loop closure on,
                at default_config() on bench.py's revisiting circle
                (w = 0.7, bob 0.15): it bootstraps itself (visual-inertial
                initialization, no ground truth) within bench.py's 48
                frames, then 720 frames (2.7 laps) in blocks of 48; fails
                without finite poses, a verified loop hit, a pose-graph
                run, a ride-time attach and one fused K3 launch per
                keyframe insert and attach try (the blurred-input entry
                never);
  5. loop-off — VinsSystem(cfg, use_loop=False) over 192 frames of the
                slower w = 0.35 circle: initialized by frame 45 and an
                aligned ATE under 0.15 m (tests/test_stream_parity.py's
                bounds for the same in-stream bootstrap);
  6. interactive — VinsSystem(cfg) with loop closure on, frame by frame
                through process_frame over 150 frames of the w = 0.35
                circle: bootstrap, then the 30 Hz motion-only solve on
                every frame, the backend every third and the loop DB on
                keyframes; fails unless it initializes, its poses are
                finite, its aligned ATE is under 0.15 m, klt_fb_ncc
                launches once per tracked frame and K3 from the raw frame
                once per keyframe insert.
Every run prints its initialization attempts (frame, status, wall time,
synchronizing CUDA calls); the interactive run prints the per-frame wall
time of the motion-only solve, a backend frame and a keyframe insert.
Kernel launch counts are set to 0 just before each system run and read
just after it; every kernel on a run's path must have launched there
(klt_fb_ncc once per tracked frame, the standalone K1 and K2 never;
in the loop-on run K3 from the raw frame once per keyframe insert and
ride-time attach try, K3's blurred-input entry never).
The block runs also count their synchronizing CUDA calls block by block
(torch.cuda.set_sync_debug_mode("warn")). A kernel's bound counts the
bytes its inputs need (the pixels under the windows or taps it reads,
overlaps once) and the operations of this run's iterations.
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

BLOCK = 48
SEED = 7
# Loop-off run: the trajectory of tests/test_stream_parity.py (w = 0.35
# rad/s), on which its 0.15 m bound on the aligned ATE was set.
N_FRAMES_OFF = 192      # the bootstrap (by frame 45), then blocks of 48
TRAJ_OFF = dict(w=0.35, bob=0.15)
ATE_MAX = 0.15          # tests/test_stream_parity.py:242, after alignment
# Loop-on run: bench.py's revisiting circle (bench.py:101-104), where the
# path comes back on itself within the run. A hit verified on the second
# lap is staged two blocks after its keyframe, when the view has moved on,
# so its ride-time attach comes on the third lap: bench.py's 432 frames
# after bootstrap verify hits and run the pose graph but attach nothing,
# hence 720. No ATE bound is gated there: the reference's own estimate
# drifts on this circle.
N_AFTER_BOOT_LOOP = 720
TRAJ_LOOP = dict(w=0.7, bob=0.15)
# Initialization budgets: bench.py:117 gives the system frames 0-47 to
# bootstrap on its circle; tests/test_stream_parity.py:237 asserts the
# in-stream bootstrap on the w = 0.35 circle by frame 45.
N_BOOT_MAX = 48
N_FRAMES_LOOP = N_BOOT_MAX + N_AFTER_BOOT_LOOP
INIT_AT_MAX_OFF = 45
# Interactive run: frame by frame on the w = 0.35 circle, well past
# bootstrap (about 30 frames).
N_FRAMES_INTERACTIVE = 150
FLOW_TOL = 1e-3         # px
NCC_TOL = 1e-4
OK_AGREE = 0.99
FB_THRESH = 0.3         # ops/klt.track_pyramid_fb's round-trip bound, px

# Published peaks of one H100 SXM: HBM3 bandwidth and dense FP32 rate.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

# Operation counts of the kernels, per 21x21 window pixel: a bilinear tap
# is 6 multiplies and 3 adds; K1/K4 read three taps per template pixel and
# form the 2x2 structure tensor (3 multiply-adds), then per LK iteration
# read one tap, subtract, and accumulate the two residual products and
# the absolute error (7 more); K2 reads two taps and accumulates the
# means, the cross and the two squares (8 more).
TAP_OPS = 9
KLT_SETUP_OPS = 3 * TAP_OPS + 6
KLT_ITER_OPS = TAP_OPS + 7
NCC_OPS = 2 * TAP_OPS + 8
# One output of a 5-tap blur pass: 5 multiplies and 4 adds.
BLUR_OPS = 9


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _call_ms(fn, reps: int = 20) -> float:
    """What an eager caller pays per call: CUDA events around `reps`
    calls. Where the host work of a call outlasts its kernel, this is
    host time."""
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


def _device_ms(fn, reps: int = 20) -> float:
    """Device time per call: `reps` calls captured into one CUDA graph
    (after a warm-up on a side stream, as torch.cuda.graphs asks) and
    CUDA events around one replay, so no host work lies between the
    launches. The wrappers launch on the current stream and allocate with
    torch.empty, so the capture records their kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _profiled_ms(fn, kernels, reps: int = 20):
    """Cross-check of _device_ms: the device time per call of the kernels
    whose name holds one of `kernels` over `reps` eager calls, as
    torch.profiler traces them; None where the trace holds no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(k in e.name for k in kernels)]
    if not times or sum(times) <= 0:
        return None
    return sum(times) / reps / 1e3


def _timed(fn, *kernels: str) -> dict:
    """Device time, profiled device time and eager call time of one call
    of fn, which launches the named kernels ("" names them all)."""
    return dict(ms=_device_ms(fn), profiler_ms=_profiled_ms(fn, kernels),
                call_ms=_call_ms(fn))


def _mean_timed(a: dict, b: dict) -> dict:
    """The mean of two _timed results (None where either is None)."""
    return {k: (None if a[k] is None or b[k] is None else 0.5 * (a[k] + b[k]))
            for k in a}


def _ms_text(t: dict) -> str:
    prof = ("not measured" if t["profiler_ms"] is None
            else f"{t['profiler_ms']:.4f} ms")
    return (f"device {t['ms']:.4f} ms (profiler {prof}), call "
            f"{t['call_ms']:.4f} ms")


def _card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        _fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def _bound(n_bytes: float, n_ops: float) -> dict:
    """Least time for the work: the larger of bytes over the memory rate
    and float32 operations over the peak rate."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOP_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_us": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "operations": n_ops}


def _klt_ops(iters_run, live_per_level, win: int) -> float:
    area = win * win
    return float(sum(area * (KLT_SETUP_OPS * n_live
                             + KLT_ITER_OPS * int(it.sum()))
                     for it, n_live in zip(iters_run, live_per_level)))


def _pixels_mask(shape, x0, y0, offs):
    """[H, W] bool: the pixels at (x0 + dx, y0 + dy) for every base
    (x0, y0) [n] and offset (dx, dy) in offs [k, 2]."""
    import torch
    H, W = shape
    mask = torch.zeros(H * W, dtype=torch.bool, device=x0.device)
    idx = ((y0[:, None] + offs[None, :, 1]) * W
           + (x0[:, None] + offs[None, :, 0]))
    mask[idx.reshape(-1)] = True
    return mask.view(H, W)


def _pixels_read(shape, x0, y0, offs) -> int:
    """Distinct pixels of an [H, W] plane at (x0 + dx, y0 + dy): what a
    kernel that reads those pixels must move, overlaps counted once."""
    return int(_pixels_mask(shape, x0, y0, offs).sum())


def _window_pixels(plane, centers, win: int) -> int:
    """Distinct pixels of `plane` under the bilinear (win + 1)^2 windows
    centred at centers [n, 2], each corner clamped as the kernels clamp it
    (klt_cuda._patches)."""
    import torch
    H, W = plane.shape
    r = (win - 1) / 2.0
    corner = [torch.floor(torch.clamp(torch.nan_to_num(c - r, nan=0.0), 0.0,
                                      n - win - 1.001)).long()
              for c, n in ((centers[:, 0], W), (centers[:, 1], H))]
    o = torch.arange(win + 1, device=plane.device)
    offs = torch.stack(torch.meshgrid(o, o, indexing="xy"), -1).reshape(-1, 2)
    return _pixels_read((H, W), corner[0], corner[1], offs)


def _brief_mask(shape, pts, valid, pattern):
    """[H, W] bool: the blurred pixels that the taps of the valid
    keypoints read, the 2x2 neighbourhood of each of the 512 taps inside
    the clamped 49x49 patch (brief_cuda.extract_brief_words_plain)."""
    import torch
    from vins_tpu_torch.ops import brief_cuda
    H, W = shape
    half, pw = brief_cuda.PATCH_HALF, brief_cuda.PATCH_WIN
    base = [torch.floor(torch.clamp(torch.nan_to_num(c - half, nan=0.0), 0.0,
                                    n - pw - 1.001)).long()[valid] + half
            for c, n in ((pts[:, 0], W), (pts[:, 1], H))]
    taps = torch.cat([pattern[:, :2], pattern[:, 2:]]).long()
    quad = torch.tensor([[0, 0], [1, 0], [0, 1], [1, 1]], device=pts.device)
    offs = (taps[:, None, :] + quad[None]).reshape(-1, 2)
    return _pixels_mask((H, W), base[0], base[1], offs)


def _brief_pixels(blurred, pts, valid, pattern) -> int:
    """Distinct blurred pixels that the taps of the valid keypoints read."""
    return int(_brief_mask(blurred.shape, pts, valid, pattern).sum())


def _brief_raw_work(raw, pts, valid, pattern) -> dict:
    """What BRIEF from the raw frame needs, each value once: the blurred
    pixels under the taps of the valid keypoints, the vertical-pass values
    the horizontal pass needs for them, and the raw pixels those need,
    both through the 5-tap footprint with reflect-101 at the borders
    (image._reflect_index)."""
    import torch
    from vins_tpu_torch.ops import brief_cuda
    H, W = raw.shape
    rad = brief_cuda.BLUR_TAPS // 2

    def reflect(j, n):
        j = j.abs()
        return torch.where(j >= n, 2 * n - 2 - j, j)

    blur = _brief_mask(raw.shape, pts, valid, pattern)
    vert = torch.zeros_like(blur)
    need = torch.zeros_like(blur)
    r, c = torch.nonzero(blur, as_tuple=True)
    for d in range(-rad, rad + 1):
        vert[r, reflect(c + d, W)] = True
    r, c = torch.nonzero(vert, as_tuple=True)
    for d in range(-rad, rad + 1):
        need[reflect(r + d, H), c] = True
    return dict(raw_px=int(need.sum()), vert_px=int(vert.sum()),
                blur_px=int(blur.sum()))

def frame_pair(cfg, device):
    """Two consecutive rendered frames of the loop-off trajectory, the raw
    first frame and its prep as the main path prepares it (CLAHE, pyramid,
    Scharr gradients), and 128 slots: Shi–Tomasi corners of the first
    frame, a third of them dead, plus border points."""
    import torch
    from vins_tpu_torch.io import synthetic
    from vins_tpu_torch.ops import corners
    from vins_tpu_torch.stream import precompute_block

    seq = synthetic.make_synthetic_sequence(
        cfg, n_frames=2, n_landmarks=50, seed=SEED, frame_dt=1.0 / 30.0,
        traj_kwargs=TRAJ_OFF, imu_per_frame=4, device=device)
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
    return (level(0), lgrad(0), level(1), lgrad(1), pts.contiguous(), valid,
            imgs[0].contiguous())


def brief_inputs(raw, n: int, device):
    """The frame blurred as K3's blurred-input entry reads it, and n
    keypoints: FAST corners of the raw frame, 8 of them moved within 25 px
    of the four borders, a third of the rows invalid."""
    import torch
    from vins_tpu_torch.ops import corners, image

    H, W = raw.shape
    blurred = image.gaussian_blur(raw, 2.0).contiguous()
    pick = corners.select_corners_grid(
        corners.fast_score(raw),
        torch.zeros((H // 8, W // 8), dtype=torch.bool, device=device), n, 8)
    pts = pick.pts[:n].clone()
    pts[:8] = torch.tensor(
        [[0.0, 0.0], [W - 1.0, H - 1.0], [3.25, H - 2.5], [W - 20.5, 4.75],
         [24.5, H / 2], [W / 2, 2.25], [W - 1.0, 240.6], [0.5, H - 24.9]],
        device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    valid = torch.rand(n, generator=gen, device=device) > 0.33
    valid[:8] = True
    return blurred, pts.contiguous(), valid.contiguous()


def kernel_phase(cfg, device) -> list:
    import torch
    from vins_tpu_torch.ops import brief, brief_cuda, image, klt, klt_cuda

    fe = cfg.frontend
    win, iters, eps = fe.klt_window, fe.klt_iters, fe.klt_eps
    pyr0, g0, pyr1, g1, pts, valid, raw = frame_pair(cfg, device)
    M = pts.shape[0]
    f4 = 4.0

    # K1's forward pass, then the backward pass from the forward result
    # and its post-filtered status, seeded with the negated forward flow,
    # as track_pyramid_fb ran them before the fused kernel.
    p_k, ok_k, e_k = klt_cuda.track_pyramid(pyr0, g0, pyr1, pts, valid,
                                            win, iters, eps)
    iters_k1 = []
    p_p, ok_p, e_p = klt_cuda.track_pyramid_plain(
        pyr0, g0, pyr1, pts, valid, win, iters, eps, iters_run=iters_k1)
    st_k = klt_cuda.post_filter(p_k, ok_k, e_k, valid, pyr1[0].shape)
    bwd = (pyr1, g1, pyr0, p_k, st_k, win, iters, eps, pts - p_k)
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
    t_k1 = _timed(lambda: klt_cuda.track_pyramid(
        pyr0, g0, pyr1, pts, valid, win, iters, eps), "klt_pyramid_kernel")
    ms_p1 = _call_ms(lambda: klt_cuda.track_pyramid_plain(
        pyr0, g0, pyr1, pts, valid, win, iters, eps), reps=5)
    # Bytes the function needs: per level, the prev, gx and gy windows
    # around each live slot's point and the next-frame window around its
    # tracked point (dead slots need no reads), overlaps counted once.
    n_live = int(valid.sum())
    k1_px = sum(3 * _window_pixels(p, pts[valid] / 2.0 ** lvl, win)
                + _window_pixels(p, p_k[valid] / 2.0 ** lvl, win)
                for lvl, p in enumerate(pyr0))
    b_k1 = _bound(k1_px * f4 + M * (8 + 1) + M * (8 + 1 + 4),
                  _klt_ops(iters_k1, [n_live] * len(pyr0), win))

    # K4: K1's kernel at one level (level 0), with a per-slot guess (half
    # the forward flow), against its plain version.
    guess = (0.5 * (p_k - pts)).contiguous()
    lvl_args = (pyr0[0], g0[0][0], g0[0][1], pyr1[0], pts, guess, valid,
                win, iters, eps)
    f4_k, ok4_k, e4_k = klt_cuda.track_level(*lvl_args)
    iters_k4 = []
    f4_p, ok4_p, e4_p = klt_cuda.track_level_plain(*lvl_args,
                                                   iters_run=iters_k4)
    torch.cuda.synchronize()
    if not bool(torch.equal(ok4_k, ok4_p)):
        _fail(f"K4 ok differs on slots "
              f"{torch.nonzero(ok4_k != ok4_p).flatten().tolist()}")
    both = ok4_k & ok4_p
    k4_err = float((f4_k - f4_p)[both].abs().max()) if both.any() else 0.0
    if not np.isfinite(k4_err) or k4_err > FLOW_TOL:
        _fail(f"K4 flow differs from its plain version by {k4_err} px")
    t_k4 = _timed(lambda: klt_cuda.track_level(*lvl_args),
                  "klt_pyramid_kernel")
    ms_p4 = _call_ms(lambda: klt_cuda.track_level_plain(*lvl_args), reps=5)
    k4_px = (3 * _window_pixels(pyr0[0], pts[valid], win)
             + _window_pixels(pyr0[0], (pts + f4_k)[valid], win))
    b_k4 = _bound(k4_px * f4 + M * (8 + 8 + 1) + M * (8 + 1 + 4),
                  _klt_ops(iters_k4, [n_live], win))

    # K2 on the forward result, as track_pyramid_fb calls it.
    n_k = klt_cuda.patch_ncc(pyr0[0], pyr1[0], pts, p_k, win)
    n_p = klt_cuda.patch_ncc_plain(pyr0[0], pyr1[0], pts, p_k, win)
    torch.cuda.synchronize()
    ncc_err = float((n_k - n_p).abs().max())
    if not np.isfinite(ncc_err) or ncc_err > NCC_TOL:
        _fail(f"K2 differs from its plain version by {ncc_err}")
    t_k2 = _timed(lambda: klt_cuda.patch_ncc(pyr0[0], pyr1[0], pts, p_k,
                                             win), "patch_ncc_kernel")
    ms_p2 = _call_ms(lambda: klt_cuda.patch_ncc_plain(pyr0[0], pyr1[0], pts,
                                                      p_k, win))
    # K2 scores every slot, live or not: one window per slot in each image.
    k2_px = (_window_pixels(pyr0[0], pts, win)
             + _window_pixels(pyr1[0], p_k, win))
    b_k2 = _bound(k2_px * f4 + 2 * M * 8 + M * 4, M * win * win * NCC_OPS)

    # The fused kernel against its plain version (the composition
    # track_pyramid_fb ran before), then timed in turns against the three
    # launches it replaces on the same inputs: K1 forward, K1 backward
    # seeded as above, K2.
    fb_args = (pyr0, g0, pyr1, g1, pts, valid, win, iters, eps, FB_THRESH,
               klt.NCC_MIN)
    fb_k = klt_cuda.track_fb(*fb_args)
    fb_p = klt_cuda.track_fb_plain(*fb_args)
    torch.cuda.synchronize()
    fb_agree = float((fb_k[1] == fb_p[1]).float().mean())
    kept = fb_k[1] & fb_p[1]
    fb_pts_err = (float((fb_k[0] - fb_p[0])[kept].abs().max())
                  if kept.any() else 0.0)
    fb_rt_err = (float((fb_k[2] - fb_p[2])[kept].abs().max())
                 if kept.any() else 0.0)
    fb_ncc_err = float((fb_k[3] - fb_p[3]).abs().max())
    if fb_agree < 1.0:
        print(f"klt_fb_ncc: status differs on slots "
              f"{torch.nonzero(fb_k[1] != fb_p[1]).flatten().tolist()}")
    if not (np.isfinite(fb_pts_err) and fb_pts_err <= FLOW_TOL):
        _fail(f"klt_fb_ncc points differ from the plain version by "
              f"{fb_pts_err} px")
    if not (np.isfinite(fb_rt_err) and fb_rt_err <= 2 * FLOW_TOL):
        _fail(f"klt_fb_ncc round trips differ from the plain version by "
              f"{fb_rt_err} px")
    if not (np.isfinite(fb_ncc_err) and fb_ncc_err <= NCC_TOL):
        _fail(f"klt_fb_ncc NCC differs from the plain version by "
              f"{fb_ncc_err}")
    if fb_agree < OK_AGREE:
        _fail(f"klt_fb_ncc status agrees on only {fb_agree:.3f} of slots")
    # Planes that are not 16-byte aligned take the kernel's 4-byte copies
    # into the same shared-memory layout: the same bits must come out.
    def shifted(x):
        y = torch.empty(x.numel() + 1, device=x.device)[1:].view(x.shape)
        return y.copy_(x)

    fb_shifted = klt_cuda.track_fb(
        [shifted(p) for p in pyr0], [tuple(map(shifted, g)) for g in g0],
        [shifted(p) for p in pyr1], [tuple(map(shifted, g)) for g in g1],
        *fb_args[4:])
    if not all(torch.equal(a, b) for a, b in zip(fb_shifted, fb_k)):
        _fail("klt_fb_ncc differs on planes that are not 16-byte aligned")

    def fused():
        return klt_cuda.track_fb(*fb_args)

    def three():
        return (klt_cuda.track_pyramid(pyr0, g0, pyr1, pts, valid, win,
                                       iters, eps),
                klt_cuda.track_pyramid(*bwd),
                klt_cuda.patch_ncc(pyr0[0], pyr1[0], pts, p_k, win))

    turns = [_timed(fused, "klt_fb_ncc_kernel"),
             _timed(three, "klt_pyramid_kernel", "patch_ncc_kernel"),
             _timed(three, "klt_pyramid_kernel", "patch_ncc_kernel"),
             _timed(fused, "klt_fb_ncc_kernel")]
    t_fb = _mean_timed(turns[0], turns[3])
    t_three = _mean_timed(turns[1], turns[2])
    ms_pfb = _call_ms(lambda: klt_cuda.track_fb_plain(*fb_args), reps=5)
    # Bytes: per level, the union of the windows the two passes and the
    # NCC need in each plane: the prev frame under the forward templates
    # (live slots), the backward pass's tracked windows (slots live there)
    # and, at level 0, the NCC window of every slot; the next frame
    # likewise; the gradients under their pass's templates. Operations:
    # both passes' setups and this run's iterations, the NCC statistics
    # of every slot, and the level-0 template taps of slots whose pass
    # does not run (the NCC still needs them).
    fwd_st = klt_cuda.post_filter(p_p, ok_p, e_p, valid, pyr1[0].shape)
    iters_bwd = []
    p_b, _, _ = klt_cuda.track_pyramid_plain(
        pyr1, g1, pyr0, p_p, fwd_st, win, iters, eps, init_flow=pts - p_p,
        iters_run=iters_bwd)
    n_bwd = int(fwd_st.sum())
    fb_px = 0
    for lvl in range(len(pyr0)):
        s = 2.0 ** lvl
        ncc_a = pts if lvl == 0 else pts[:0]
        ncc_b = p_p if lvl == 0 else p_p[:0]
        fb_px += _window_pixels(pyr0[lvl], torch.cat(
            [pts[valid] / s, p_b[fwd_st] / s, ncc_a]), win)
        fb_px += _window_pixels(pyr1[lvl], torch.cat(
            [p_p[valid] / s, p_p[fwd_st] / s, ncc_b]), win)
        fb_px += 2 * _window_pixels(pyr0[lvl], pts[valid] / s, win)
        fb_px += 2 * _window_pixels(pyr1[lvl], p_p[fwd_st] / s, win)
    area = win * win
    b_fb = _bound(fb_px * f4 + M * (8 + 1) + M * (8 + 1 + 4 + 4),
                  _klt_ops(iters_k1, [n_live] * len(pyr0), win)
                  + _klt_ops(iters_bwd, [n_bwd] * len(pyr0), win)
                  + M * area * (NCC_OPS - 2 * TAP_OPS)
                  + (2 * M - n_live - n_bwd) * area * TAP_OPS)

    # K3 at the keyframe-insert shape (N = 512) and the attach shape
    # (N = 128). The raw-frame entry that extract_brief calls must give the
    # words of its plain version bit for bit, on the raw frame and on a
    # copy that is not 16-byte aligned, and the words of the route it
    # replaced (gaussian_blur, then the blurred-input entry); the
    # blurred-input entry those of its own plain version. Then the two
    # routes are timed in turns on the same frame and keypoints. The
    # checks run the blur first, so _reflect_index's cache holds its
    # indices before any graph capture.
    pattern = brief.pattern_tensor(device)
    taps = image.gaussian_taps(2.0)
    raw_shifted = shifted(raw)
    k3, k3r = {}, {}
    for n in (cfg.loop.max_kf_features, fe.max_features):
        blurred, kp, kv = brief_inputs(raw, n, device)
        args = (blurred, kp, kv, pattern)

        def fused(img=raw):
            return brief_cuda.extract_brief_raw(img, kp, kv, pattern, taps)

        def fused_plain(img=raw):
            return brief_cuda.extract_brief_raw_plain(img, kp, kv, pattern,
                                                      taps)

        def blur_words():
            return brief_cuda.extract_brief_words(
                image.gaussian_blur(raw, 2.0).contiguous(), kp, kv, pattern)

        checks = (
            ("K3 against its plain version",
             brief_cuda.extract_brief_words(*args),
             brief_cuda.extract_brief_words_plain(*args)),
            ("K3 from the raw frame against its plain version", fused(),
             fused_plain()),
            ("K3 from a raw frame not 16-byte aligned against its plain "
             "version", fused(raw_shifted), fused_plain(raw_shifted)),
            ("K3 from the raw frame against gaussian_blur + K3", fused(),
             blur_words()))
        torch.cuda.synchronize()
        for what, w_k, w_p in checks:
            n_diff = int((w_k != w_p).sum())
            if n_diff:
                _fail(f"{what}: {n_diff} of {w_k.numel()} words differ at "
                      f"N = {n}")
        k3_turns = [_timed(fused, "brief_words_kernel"),
                    _timed(blur_words, ""), _timed(blur_words, ""),
                    _timed(fused, "brief_words_kernel")]
        # The raw pixels the taps need through the blur's footprint, the
        # two passes' outputs they need (BLUR_OPS each) and the taps.
        work = _brief_raw_work(raw, kp, kv, pattern)
        k3r[n] = dict(
            **_mean_timed(k3_turns[0], k3_turns[3]),
            plain_ms=_call_ms(fused_plain),
            blur_words=_mean_timed(k3_turns[1], k3_turns[2]),
            turns=k3_turns,
            work=work,
            **_bound(work["raw_px"] * f4 + n * (8 + 1) + pattern.numel() * 4
                     + len(taps) * 4 + n * brief_cuda.BRIEF_WORDS * 4,
                     BLUR_OPS * (work["vert_px"] + work["blur_px"])
                     + int(kv.sum()) * brief_cuda.BRIEF_BITS
                     * (2 * TAP_OPS + 1)))
        # Only valid rows need their taps read and compared.
        k3[n] = dict(
            **_timed(lambda: brief_cuda.extract_brief_words(*args),
                     "brief_words_kernel"),
            plain_ms=_call_ms(
                lambda: brief_cuda.extract_brief_words_plain(*args)),
            **_bound(_brief_pixels(blurred, kp, kv, pattern) * f4
                     + n * (8 + 1) + pattern.numel() * 4
                     + n * brief_cuda.BRIEF_WORDS * 4,
                     int(kv.sum()) * brief_cuda.BRIEF_BITS
                     * (2 * TAP_OPS + 1)))
    n_ins, n_att = cfg.loop.max_kf_features, fe.max_features

    print(f"K1 klt_pyramid: flow err {flow_err:.3g} px, err err "
          f"{err_err:.3g}, ok agree {agree_frac:.4f} "
          f"({int(ok_k.sum())} tracked of {n_live} live); "
          f"{_ms_text(t_k1)} vs plain {ms_p1:.4f} ms, bound "
          f"{b_k1['bound_us']:.3f} us ({b_k1['bound_by']})")
    print(f"K4 klt_level: flow err {k4_err:.3g} px, ok identical; "
          f"{_ms_text(t_k4)} vs plain {ms_p4:.4f} ms, bound "
          f"{b_k4['bound_us']:.3f} us ({b_k4['bound_by']})")
    print(f"K2 patch_ncc: err {ncc_err:.3g}; {_ms_text(t_k2)} vs plain "
          f"{ms_p2:.4f} ms, bound {b_k2['bound_us']:.3f} us "
          f"({b_k2['bound_by']})")
    print(f"klt_fb_ncc: pts err {fb_pts_err:.3g} px, round-trip err "
          f"{fb_rt_err:.3g} px, ncc err {fb_ncc_err:.3g}, status agree "
          f"{fb_agree:.4f} ({int(fb_k[1].sum())} kept of {n_live} live); "
          f"{_ms_text(t_fb)} vs plain {ms_pfb:.4f} ms, bound "
          f"{b_fb['bound_us']:.3f} us ({b_fb['bound_by']}); in turns "
          f"fused {turns[0]['ms']:.4f}, three launches {turns[1]['ms']:.4f}, "
          f"{turns[2]['ms']:.4f}, fused {turns[3]['ms']:.4f} ms device "
          f"(calls {turns[0]['call_ms']:.4f}, {turns[1]['call_ms']:.4f}, "
          f"{turns[2]['call_ms']:.4f}, {turns[3]['call_ms']:.4f} ms)")
    for n, r in k3r.items():
        tr, bw = r["turns"], r["blur_words"]
        print(f"K3 brief_raw_words N={n}: words identical (aligned, "
              f"misaligned, and to gaussian_blur + K3); {_ms_text(r)} vs "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_us']:.3f} us "
              f"({r['bound_by']}; {r['work']}); gaussian_blur + K3: "
              f"{_ms_text(bw)}; in turns fused {tr[0]['ms']:.4f}, blur + K3 "
              f"{tr[1]['ms']:.4f}, {tr[2]['ms']:.4f}, fused {tr[3]['ms']:.4f} "
              f"ms device (calls {tr[0]['call_ms']:.4f}, "
              f"{tr[1]['call_ms']:.4f}, {tr[2]['call_ms']:.4f}, "
              f"{tr[3]['call_ms']:.4f} ms)")
    for n, r in k3.items():
        print(f"K3 brief_words N={n}: words identical; {_ms_text(r)} vs "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_us']:.3f} us "
              f"({r['bound_by']})")

    def entry(name, source, replaces, err, t, plain_ms, bound, **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=0, max_abs_err=err,
                    ms=t["ms"], call_ms=t["call_ms"],
                    profiler_ms=t["profiler_ms"], plain_ms=plain_ms,
                    bound_ms=bound["bound_ms"],
                    bound_us=bound["bound_us"], bound_by=bound["bound_by"],
                    bound_bytes=bound["bytes"],
                    bound_operations=bound["operations"],
                    library_ms=None, **extra)

    klt_src = "vins_tpu_torch/csrc/klt.cu"
    brief_src = "vins_tpu_torch/csrc/brief.cu"
    ins, att = k3r[n_ins], k3r[n_att]
    return [
        entry("klt_fb_ncc", klt_src, "vins_tpu/ops/klt_pallas.py:281",
              max(fb_pts_err, fb_ncc_err), t_fb, ms_pfb, b_fb,
              also_replaces="vins_tpu/ops/klt_pallas.py:387",
              status_agree=fb_agree, round_trip_err=fb_rt_err,
              turns_ms=[t["ms"] for t in turns],
              turns_call_ms=[t["call_ms"] for t in turns],
              three_launches_ms=t_three["ms"],
              three_launches_call_ms=t_three["call_ms"],
              three_launches_profiler_ms=t_three["profiler_ms"]),
        entry("klt_pyramid", klt_src, "vins_tpu/ops/klt_pallas.py:281",
              flow_err, t_k1, ms_p1, b_k1, on_main_path=False),
        entry("patch_ncc", klt_src, "vins_tpu/ops/klt_pallas.py:387",
              ncc_err, t_k2, ms_p2, b_k2, on_main_path=False),
        entry("brief_raw_words", brief_src, "vins_tpu/ops/klt_pallas.py:344",
              0.0, ins, ins["plain_ms"], ins,
              also_replaces="vins_tpu/ops/image.py:70",
              blur_then_words_ms=ins["blur_words"]["ms"],
              blur_then_words_profiler_ms=ins["blur_words"]["profiler_ms"],
              blur_then_words_call_ms=ins["blur_words"]["call_ms"],
              turns_ms=[t["ms"] for t in ins["turns"]],
              turns_call_ms=[t["call_ms"] for t in ins["turns"]],
              work=ins["work"],
              ms_attach=att["ms"], profiler_ms_attach=att["profiler_ms"],
              call_ms_attach=att["call_ms"], plain_ms_attach=att["plain_ms"],
              bound_ms_attach=att["bound_ms"],
              bound_by_attach=att["bound_by"],
              blur_then_words_ms_attach=att["blur_words"]["ms"],
              blur_then_words_profiler_ms_attach=att["blur_words"][
                  "profiler_ms"],
              blur_then_words_call_ms_attach=att["blur_words"]["call_ms"],
              turns_ms_attach=[t["ms"] for t in att["turns"]],
              turns_call_ms_attach=[t["call_ms"] for t in att["turns"]],
              work_attach=att["work"]),
        entry("brief_words", brief_src, "vins_tpu/ops/klt_pallas.py:344",
              0.0, k3[n_ins], k3[n_ins]["plain_ms"], k3[n_ins],
              on_main_path=False,
              ms_attach=k3[n_att]["ms"], call_ms_attach=k3[n_att]["call_ms"],
              plain_ms_attach=k3[n_att]["plain_ms"],
              bound_ms_attach=k3[n_att]["bound_ms"]),
        entry("klt_level", klt_src, "vins_tpu/ops/klt_pallas.py:134",
              k4_err, t_k4, ms_p4, b_k4, on_main_path=False),
    ]


def _reset_counts() -> None:
    from vins_tpu_torch.ops import brief_cuda, klt_cuda
    klt_cuda.reset_launch_counts()
    brief_cuda.reset_launch_counts()


def _read_counts() -> dict:
    from vins_tpu_torch.ops import brief_cuda, klt_cuda
    return {"klt_fb_ncc": klt_cuda.track_fb.launches,
            "klt_pyramid": klt_cuda.track_pyramid.launches,
            "patch_ncc": klt_cuda.patch_ncc.launches,
            "brief_raw_words": brief_cuda.extract_brief_raw.launches,
            "brief_words": brief_cuda.extract_brief_words.launches,
            "klt_level": klt_cuda.track_level.launches}


def _ate(est, gt) -> tuple:
    from vins_tpu_torch.io.evaluate import ate_rmse
    raw = float(np.sqrt(np.mean(np.sum((est - gt) ** 2, -1))))
    return ate_rmse(est, gt).rmse, raw


class _SyncCounter:
    """While active, every synchronizing CUDA call is reported as a
    warning (torch.cuda.set_sync_debug_mode("warn")) and recorded;
    mark() and count() split the record. Counts stay 0 off the card."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.caught = []

    def __enter__(self):
        import torch
        self._cm = warnings.catch_warnings(record=True)
        self.caught = self._cm.__enter__()
        warnings.simplefilter("always")
        if self.on_card:
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch
        if self.on_card:
            torch.cuda.set_sync_debug_mode("default")
        return self._cm.__exit__(*exc)

    def mark(self) -> int:
        return len(self.caught)

    def count(self, start: int, end=None) -> int:
        return sum(1 for w in self.caught[start:end]
                   if "synchroniz" in str(w.message))


def _record_attempts(sys_, counter: _SyncCounter, sync) -> list:
    """Wrap sys_._initialize_window: each bootstrap attempt records its
    frame, status, wall time (synchronized) and synchronizing CUDA calls
    (counted before the closing synchronize). Returns the record list;
    del sys_._initialize_window restores the method."""
    attempts = []
    attempt = sys_._initialize_window

    def timed(feats, chunks, frames):
        at = counter.mark()
        t0 = time.perf_counter()
        window, cost, status = attempt(feats, chunks, frames)
        n_sync = counter.count(at)
        sync()
        attempts.append(dict(frame=int(frames[-1]),
                             status=status or "SUCCESS",
                             seconds=time.perf_counter() - t0,
                             syncs=n_sync))
        return window, cost, status

    sys_._initialize_window = timed
    return attempts


def _stream_counting_syncs(sys_, stream, counter: _SyncCounter):
    """Run stream() with the counter active, and split its count at the
    start of each dispatch_block and of the end-of-stream drain. Returns
    stream()'s result and one record per segment: its syncs and the
    verified hits, PACK_LGOOD frames and pose-graph runs it added."""
    marks = []

    def loop_state():
        st = sys_.loop_stats
        return (st["hits"], st["good_frames"],
                sys_.loop.n_optimizes if sys_.loop is not None else 0)

    def marked(kind, fn):
        def call(*args, **kwargs):
            marks.append((kind, counter.mark(), loop_state()))
            return fn(*args, **kwargs)
        return call

    sys_.dispatch_block = marked("block", sys_.dispatch_block)
    sys_.drain_loop_work = marked("drain", sys_.drain_loop_work)
    try:
        out = stream()
    finally:
        del sys_.dispatch_block, sys_.drain_loop_work
    ends = [(at, st) for _, at, st in marks[1:]] + [(counter.mark(),
                                                     loop_state())]
    segments = []
    for (kind, at, st), (at_end, st_end) in zip(marks, ends):
        segments.append(dict(
            kind=kind, syncs=counter.count(at, at_end),
            hits=st_end[0] - st[0], attach_frames=st_end[1] - st[1],
            pose_graph_runs=st_end[2] - st[2]))
    return out, segments


def _sync_summary(segments) -> dict:
    """Synchronizing CUDA calls per block: every block's count, the
    median and largest, and the largest among blocks that verified a hit,
    rode an attached anchor or ran the pose graph."""
    blocks = [s for s in segments if s["kind"] == "block"]
    counts = [s["syncs"] for s in blocks]

    def most(key):
        hit = [s["syncs"] for s in blocks if s[key] > 0]
        return max(hit) if hit else None

    return dict(per_block=counts,
                median=float(np.median(counts)) if counts else None,
                max=max(counts) if counts else None,
                max_verifying=most("hits"), max_attaching=most("attach_frames"),
                max_pose_graph=most("pose_graph_runs"),
                drain=sum(s["syncs"] for s in segments
                          if s["kind"] == "drain"))


def slice_phase(cfg, device, use_loop: bool, traj: dict, n_frames: int,
                block: int = BLOCK, max_init_at=None) -> dict:
    """Drive VinsSystem.process_stream over a rendered sequence, the
    system bootstrapping itself (failing if that takes past frame
    max_init_at); returns the measurements, the initialization attempts
    and the synchronizing CUDA calls per block included. Runs on any
    device (the CPU takes the kernels' plain versions, and launch and
    sync counts stay 0 there)."""
    import torch
    from vins_tpu_torch import stream as stream_mod
    from vins_tpu_torch.io import synthetic
    from vins_tpu_torch.pipeline import VinsSystem

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    seq = synthetic.make_synthetic_sequence(
        cfg, n_frames=n_frames, n_landmarks=300, seed=SEED,
        frame_dt=1.0 / 30.0, traj_kwargs=traj, imu_per_frame=4,
        device=device)
    t0 = time.perf_counter()
    imgs = synthetic.render_sequence_images(seq, cfg, seed=SEED,
                                            device=device)
    sync()
    render_s = time.perf_counter() - t0
    ts = seq.timestamps.cpu().numpy()

    sys_ = VinsSystem(cfg, ext=seq.ext, device=device, use_loop=use_loop)
    # Each ride-time attach try extracts BRIEF once: count the tries.
    attach = stream_mod._attach_loop
    attach_tries = 0

    def counted_attach(*args, **kwargs):
        nonlocal attach_tries
        attach_tries += 1
        return attach(*args, **kwargs)

    stream_mod._attach_loop = counted_attach
    _reset_counts()
    t0 = time.perf_counter()
    try:
        with _SyncCounter(on_card) as counter:
            attempts = _record_attempts(sys_, counter, sync)
            outs, segments = _stream_counting_syncs(
                sys_, lambda: sys_.process_stream(imgs, seq.chunks,
                                                  block=block, ts=ts),
                counter)
        sync()
    finally:
        stream_mod._attach_loop = attach
        del sys_._initialize_window
    wall = time.perf_counter() - t0
    launches = _read_counts()

    if len(outs) != n_frames:
        _fail(f"{len(outs)} outputs for {n_frames} frames")
    init_at = next((i for i, o in enumerate(outs) if o.initialized), None)
    if init_at is None:
        _fail(f"the system never initialized (attempts {attempts})")
    if max_init_at is not None and init_at > max_init_at:
        _fail(f"initialized at frame {init_at}, after frame {max_init_at} "
              f"(attempts {attempts})")
    post = outs[init_at:]
    if not all(o.initialized for o in post):
        _fail("an output after bootstrap is not initialized")
    est = np.stack([o.p for o in post])
    est_raw = np.stack([o.p_raw for o in post])
    quats = np.stack([o.q for o in post])
    if not (np.all(np.isfinite(est)) and np.all(np.isfinite(quats))
            and np.all(np.isfinite(est_raw))):
        _fail("non-finite pose after bootstrap")
    gt = seq.p.cpu().numpy()[init_at:]
    ate, ate_raw = _ate(est, gt)
    ate_nc, ate_raw_nc = _ate(est_raw, gt)
    n_stream = n_frames - init_at - 1
    block_s = sum(sys_.timings[k] for k in ("dispatch", "sync", "insert",
                                            "publish", "drain"))
    res = dict(
        use_loop=use_loop, frames=n_frames, init_at=init_at,
        init_attempts=attempts,
        ate_rmse_m=ate, ate_raw_rmse_m=ate_raw,
        ate_rmse_uncorrected_m=ate_nc, ate_raw_rmse_uncorrected_m=ate_raw_nc,
        wall_s=wall, render_s=render_s,
        system_frames_per_s=n_frames / wall,
        block_frames=n_stream, block_s=block_s,
        block_frames_per_s=n_stream / block_s if block_s > 0 else 0.0,
        blocks=sys_.timings["blocks"], timings=dict(sys_.timings),
        keyframe_syncs_per_block=((sys_.timings["host_syncs"]
                                   - sys_.timings["blocks"])
                                  / max(sys_.timings["blocks"], 1)),
        launches=launches, attach_tries=attach_tries,
        syncs=_sync_summary(segments),
        sync_segments=segments)
    if use_loop:
        lc = sys_.loop
        res.update(loop_stats=dict(sys_.loop_stats),
                   pose_graph_runs=lc.n_optimizes, keyframes_in_db=lc.count,
                   keyframes_inserted=lc.n_inserts, loop_edges=lc.n_loops,
                   detect_stats=dict(lc.detect_stats),
                   t_drift=lc.t_drift.tolist())
    tracked = n_frames - 1          # frame 0 only detects
    if on_card:
        if launches["klt_fb_ncc"] != tracked:
            _fail(f"klt_fb_ncc launched {launches['klt_fb_ncc']} times for "
                  f"{tracked} tracked frames")
        if launches["klt_pyramid"] or launches["patch_ncc"]:
            _fail(f"the standalone K1 and K2 launched "
                  f"{launches['klt_pyramid']} and {launches['patch_ncc']} "
                  f"times on the system path")
    if use_loop:
        st = res["loop_stats"]
        if st["hits"] < 1:
            _fail(f"no verified loop hit (detection {res['detect_stats']})")
        if res["pose_graph_runs"] < 1:
            _fail("no pose-graph run")
        if st["good_frames"] < 1:
            _fail("no ride-time attach (no frame with PACK_LGOOD)")
        n_brief = res["keyframes_inserted"] + attach_tries
        if on_card and (res["keyframes_inserted"] < 1
                        or launches["brief_raw_words"] != n_brief
                        or launches["brief_words"]):
            _fail(f"K3 from the raw frame launched "
                  f"{launches['brief_raw_words']} times for "
                  f"{res['keyframes_inserted']} keyframe inserts and "
                  f"{attach_tries} attach tries, the blurred-input entry "
                  f"{launches['brief_words']} times")
    elif ate >= ATE_MAX:
        _fail(f"aligned ATE RMSE {ate:.4f} m >= {ATE_MAX} m")
    return res


def interactive_phase(cfg, device, traj: dict, n_frames: int) -> dict:
    """Drive VinsSystem.process_frame (loop closure on) frame by frame over
    a rendered sequence: bootstrap, then the interactive NON_LINEAR path.
    Returns the measurements: the initialization attempts, each frame's
    wall time by kind (boot, a 30 Hz frame with the motion-only solve, a
    backend frame), the motion-only solve's own time (pnp_step) and each
    keyframe insert's (insert and detection). Runs on any device."""
    import torch
    from vins_tpu_torch.core import pnp as pnp_mod
    from vins_tpu_torch.core.preintegration import ImuChunk
    from vins_tpu_torch.io import synthetic
    from vins_tpu_torch.pipeline import VinsSystem

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    seq = synthetic.make_synthetic_sequence(
        cfg, n_frames=n_frames, n_landmarks=300, seed=SEED,
        frame_dt=1.0 / 30.0, traj_kwargs=traj, imu_per_frame=4,
        device=device)
    imgs = synthetic.render_sequence_images(seq, cfg, seed=SEED,
                                            device=device)
    ts = seq.timestamps.cpu().numpy()
    sys_ = VinsSystem(cfg, ext=seq.ext, device=device)

    solve_ms, insert_ms = [], []

    def timed(fn, into):
        def call(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    step = pnp_mod.pnp_step
    pnp_mod.pnp_step = timed(step, solve_ms)
    sys_._handle_keyframe = timed(sys_._handle_keyframe, insert_ms)
    frames, outs = [], []
    _reset_counts()
    try:
        with _SyncCounter(on_card) as counter:
            attempts = _record_attempts(sys_, counter, sync)
            sync()
            t_run = time.perf_counter()
            for k in range(n_frames):
                kind = ("boot" if not sys_.initialized else "backend"
                        if sys_.frame_idx % cfg.freq == 0 else "solve")
                n_ins = len(insert_ms)
                t0 = time.perf_counter()
                outs.append(sys_.process_frame(
                    imgs[k], ImuChunk(*[x[k] for x in seq.chunks]),
                    t=float(ts[k])))
                sync()
                frames.append(dict(kind=kind, insert=len(insert_ms) > n_ins,
                                   ms=(time.perf_counter() - t0) * 1e3))
            wall = time.perf_counter() - t_run
    finally:
        pnp_mod.pnp_step = step
        del sys_._handle_keyframe, sys_._initialize_window
    launches = _read_counts()

    init_at = next((i for i, o in enumerate(outs) if o.initialized), None)
    if init_at is None:
        _fail(f"the interactive system never initialized (attempts "
              f"{attempts})")
    post = outs[init_at:]
    if not all(o.initialized for o in post):
        _fail("an interactive output after bootstrap is not initialized "
              f"(statuses {[o.status for o in post if o.status]})")
    est = np.stack([o.p for o in post])
    quats = np.stack([o.q for o in post])
    if not (np.all(np.isfinite(est)) and np.all(np.isfinite(quats))):
        _fail("non-finite interactive pose after bootstrap")
    ate, ate_raw = _ate(est, seq.p.cpu().numpy()[init_at:])
    if ate >= ATE_MAX:
        _fail(f"interactive aligned ATE RMSE {ate:.4f} m >= {ATE_MAX} m")
    lc = sys_.loop
    tracked = n_frames - 1          # frame 0 only detects
    if on_card:
        if launches["klt_fb_ncc"] != tracked:
            _fail(f"interactive: klt_fb_ncc launched "
                  f"{launches['klt_fb_ncc']} times for {tracked} tracked "
                  f"frames")
        if (lc.n_inserts < 1 or launches["brief_raw_words"] != lc.n_inserts
                or launches["brief_words"] or launches["klt_pyramid"]
                or launches["patch_ncc"]):
            _fail(f"interactive: K3 from the raw frame launched "
                  f"{launches['brief_raw_words']} times for {lc.n_inserts} "
                  f"keyframe inserts; launches {launches}")

    def stats(xs):
        return (dict(n=len(xs), median_ms=float(np.median(xs)),
                     mean_ms=float(np.mean(xs)), max_ms=float(np.max(xs)))
                if xs else dict(n=0))

    after = frames[init_at + 1:]
    n_after = len(after)
    return dict(
        frames=n_frames, init_at=init_at, init_attempts=attempts,
        ate_rmse_m=ate, ate_raw_rmse_m=ate_raw, wall_s=wall,
        frames_per_s=n_frames / wall,
        frames_per_s_after_init=(n_after / sum(f["ms"] for f in after)
                                 * 1e3 if n_after else 0.0),
        pnp_step=stats(solve_ms[1:]),
        solve_frame=stats([f["ms"] for f in after if f["kind"] == "solve"]),
        backend_frame=stats([f["ms"] for f in after
                             if f["kind"] == "backend" and not f["insert"]]),
        insert_frame=stats([f["ms"] for f in after if f["insert"]]),
        keyframe_insert=stats(insert_ms),
        boot_frame=stats([f["ms"] for f in frames[:init_at]
                          if f["kind"] == "boot"]),
        keyframes_inserted=lc.n_inserts, loop_stats=dict(sys_.loop_stats),
        launches=launches)


def _attempts_text(run: dict) -> str:
    return "; ".join(
        f"frame {a['frame']} {a['status']} {a['seconds']:.3f} s "
        f"{a['syncs']} syncs" for a in run["init_attempts"])


def _report_interactive(run: dict, card: str) -> None:
    print(f"interactive init: frame {run['init_at']}, "
          f"{len(run['init_attempts'])} attempts: {_attempts_text(run)}; "
          f"{card}")

    def ms(key):
        st = run[key]
        return (f"median {st['median_ms']:.2f} ms (mean {st['mean_ms']:.2f},"
                f" max {st['max_ms']:.2f}, n {st['n']})" if st["n"]
                else "none")

    print(f"interactive: {run['frames']} frames, init at frame "
          f"{run['init_at']}, ATE {run['ate_rmse_m']:.4f} m aligned, "
          f"{run['ate_raw_rmse_m']:.4f} m raw; {run['frames_per_s']:.2f} "
          f"frames/s end to end, {run['frames_per_s_after_init']:.2f} after "
          f"init; motion-only solve (pnp_step) {ms('pnp_step')}; 30 Hz "
          f"frame {ms('solve_frame')}; backend frame {ms('backend_frame')};"
          f" backend frame with a keyframe insert {ms('insert_frame')}; "
          f"keyframe insert and detection {ms('keyframe_insert')}; boot "
          f"frame {ms('boot_frame')}; {run['keyframes_inserted']} keyframes"
          f" inserted; launches {run['launches']}; {card}")


def _report_run(tag: str, run: dict, card: str) -> None:
    print(f"{tag} init: frame {run['init_at']}, "
          f"{len(run['init_attempts'])} attempts: {_attempts_text(run)}; "
          f"{card}")
    line = (f"{tag}: {run['frames']} frames, init at frame "
            f"{run['init_at']}, ATE {run['ate_rmse_m']:.4f} m aligned, "
            f"{run['ate_raw_rmse_m']:.4f} m raw")
    if run["use_loop"]:
        st = run["loop_stats"]
        line += (f" (without the drift correction "
                 f"{run['ate_rmse_uncorrected_m']:.4f} m aligned, "
                 f"{run['ate_raw_rmse_uncorrected_m']:.4f} m raw); "
                 f"detection {run['detect_stats']}, "
                 f"{st['hits']} verified hits, {st['staged']} staged, "
                 f"{st['attached']} attached ({st['good_frames']} frames "
                 f"with PACK_LGOOD), {st['retired']} retired, "
                 f"{run['pose_graph_runs']} pose-graph runs, "
                 f"{run['keyframes_inserted']} keyframes inserted "
                 f"({run['keyframes_in_db']} in the DB), "
                 f"{run['attach_tries']} attach tries, K3 from the raw "
                 f"frame launched {run['launches']['brief_raw_words']} "
                 f"times")
    sy = run["syncs"]
    line += (f"; {run['system_frames_per_s']:.2f} frames/s end to end, "
             f"{run['block_frames_per_s']:.2f} frames/s in block mode, "
             f"synchronizing CUDA calls per {BLOCK}-frame block: median "
             f"{sy['median']}, max {sy['max']}, max in blocks that verify a "
             f"hit {sy['max_verifying']}, ride an anchor "
             f"{sy['max_attaching']}, run the pose graph "
             f"{sy['max_pose_graph']}, end-of-stream drain {sy['drain']} "
             f"(per block {sy['per_block']}; "
             f"{run['keyframe_syncs_per_block']:.1f} keyframe-branch "
             f"syncs); launches {run['launches']}; {card}")
    print(line)


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
    from vins_tpu_torch.ops import native

    t0 = time.perf_counter()
    native.library()
    report["build"] = dict(native.build_info,
                           load_s=time.perf_counter() - t0)
    print(f"build: {report['build']['seconds']:.1f} s nvcc "
          f"({time.perf_counter() - t0:.1f} s to load)")

    cfg = default_config()
    device = torch.device("cuda", 0)
    kernels = kernel_phase(cfg, device)

    run_loop = slice_phase(cfg, device, True, TRAJ_LOOP, N_FRAMES_LOOP,
                           max_init_at=N_BOOT_MAX - 1)
    _report_run("loop", run_loop, card)
    run_off = slice_phase(cfg, device, False, TRAJ_OFF, N_FRAMES_OFF,
                          max_init_at=INIT_AT_MAX_OFF)
    _report_run("loop-off", run_off, card)
    run_int = interactive_phase(cfg, device, TRAJ_OFF, N_FRAMES_INTERACTIVE)
    _report_interactive(run_int, card)

    for k in kernels:
        k["launches"] = run_loop["launches"][k["name"]]
        k["launches_loop_off"] = run_off["launches"][k["name"]]
        k["launches_interactive"] = run_int["launches"][k["name"]]
    report["loop"], report["loop_off"] = run_loop, run_off
    report["interactive"] = run_int
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
