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
                blurred-input entry alone; then klt_fb_ncc and K3 from
                the raw frame (N = 512 and 128) again at euroc_config()'s
                shape, a 752x480 frame pair rendered through the EuRoC
                camera's distortion (row pitches of 3008, 1504 and 752
                bytes), with the same tolerances; then the runtime-window
                kernels (domain_kernel_phase): klt_fb_ncc, K1, K4 and K2
                at windows 15 (5 levels), 31 (2) and 63 (1) on the same
                640x480 frames and slots (flow within 1e-3 px; K2's NCC,
                and klt_fb_ncc's at its own tracked points, within 1e-5),
                and K3's patch entry at windows 11 and 49 on 512
                keypoints (bit for bit), beside its library yardstick,
                one grid_sample call (within LIBRARY_TOL, timed as
                library_ms);
  4. loop     — (in a spawned child process, with phases 11 and 13
                after it,
                alongside phases 5-10 in
                this one, which runs 8, 9 and 10 first, then 5-7, so that the
                script ends well inside its time on a slow host; each
                process counts its own launches and syncs, and the
                frames/s of these runs are read under that contention)
                the default system, VinsSystem(cfg)
                with loop closure on,
                at default_config() on bench.py's revisiting circle
                (w = 0.7, bob 0.15): it bootstraps itself (visual-inertial
                initialization, no ground truth) within bench.py's 48
                frames, then 720 frames (2.7 laps) through process_stream
                at its defaults (blocks of 48, depth 2); fails
                without finite poses, a verified loop hit, a pose-graph
                run, a ride-time attach and one fused K3 launch per
                keyframe insert and attach try (the blurred-input entry
                never);
  5. loop-off — VinsSystem(cfg, use_loop=False) over 192 frames of the
                slower w = 0.35 circle: initialized by frame 45 and an
                aligned ATE under 0.15 m (tests/test_stream_parity.py's
                bounds for the same in-stream bootstrap);
  6. realtime — process_stream(realtime=True, block=12) with the
                timestamps over the bootstrap and 96 frames of that
                circle: the solver budget must step from max_iters down
                to min_iters and stay within them, poses finite;
  7. interactive — VinsSystem(cfg) with loop closure on, frame by frame
                through process_frame over 96 frames of the w = 0.35
                circle: bootstrap, then the 30 Hz motion-only solve on
                every frame, the backend every third and the loop DB on
                keyframes; fails unless it initializes, its poses are
                finite, its aligned ATE is under 0.15 m, klt_fb_ncc
                launches once per tracked frame and K3 from the raw frame
                once per keyframe insert;
  8. euroc    — the EuRoC entry point: the port's ASL fixture writer
                renders tests/test_euroc_path.py's 360-frame revisit tree
                on the card into smoke_out/, then
                vins_tpu_torch.run_euroc.main(--stream --global-ba
                --loop-freq 1) runs it; fails unless that test's gates
                hold, klt_fb_ncc launches once per tracked frame and K3
                from the raw frame once per keyframe insert and attach
                try, no other kernel; prints the init frame, block
                frames/s, syncs per block and the device busy share of
                one steady-state cycle under torch.profiler; saves the
                global BA's harvested problem for phase 9;
  9. scale-out — at default_config(): 8 backend streams (make_synthetic_
                window, seeds 0-7) through make_batched_sequence_runner
                for 8 steps, one vmapped select-variant step each, and
                each stream alone through run_sequence_scan: decisions
                equal and poses within 1e-3 m; bench.py's 24-frame
                backend sequence through run_sequence_scan (no failure,
                poses within 0.1 m of the ground truth); phase 8's
                global-BA problem and make_ba_problem(K = 64, L = 2048)
                solved by solve_ba_sharded in 2 spawned ranks over gloo
                sharing the card and in 1 spawned rank over NCCL, against
                solve_ba here (tests/test_parallel.py's bounds: cost
                within rtol 1e-3, poses within 1e-4 m + rtol 1e-3; a rank
                still running after 300 s fails the phase); prints each
                part's wall (StageTimers), the
                batched step against one stream, the scan's frames/s,
                keyframe share and syncs, each BA's seconds and
                all_reduce payload, both worlds' scaling reports and the
                speed of light of one LM iteration at L = 2048;
 10. last-slice — (after 9, beside the loop-on child) tracking against
                the renderer's exact geometry: FeatureTracker over frames
                0-1 of tests/test_frontend.py's fixture (4 levels, 10 fps)
                against ground_truth_correspondence, with that test's
                bounds (>= 40 common tracks, median < 0.8 px, > 90% under
                2.5 px), and the same numbers, not gated, on the demo's
                30 Hz sequence at 3 levels; the demo,
                run_synthetic.main(--frames 120 --loop): it must
                initialize, give finite poses, write both PNGs (640x640
                and 640x480, not blank) and launch klt_fb_ncc once per
                tracked frame and K3 from the raw frame once per keyframe
                insert; the native sensor runtime (native/runtime.cpp
                built with g++ into vins_tpu_torch/_build/) against
                StreamSync on the card, tests/test_native_runtime.py's
                stream and bounds; the port's repaired native prefetcher
                over phase 8's 360 PNGs (4 workers, queue 2) under a 60 s
                watchdog, each frame equal to load_gray_png's, then
                run_euroc --native-loader --stream --no-loop over 96 of
                them (initialized, finite, klt_fb_ncc once per tracked
                frame). Prints each part's numbers and the phase's wall;
                the fixture's frames again at window 15 with 5 levels:
                the card's klt_fb_ncc launch held against its plain
                version on the tracker's inputs, the median distance to
                the exact correspondence printed;
 11. domain   — (in phase 4's child, after it) VinsSystem(cfg,
                use_loop=False) with only the frontend changed to
                klt_window=15, pyramid_levels=5, over 96 frames of the
                w = 0.35 circle: it must initialize, give finite poses
                and launch the runtime-window klt_fb_ncc once per
                tracked frame; its init frame, frames/s and aligned ATE
                are printed, the ATE not gated.
 12. card tests — (in subprocesses after phase 3, alone on the card:
                beside the other runs it took 649 s instead of some 50;
                the revisit case in a pytest process of its own beside
                the others, CARD_TEST_GROUPS) the gpu-marked cases of
                CARD_TEST_FILES through pytest without JAX or conftest
                (CARD_TEST_ARGS, README's command): the kernels against
                their plain versions at the tests' points, the
                runtime-window plan's boundaries among them, and the
                stream at the shipped klt_eps on the card against the
                same stream on the CPU, and the bootstrap's Schur
                complement on the card against its float64 value
                (tests/test_torch_stream_card.py), and the interactive
                path with loop closure over a revisiting circle on the
                card against the CPU, the same loop events on the same
                frames (tests/test_torch_interactive_revisit_card.py);
                fails unless pytest exits 0 and every collected case
                passed, none skipped; prints the count;
 13. revisit  — (in phase 4's child, after phase 11) VinsSystem(cfg) with
                loop closure on, frame by frame through process_frame
                over REVISIT_TRAJ, a circle that comes back to its start
                within the run, from a ground-truth bootstrap: fails
                unless a hit is verified, staged and attached, rides a
                good window solve and the pose graph runs, klt_fb_ncc
                launches once per tracked frame and K3 from the raw frame
                once per keyframe insert (verification reads the stored
                words); prints the loop events by frame (verify runs,
                hits, stagings, ridden frames, pose-graph runs), the
                drift-corrected and uncorrected aligned ATE (not gated)
                and each BRIEF launch's keypoint count;
Every run prints its initialization attempts (frame, status, wall time,
synchronizing CUDA calls) and how many marginalization priors took each
branch of the prior's factorization (ridge Cholesky, 100x ridge, eigen
fallback) and how many Schur complements took a larger ridge where the
dropped block's first Cholesky failed (counted on the device, read once
after the run); the
interactive run prints the per-frame wall time of the motion-only solve,
a backend frame and a keyframe insert.
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
# bootstrap (about 30 frames). 150 frames until phase 13 took over the
# long interactive run: 96 keep the script within its time.
N_FRAMES_INTERACTIVE = 96
# Revisit run (phase 13): process_frame with loop closure at
# default_config() over a circle that comes back to its start 236 frames
# after the bootstrap (radius 2 m at 0.8 rad/s, 0.15 m of bob): a
# ground-truth bootstrap at frame 30, the lap, then the revisit's
# detection, verification, staging, attach, ride and pose graph (the
# first hit at frame 291 in the first runs, each query after it
# verifying, so that each new hit supersedes the ridden one and runs the
# pose graph). Not tests/test_torch_interactive_revisit_card.py's circle
# (1.5 m at 0.9 rad/s): at default_config() the backend's failure
# detection fires on it twice a lap, loop closure on or off, through its
# features-tracked gate (under 4 window landmarks seen in the newest
# frame), in the JAX package too (tools/torch_revisit_reference.py).
# Its aligned ATE is recorded, not gated.
REVISIT_TRAJ = dict(r=2.0, w=0.8, bob=0.15)
N_FRAMES_REVISIT = 303
# EuRoC run: tests/test_euroc_path.py:113-141's revisit tree and gates.
EUROC_FRAMES = 360
EUROC_SEED = 9
EUROC_TRAJ = dict(w=0.42, bob=0.2, bob_w=1.9)
EUROC_ATE_MAX = 0.18
EUROC_BLOCK = 48        # run_euroc's process_stream block
# The loop-on run's process must end within this: about twice what it
# takes alone where the host runs the port slowest.
LOOP_ON_TIMEOUT_S = 900
# Real-time run: the loop-off circle, 96 frames after the bootstrap (by
# frame 30 in every earlier run) in blocks of 12.
N_RT_BOOT = 31
N_RT_AFTER = 96
N_RT_BLOCK = 12
# Device busy share: the loop-on run profiles the cycle of its 9th
# dispatch (steady state, verification under way); the interactive run
# the first backend frame from frame 60 on and the two 30 Hz frames
# after it.
PROFILE_AT = 8
PROFILE_FRAME = 60
# Phase 9 (scale-out): B streams of the backend through one vmapped step,
# each stream bootstrapped from make_synthetic_window with its own seed and
# fed the newest frame of the windows one frame interval later; bench.py's
# backend sequence builder (bench.py:29-55) through run_sequence_scan; the
# global BA's problem from phase 8 and tools/measure_scaling_chip.py's
# largest map (with bench.py:316's pixel noise) solved by spawned ranks
# (2 over gloo sharing the card, 1 over NCCL).
N_STREAMS = 8
N_BATCH_STEPS = 8
STREAM_LANDMARKS = 300
STREAM_NOISE_PX = 0.3
# Stream s's frame interval is STREAM_DTS[s % 2]: at 10 Hz every frame
# clears default_config()'s 10 px parallax and is a keyframe, at 50 Hz
# about every other frame is not, so one batched call takes both slides.
STREAM_DTS = (0.1, 0.02)
# Each stream against its single-stream run: the first step within 1e-4 m;
# the later steps within 1e-3 m, the backend's parity bound against the
# JAX package (tests/test_torch_backend.py), since the batched products
# round otherwise than the unbatched ones and each step's LM solve starts
# from the last one's slightly different state.
STREAM_STEP1_TOL = 1e-4  # m
STREAM_POSE_TOL = 1e-3   # m
N_SCAN = 24
# bench.py's sequence at 50 Hz (it has 10 Hz, where every frame is a
# keyframe), so that the scan takes both slides. Its first N_SCAN_HOST
# frames also go through the main path's host-branch step, which the scan
# must match (decisions equal, poses within STREAM_STEP1_TOL at the first
# frame and STREAM_POSE_TOL after). The error against the ground truth is
# recorded, not gated: at 50 Hz the sequence's IMU edges are full, and
# merging two full edges in a non-keyframe slide drops samples in the
# JAX package as in the port (ROADMAP Queue 3), so the position falls
# behind the truth with every such slide.
SCAN_DT = 0.02
N_SCAN_HOST = 8
BA_ITERS = 8            # LoopCloser.global_ba's
BA_LARGE = dict(n_poses=64, n_landmarks=2048, seed=1, noise_px=0.5,
                pose_noise=0.05, point_noise=0.2)
# The position prior that harvest_ba_problem gives every global BA (0.3 per
# meter at the initial poses). Without it the map's scale rests on its two
# frozen poses, which are neighbours: the cost is flat along the scale, and
# a mere change of summation order (a landmark permutation in solve_ba, or
# the shards) moves the poses by millimeters at an equal cost.
BA_LARGE_PRIOR_W = 0.3
# A sharded solve against solve_ba on the card: the cost within rtol 1e-3,
# every pose coordinate within 1e-4 m.
BA_COST_RTOL = 1e-3
BA_POSE_TOL = 1e-4      # m
BA_RANKS_TIMEOUT_S = 300
EUROC_BA_PROBLEM = os.path.join("smoke_out", "euroc_ba_problem.pt")
SCALE_OUT_DIR = os.path.join("smoke_out", "scale_out")
# Phase 10 (last slice). Tracking against the renderer's exact geometry:
# tests/test_frontend.py:24-61's fixture (10 fps, so 4 pyramid levels)
# and bounds.
GEOM_FRAMES = 26
GEOM_LANDMARKS = 50
GEOM_SEED = 9
GEOM_TRAJ = dict(w=0.35, bob=0.15)
GEOM_COMMON_MIN = 40
GEOM_MEDIAN_MAX = 0.8   # px
GEOM_FAR_PX = 2.5
GEOM_NEAR_SHARE = 0.9   # of the common tracks within GEOM_FAR_PX
# The demo at the JAX demo's default length (examples/run_synthetic.py:25).
DEMO_FRAMES = 120
DEMO_OUT = os.path.join("smoke_out", "synthetic")
# The native loader decodes phase 8's fixture within this, or the phase
# fails; then run_euroc --native-loader runs this many of its frames.
LOADER_TIMEOUT_S = 60
LOADER_WORKERS = 4
LOADER_QUEUE_CAP = 2
NATIVE_EUROC_FRAMES = 96
FLOW_TOL = 1e-3         # px
# K1 flow on a slot whose plain pass ran all its updates at level 0 (it
# did not converge): the Pallas kernel and the port's plain version
# differ there by up to 1.16e-3 px (tests/test_torch_klt_domain.py), so
# such slots are held to about four times that.
FLOW_TOL_UNCONVERGED = 5e-3
NCC_TOL = 1e-4
# The card's parity tests: the gpu-marked cases of these files, run without
# JAX (the card's machine has none): no conftest (it imports JAX) and no
# pytest.ini addopts (its -n 2 needs pytest-xdist).
CARD_TEST_FILES = ("tests/test_torch_klt.py", "tests/test_torch_klt_domain.py",
                   "tests/test_torch_brief.py",
                   "tests/test_torch_stream_card.py",
                   "tests/test_torch_interactive_revisit_card.py")
CARD_TEST_ARGS = ("-p", "no:cacheprovider", "--noconftest", "-o", "addopts=",
                  "-m", "gpu", "-q", "-rP")
# Phase 12's pytest processes, started at once: the revisit case, most of
# it a CPU run and about three quarters of the files' time in one process
# on an H100 machine, beside the rest, which keep the card busy.
CARD_TEST_GROUPS = (("card_tests", CARD_TEST_FILES[:-1]),
                    ("card_tests_revisit", CARD_TEST_FILES[-1:]))
CARD_TESTS_TIMEOUT_S = 600
# The runtime-window kernels: (window, levels) points the default configs
# do not reach, on 640x480 frames with 128 slots (NCC within
# NCC_TOL_DOMAIN), and K3's patch entry at PATCH_WINS on N_PATCHES
# keypoints (bit for bit). The system runs at DOMAIN_PATH over
# N_FRAMES_DOMAIN frames of the w = 0.35 circle, loop off.
DOMAIN_POINTS = ((15, 5), (31, 2), (63, 1))
DOMAIN_PATH = (15, 5)
NCC_TOL_DOMAIN = 1e-5
PATCH_WINS = (11, 49)
N_PATCHES = 512
# grid_sample against the plain patches: it rounds the sample point
# otherwise (ops/brief_cuda.extract_patches_grid_sample).
LIBRARY_TOL = 1e-5
N_FRAMES_DOMAIN = 96
OK_AGREE = 0.99
FB_THRESH = 0.3         # ops/klt.track_pyramid_fb's round-trip bound, px

# Published peaks of one H100 SXM: HBM3 bandwidth and dense FP32 rate.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

# Operation counts of the kernels, per window pixel: a bilinear tap
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

def frame_pair(cfg, device, distorted: bool = False):
    """Two consecutive rendered frames of the loop-off trajectory (through
    the camera's distortion with `distorted`), the raw first frame and its
    prep as the main path prepares it (CLAHE, pyramid, Scharr gradients),
    and 128 slots: Shi–Tomasi corners of the first frame, a third of them
    dead, plus border points."""
    import torch
    from vins_tpu_torch.io import synthetic
    from vins_tpu_torch.ops import corners
    from vins_tpu_torch.stream import precompute_block

    seq = synthetic.make_synthetic_sequence(
        cfg, n_frames=2, n_landmarks=50, seed=SEED, frame_dt=1.0 / 30.0,
        traj_kwargs=TRAJ_OFF, imu_per_frame=4, device=device)
    imgs = synthetic.render_sequence_images(seq, cfg, seed=SEED,
                                            device=device,
                                            distorted=distorted)
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


def _held_err(diff, held, conv) -> tuple:
    """The largest |diff| ([M] or [M, 2]) over the held slots whose plain
    pass converged (conv), and over the held slots that did not."""
    d = diff.abs().reshape(diff.shape[0], -1).amax(-1)
    pick = lambda m: float(d[m].max()) if bool(m.any()) else 0.0
    return pick(held & conv), pick(held & ~conv)


def _fb_converged(fb_args) -> tuple:
    """[M] bool: the slots whose plain forward pass stopped early at level
    0, and those whose backward pass did too (as track_fb_plain runs
    them)."""
    from vins_tpu_torch.ops import klt_cuda
    pyr0, g0, pyr1, g1, pts, valid, win, iters, eps = fb_args[:9]
    run_f, run_b = [], []
    p, ok, err = klt_cuda.track_pyramid_plain(
        pyr0, g0, pyr1, pts, valid, win, iters, eps, iters_run=run_f)
    st = klt_cuda.post_filter(p, ok, err, valid, pyr1[0].shape)
    klt_cuda.track_pyramid_plain(pyr1, g1, pyr0, p, st, win, iters, eps,
                                 init_flow=pts - p, iters_run=run_b)
    fwd = run_f[-1] < iters
    return fwd, fwd & (run_b[-1] < iters)


def _check_fb(fb_args, tag: str, ncc_tol: float = NCC_TOL) -> dict:
    """klt_fb_ncc against its plain version on the same inputs: points
    to FLOW_TOL on the kept slots whose plain forward pass converged and
    to FLOW_TOL_UNCONVERGED on the others, round trips to twice those
    (FLOW_TOL where both passes converged), the NCC to NCC_TOL on the
    slots whose plain forward pass converged, the status on OK_AGREE of
    the slots; and on every slot the kernel's NCC against K2's plain
    version at the kernel's own tracked points to ncc_tol (the plain
    version's NCC is taken at its own points, which lie up to FLOW_TOL
    away where the forward pass converged and up to FLOW_TOL_UNCONVERGED
    where it did not). Fails otherwise."""
    import torch
    from vins_tpu_torch.ops import klt_cuda
    pyr0, _, pyr1, _, pts = fb_args[:5]
    fb_k = klt_cuda.track_fb(*fb_args)
    fb_p = klt_cuda.track_fb_plain(*fb_args)
    ncc_q = klt_cuda.patch_ncc_plain(pyr0[0], pyr1[0], pts, fb_k[0],
                                     fb_args[6])
    conv_f, conv_fb = _fb_converged(fb_args)
    torch.cuda.synchronize()
    ncc_q_err = float((fb_k[3] - ncc_q).abs().max())
    if not (np.isfinite(ncc_q_err) and ncc_q_err <= ncc_tol):
        _fail(f"{tag} NCC differs from K2's plain version at the kernel's "
              f"points by {ncc_q_err}")
    agree = float((fb_k[1] == fb_p[1]).float().mean())
    kept = fb_k[1] & fb_p[1]
    pts_err, pts_err_unc = _held_err(fb_k[0] - fb_p[0], kept, conv_f)
    rt_err, rt_err_unc = _held_err(fb_k[2] - fb_p[2], kept, conv_fb)
    every = torch.ones_like(kept)
    ncc_err, ncc_err_unc = _held_err(fb_k[3] - fb_p[3], every, conv_f)
    if agree < 1.0:
        print(f"{tag}: status differs on slots "
              f"{torch.nonzero(fb_k[1] != fb_p[1]).flatten().tolist()}")
    if not (np.isfinite(pts_err) and pts_err <= FLOW_TOL
            and pts_err_unc <= FLOW_TOL_UNCONVERGED):
        _fail(f"{tag} points differ from the plain version by {pts_err} px "
              f"(converged), {pts_err_unc} px (not converged)")
    if not (np.isfinite(rt_err) and rt_err <= 2 * FLOW_TOL
            and rt_err_unc <= 2 * FLOW_TOL_UNCONVERGED):
        _fail(f"{tag} round trips differ from the plain version by "
              f"{rt_err} px (converged), {rt_err_unc} px (not converged)")
    if not (np.isfinite(ncc_err) and ncc_err <= NCC_TOL):
        _fail(f"{tag} NCC differs from the plain version by {ncc_err}")
    if agree < OK_AGREE:
        _fail(f"{tag} status agrees on only {agree:.3f} of slots")
    return dict(out=fb_k, agree=agree, pts_err=pts_err,
                pts_err_unconverged=pts_err_unc, rt_err=rt_err,
                rt_err_unconverged=rt_err_unc, ncc_err=ncc_err,
                ncc_err_unconverged=ncc_err_unc,
                ncc_at_points_err=ncc_q_err, kept=int(fb_k[1].sum()))


def _fb_bound(fb_args) -> dict:
    """The least time of one klt_fb_ncc call on these inputs."""
    import torch
    from vins_tpu_torch.ops import klt_cuda
    pyr0, g0, pyr1, g1, pts, valid, win, iters, eps = fb_args[:9]
    M = pts.shape[0]
    f4 = 4.0
    n_live = int(valid.sum())
    iters_k1 = []
    p_p, ok_p, e_p = klt_cuda.track_pyramid_plain(
        pyr0, g0, pyr1, pts, valid, win, iters, eps, iters_run=iters_k1)
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
    return _bound(fb_px * f4 + M * (8 + 1) + M * (8 + 1 + 4 + 4),
                  _klt_ops(iters_k1, [n_live] * len(pyr0), win)
                  + _klt_ops(iters_bwd, [n_bwd] * len(pyr0), win)
                  + M * area * (NCC_OPS - 2 * TAP_OPS)
                  + (2 * M - n_live - n_bwd) * area * TAP_OPS)


def _k3_raw(raw, n: int, device, pattern, taps, turns: bool = True) -> dict:
    """K3 from the raw frame at N = n keypoints (brief_inputs): its words
    against its plain version bit for bit, on the raw frame and on a copy
    that is not 16-byte aligned, and against gaussian_blur + the
    blurred-input entry (fails otherwise); its device, call and plain
    times and its bound, and with `turns` the two routes timed in turns
    (fused, blur + K3, blur + K3, fused)."""
    import torch
    from vins_tpu_torch.ops import brief_cuda, image
    _, kp, kv = brief_inputs(raw, n, device)
    raw_shifted = _shifted(raw)

    def fused(img=raw):
        return brief_cuda.extract_brief_raw(img, kp, kv, pattern, taps)

    def fused_plain(img=raw):
        return brief_cuda.extract_brief_raw_plain(img, kp, kv, pattern, taps)

    def blur_words():
        return brief_cuda.extract_brief_words(
            image.gaussian_blur(raw, 2.0).contiguous(), kp, kv, pattern)

    checks = (
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
                  f"N = {n} on a {tuple(raw.shape)} frame")
    # The raw pixels the taps need through the blur's footprint, the two
    # passes' outputs they need (BLUR_OPS each) and the taps.
    work = _brief_raw_work(raw, kp, kv, pattern)
    bound = _bound(work["raw_px"] * 4.0 + n * (8 + 1) + pattern.numel() * 4
                   + len(taps) * 4 + n * brief_cuda.BRIEF_WORDS * 4,
                   BLUR_OPS * (work["vert_px"] + work["blur_px"])
                   + int(kv.sum()) * brief_cuda.BRIEF_BITS
                   * (2 * TAP_OPS + 1))
    if not turns:
        return dict(**_timed(fused, "brief_words_kernel"),
                    plain_ms=_call_ms(fused_plain), work=work, **bound)
    k3_turns = [_timed(fused, "brief_words_kernel"),
                _timed(blur_words, ""), _timed(blur_words, ""),
                _timed(fused, "brief_words_kernel")]
    return dict(**_mean_timed(k3_turns[0], k3_turns[3]),
                plain_ms=_call_ms(fused_plain),
                blur_words=_mean_timed(k3_turns[1], k3_turns[2]),
                turns=k3_turns, work=work, **bound)


def _shifted(x):
    """A copy of x that is not 16-byte aligned."""
    import torch
    y = torch.empty(x.numel() + 1, device=x.device)[1:].view(x.shape)
    return y.copy_(x)


KLT_SRC = "vins_tpu_torch/csrc/klt.cu"
BRIEF_SRC = "vins_tpu_torch/csrc/brief.cu"


def _entry(name, source, replaces, err, t, plain_ms, bound,
           library_ms=None, **extra):
    """One kernel's record on the `kernels` line (launches filled in
    after the system runs)."""
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=0, max_abs_err=err, ms=t["ms"], call_ms=t["call_ms"],
                profiler_ms=t["profiler_ms"], plain_ms=plain_ms,
                bound_ms=bound["bound_ms"], bound_us=bound["bound_us"],
                bound_by=bound["bound_by"], bound_bytes=bound["bytes"],
                bound_operations=bound["operations"], library_ms=library_ms,
                **extra)


def _k1_k4_k2(pyr0, g0, pyr1, g1, pts, valid, win: int, iters: int,
              eps: float, tag: str, ncc_tol: float = NCC_TOL) -> dict:
    """K1, K4 and K2 against their plain versions on one frame pair (fails
    on a disagreement), with their device, call and plain times and
    bounds. K1 runs forward, then backward from the forward result and its
    post-filtered status, seeded with the negated forward flow, as
    track_pyramid_fb ran them before the fused kernel; K4 is level 0 with
    half the forward flow as its guess; K2 scores the forward result.
    K1's and K4's flow is held on the slots both sides keep: to FLOW_TOL
    where the plain pass stopped early at level 0, to
    FLOW_TOL_UNCONVERGED where it ran all `iters` updates there (a slot
    that has not converged carries the rounding of each update; the
    Pallas kernel and the port's plain version differ there by as much)."""
    import torch
    from vins_tpu_torch.ops import klt_cuda
    M = pts.shape[0]
    f4 = 4.0
    p_k, ok_k, e_k = klt_cuda.track_pyramid(pyr0, g0, pyr1, pts, valid,
                                            win, iters, eps)
    iters_k1, iters_bwd = [], []
    p_p, ok_p, e_p = klt_cuda.track_pyramid_plain(
        pyr0, g0, pyr1, pts, valid, win, iters, eps, iters_run=iters_k1)
    st_k = klt_cuda.post_filter(p_k, ok_k, e_k, valid, pyr1[0].shape)
    bwd = (pyr1, g1, pyr0, p_k, st_k, win, iters, eps, pts - p_k)
    b_k = klt_cuda.track_pyramid(*bwd)
    b_p = klt_cuda.track_pyramid_plain(*bwd, iters_run=iters_bwd)
    torch.cuda.synchronize()
    agree = torch.cat([ok_k == ok_p, b_k[1] == b_p[1]])
    flow_err = flow_err_unc = err_err = 0.0
    n_unc = 0
    for (pk, okk, ek), (pp, okp, ep), run in (
            ((p_k, ok_k, e_k), (p_p, ok_p, e_p), iters_k1),
            (b_k, b_p, iters_bwd)):
        both = okk & okp
        conv = run[-1] < iters
        a, b = _held_err(pk - pp, both, conv)
        flow_err, flow_err_unc = max(flow_err, a), max(flow_err_unc, b)
        n_unc += int((both & ~conv).sum())
        if both.any():
            err_err = max(err_err, float((ek - ep)[both].abs().max()))
    agree_frac = float(agree.float().mean())
    if agree_frac < 1.0:
        print(f"K1{tag}: ok differs on slots "
              f"{torch.nonzero(~agree).flatten().tolist()}")
    if not (np.isfinite(flow_err) and flow_err <= FLOW_TOL
            and flow_err_unc <= FLOW_TOL_UNCONVERGED):
        _fail(f"K1{tag} flow differs from its plain version by {flow_err} px "
              f"(converged), {flow_err_unc} px (not converged)")
    if agree_frac < OK_AGREE:
        _fail(f"K1{tag} ok agrees on only {agree_frac:.3f} of slots")
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
        _fail(f"K4{tag} ok differs on slots "
              f"{torch.nonzero(ok4_k != ok4_p).flatten().tolist()}")
    k4_err, k4_err_unc = _held_err(f4_k - f4_p, ok4_k & ok4_p,
                                   iters_k4[-1] < iters)
    if not (np.isfinite(k4_err) and k4_err <= FLOW_TOL
            and k4_err_unc <= FLOW_TOL_UNCONVERGED):
        _fail(f"K4{tag} flow differs from its plain version by {k4_err} px "
              f"(converged), {k4_err_unc} px (not converged)")
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
    if not np.isfinite(ncc_err) or ncc_err > ncc_tol:
        _fail(f"K2{tag} differs from its plain version by {ncc_err}")
    t_k2 = _timed(lambda: klt_cuda.patch_ncc(pyr0[0], pyr1[0], pts, p_k,
                                             win), "patch_ncc_kernel")
    ms_p2 = _call_ms(lambda: klt_cuda.patch_ncc_plain(pyr0[0], pyr1[0], pts,
                                                      p_k, win))
    # K2 scores every slot, live or not: one window per slot in each image.
    k2_px = (_window_pixels(pyr0[0], pts, win)
             + _window_pixels(pyr1[0], p_k, win))
    b_k2 = _bound(k2_px * f4 + 2 * M * 8 + M * 4, M * win * win * NCC_OPS)
    return dict(p_k=p_k, ok_k=ok_k, bwd=bwd, n_live=n_live,
                flow_err=flow_err, flow_err_unconverged=flow_err_unc,
                n_unconverged=n_unc, err_err=err_err, agree=agree_frac,
                t_k1=t_k1, ms_p1=ms_p1, b_k1=b_k1, k4_err=k4_err,
                k4_err_unconverged=k4_err_unc, t_k4=t_k4,
                ms_p4=ms_p4, b_k4=b_k4, ncc_err=ncc_err, t_k2=t_k2,
                ms_p2=ms_p2, b_k2=b_k2)


def kernel_phase(cfg, device) -> list:
    import torch
    from vins_tpu_torch.ops import brief, brief_cuda, image, klt, klt_cuda

    fe = cfg.frontend
    win, iters, eps = fe.klt_window, fe.klt_iters, fe.klt_eps
    pyr0, g0, pyr1, g1, pts, valid, raw = frame_pair(cfg, device)
    f4 = 4.0

    k = _k1_k4_k2(pyr0, g0, pyr1, g1, pts, valid, win, iters, eps, "")
    p_k, ok_k, bwd, n_live = k["p_k"], k["ok_k"], k["bwd"], k["n_live"]
    flow_err, err_err, agree_frac = k["flow_err"], k["err_err"], k["agree"]
    t_k1, ms_p1, b_k1 = k["t_k1"], k["ms_p1"], k["b_k1"]
    k4_err, t_k4, ms_p4, b_k4 = k["k4_err"], k["t_k4"], k["ms_p4"], k["b_k4"]
    ncc_err, t_k2, ms_p2, b_k2 = k["ncc_err"], k["t_k2"], k["ms_p2"], k["b_k2"]

    # The fused kernel against its plain version (the composition
    # track_pyramid_fb ran before), then timed in turns against the three
    # launches it replaces on the same inputs: K1 forward, K1 backward
    # seeded as above, K2.
    fb_args = (pyr0, g0, pyr1, g1, pts, valid, win, iters, eps, FB_THRESH,
               klt.NCC_MIN)
    fbc = _check_fb(fb_args, "klt_fb_ncc")
    fb_k, fb_agree = fbc["out"], fbc["agree"]
    fb_pts_err, fb_rt_err, fb_ncc_err = (fbc["pts_err"], fbc["rt_err"],
                                         fbc["ncc_err"])
    # Planes that are not 16-byte aligned take the kernel's 4-byte copies
    # into the same shared-memory layout: the same bits must come out.
    fb_shifted = klt_cuda.track_fb(
        [_shifted(p) for p in pyr0], [tuple(map(_shifted, g)) for g in g0],
        [_shifted(p) for p in pyr1], [tuple(map(_shifted, g)) for g in g1],
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
    b_fb = _fb_bound(fb_args)

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
    k3, k3r = {}, {}
    for n in (cfg.loop.max_kf_features, fe.max_features):
        k3r[n] = _k3_raw(raw, n, device, pattern, taps)
        blurred, kp, kv = brief_inputs(raw, n, device)
        args = (blurred, kp, kv, pattern)
        w_k = brief_cuda.extract_brief_words(*args)
        w_p = brief_cuda.extract_brief_words_plain(*args)
        torch.cuda.synchronize()
        n_diff = int((w_k != w_p).sum())
        if n_diff:
            _fail(f"K3 against its plain version: {n_diff} of "
                  f"{w_k.numel()} words differ at N = {n}")
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

    print(f"K1 klt_pyramid: flow err {flow_err:.3g} px ("
          f"{k['flow_err_unconverged']:.3g} px on {k['n_unconverged']} "
          f"slots that did not converge), err err "
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

    ins, att = k3r[n_ins], k3r[n_att]
    return [
        _entry("klt_fb_ncc", KLT_SRC, "vins_tpu/ops/klt_pallas.py:281",
              max(fb_pts_err, fb_ncc_err), t_fb, ms_pfb, b_fb,
              also_replaces="vins_tpu/ops/klt_pallas.py:387",
              status_agree=fb_agree, round_trip_err=fb_rt_err,
              turns_ms=[t["ms"] for t in turns],
              turns_call_ms=[t["call_ms"] for t in turns],
              three_launches_ms=t_three["ms"],
              three_launches_call_ms=t_three["call_ms"],
              three_launches_profiler_ms=t_three["profiler_ms"]),
        _entry("klt_pyramid", KLT_SRC, "vins_tpu/ops/klt_pallas.py:281",
              flow_err, t_k1, ms_p1, b_k1, on_main_path=False),
        _entry("patch_ncc", KLT_SRC, "vins_tpu/ops/klt_pallas.py:387",
              ncc_err, t_k2, ms_p2, b_k2, on_main_path=False),
        _entry("brief_raw_words", BRIEF_SRC, "vins_tpu/ops/klt_pallas.py:344",
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
        _entry("brief_words", BRIEF_SRC, "vins_tpu/ops/klt_pallas.py:344",
              0.0, k3[n_ins], k3[n_ins]["plain_ms"], k3[n_ins],
              on_main_path=False,
              ms_attach=k3[n_att]["ms"], call_ms_attach=k3[n_att]["call_ms"],
              plain_ms_attach=k3[n_att]["plain_ms"],
              bound_ms_attach=k3[n_att]["bound_ms"]),
        _entry("klt_level", KLT_SRC, "vins_tpu/ops/klt_pallas.py:134",
              k4_err, t_k4, ms_p4, b_k4, on_main_path=False),
    ]


def euroc_kernel_phase(cfg, device) -> list:
    """klt_fb_ncc and K3 from the raw frame at euroc_config()'s shape: a
    752x480 frame pair rendered through the camera's radial-tangential
    distortion, 128 slots, 3 levels (752x480, 376x240, 188x120), K3 at
    N = 512 and 128; each against its plain version with kernel_phase's
    tolerances (K3's words bit for bit), with its device, call and plain
    times and its bound."""
    import torch
    from vins_tpu_torch.ops import brief, image, klt, klt_cuda

    fe = cfg.frontend
    pyr0, g0, pyr1, g1, pts, valid, raw = frame_pair(cfg, device,
                                                     distorted=True)
    # Rows of 3008, 1504 and 752 bytes: the kernels' 16-byte copies.
    pitches = [int(p.stride(0)) * p.element_size() for p in pyr0 + pyr1]
    if any(b % 16 for b in pitches):
        _fail(f"EuRoC pyramid row pitches {pitches} are not 16-byte "
              f"multiples")
    shapes = [tuple(p.shape) for p in pyr0]
    fb_args = (pyr0, g0, pyr1, g1, pts, valid, fe.klt_window, fe.klt_iters,
               fe.klt_eps, FB_THRESH, klt.NCC_MIN)
    fbc = _check_fb(fb_args, "klt_fb_ncc at 752x480")
    t_fb = _timed(lambda: klt_cuda.track_fb(*fb_args), "klt_fb_ncc_kernel")
    ms_pfb = _call_ms(lambda: klt_cuda.track_fb_plain(*fb_args), reps=5)
    b_fb = _fb_bound(fb_args)
    pattern = brief.pattern_tensor(device)
    taps = image.gaussian_taps(2.0)
    n_ins, n_att = cfg.loop.max_kf_features, fe.max_features
    k3r = {n: _k3_raw(raw, n, device, pattern, taps, turns=False)
           for n in (n_ins, n_att)}
    print(f"klt_fb_ncc at 752x480 (levels {shapes}, row pitches "
          f"{pitches[:3]} B): pts err {fbc['pts_err']:.3g} px, round-trip "
          f"err {fbc['rt_err']:.3g} px, ncc err {fbc['ncc_err']:.3g}, "
          f"status agree {fbc['agree']:.4f} ({fbc['kept']} kept of "
          f"{int(valid.sum())} live); {_ms_text(t_fb)} vs plain "
          f"{ms_pfb:.4f} ms, bound {b_fb['bound_us']:.3f} us "
          f"({b_fb['bound_by']})")
    for n, r in k3r.items():
        print(f"K3 brief_raw_words at 752x480 N={n}: words identical "
              f"(aligned, misaligned, and to gaussian_blur + K3); "
              f"{_ms_text(r)} vs plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_us']:.3f} us ({r['bound_by']}; {r['work']})")
    ins, att = k3r[n_ins], k3r[n_att]
    return [
        _entry("klt_fb_ncc@752x480", KLT_SRC,
               "vins_tpu/ops/klt_pallas.py:281",
               max(fbc["pts_err"], fbc["ncc_err"]), t_fb, ms_pfb, b_fb,
               also_replaces="vins_tpu/ops/klt_pallas.py:387",
               status_agree=fbc["agree"], round_trip_err=fbc["rt_err"],
               levels=shapes),
        _entry("brief_raw_words@752x480", BRIEF_SRC,
               "vins_tpu/ops/klt_pallas.py:344", 0.0, ins, ins["plain_ms"],
               ins, also_replaces="vins_tpu/ops/image.py:70",
               work=ins["work"], ms_attach=att["ms"],
               profiler_ms_attach=att["profiler_ms"],
               call_ms_attach=att["call_ms"], plain_ms_attach=att["plain_ms"],
               bound_ms_attach=att["bound_ms"],
               bound_by_attach=att["bound_by"], work_attach=att["work"]),
    ]


def _with_window(cfg, win: int, levels: int):
    """cfg with only the frontend's LK window and pyramid depth changed."""
    import dataclasses
    return dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, klt_window=win, pyramid_levels=levels))


def _plan_text(plan, win: int, L: int) -> str:
    """klt_cuda.generic_plan's plan in words."""
    kt = plan.taps_per_thread
    where = (f"{kt} template taps a thread in registers, {plan.ring_levels} "
             f"of {L} levels staged" if kt > 0
             else f"templates of {plan.shared_taps} of {win * win} taps in "
             f"shared memory")
    return f"{where}, {plan.smem_bytes} B shared memory"


def domain_kernel_phase(cfg, device) -> list:
    """The runtime-window kernels: klt_fb_ncc, K1, K4 and K2 at each of
    DOMAIN_POINTS on frame_pair's 640x480 frames (128 slots, border points
    and dead slots), and K3's patch entry at PATCH_WINS on N_PATCHES
    keypoints of the blurred frame (border keypoints included); each
    against its plain version (flow to FLOW_TOL, NCC to NCC_TOL_DOMAIN,
    patches bit for bit), with its device, call and plain times and its
    bound; the patches also against one grid_sample call (LIBRARY_TOL),
    whose device time is the entry's library_ms."""
    from vins_tpu_torch.ops import brief_cuda, klt, klt_cuda

    fe = cfg.frontend
    iters, eps = fe.klt_iters, fe.klt_eps
    rows = []
    for win, L in DOMAIN_POINTS:
        pyr0, g0, pyr1, g1, pts, valid, _ = frame_pair(
            _with_window(cfg, win, L), device)
        tag = f"@{win}x{win},L{L}"
        k = _k1_k4_k2(pyr0, g0, pyr1, g1, pts, valid, win, iters, eps, tag,
                      ncc_tol=NCC_TOL_DOMAIN)
        fb_args = (pyr0, g0, pyr1, g1, pts, valid, win, iters, eps,
                   FB_THRESH, klt.NCC_MIN)
        fbc = _check_fb(fb_args, "klt_fb_ncc" + tag, ncc_tol=NCC_TOL_DOMAIN)
        t_fb = _timed(lambda: klt_cuda.track_fb(*fb_args),
                      "klt_fb_ncc_kernel")
        ms_pfb = _call_ms(lambda: klt_cuda.track_fb_plain(*fb_args), reps=2)
        b_fb = _fb_bound(fb_args)
        plan = klt_cuda.generic_plan(win, L)
        shapes = [tuple(p.shape) for p in pyr0]
        print(f"klt_fb_ncc{tag} (levels {shapes}, "
              f"{_plan_text(plan, win, L)}): pts err {fbc['pts_err']:.3g} px "
              f"({fbc['pts_err_unconverged']:.3g} not converged), "
              f"round-trip err {fbc['rt_err']:.3g} px, ncc err "
              f"{fbc['ncc_err']:.3g} ({fbc['ncc_at_points_err']:.3g} "
              f"at the kernel's points), status agree "
              f"{fbc['agree']:.4f} ({fbc['kept']} kept of {k['n_live']} "
              f"live); {_ms_text(t_fb)} vs plain {ms_pfb:.4f} ms, bound "
              f"{b_fb['bound_us']:.3f} us ({b_fb['bound_by']})")
        print(f"K1{tag}: flow err {k['flow_err']:.3g} px "
              f"({k['flow_err_unconverged']:.3g} on {k['n_unconverged']} "
              f"slots that did not converge), ok agree "
              f"{k['agree']:.4f}; {_ms_text(k['t_k1'])} vs plain "
              f"{k['ms_p1']:.4f} ms, bound {k['b_k1']['bound_us']:.3f} us "
              f"({k['b_k1']['bound_by']}); K4: flow err {k['k4_err']:.3g} "
              f"px; {_ms_text(k['t_k4'])} vs plain {k['ms_p4']:.4f} ms, "
              f"bound {k['b_k4']['bound_us']:.3f} us; K2: err "
              f"{k['ncc_err']:.3g}; {_ms_text(k['t_k2'])} vs plain "
              f"{k['ms_p2']:.4f} ms, bound {k['b_k2']['bound_us']:.3f} us")
        extra = dict(win=win, levels=L, **plan._asdict(),
                     on_main_path=False)
        rows += [
            _entry("klt_fb_ncc" + tag, KLT_SRC,
                   "vins_tpu/ops/klt_pallas.py:281",
                   max(fbc["pts_err"], fbc["ncc_err"]), t_fb, ms_pfb, b_fb,
                   also_replaces="vins_tpu/ops/klt_pallas.py:387",
                   status_agree=fbc["agree"], round_trip_err=fbc["rt_err"],
                   ncc_at_points_err=fbc["ncc_at_points_err"],
                   **dict(extra, on_main_path=(win, L) == DOMAIN_PATH)),
            _entry("klt_pyramid" + tag, KLT_SRC,
                   "vins_tpu/ops/klt_pallas.py:281", k["flow_err"],
                   k["t_k1"], k["ms_p1"], k["b_k1"], **extra),
            _entry("klt_level" + tag, KLT_SRC,
                   "vins_tpu/ops/klt_pallas.py:134", k["k4_err"], k["t_k4"],
                   k["ms_p4"], k["b_k4"], **dict(extra, levels=1)),
            _entry("patch_ncc" + tag, KLT_SRC,
                   "vins_tpu/ops/klt_pallas.py:387", k["ncc_err"],
                   k["t_k2"], k["ms_p2"], k["b_k2"], **extra)]

    _, _, _, _, _, _, raw = frame_pair(cfg, device)
    blurred, kp, _ = brief_inputs(raw, N_PATCHES, device)
    for win in PATCH_WINS:
        p_k = brief_cuda.extract_patches(blurred, kp, win)
        p_p = brief_cuda.extract_patches_plain(blurred, kp, win)
        n_diff = int((p_k != p_p).sum())
        if n_diff:
            _fail(f"K3 patches at {win}x{win}: {n_diff} of {p_k.numel()} "
                  f"values differ from the plain version")
        # The library yardstick: one grid_sample call on points built
        # beforehand, as the kernel's are.
        grid = brief_cuda.patch_grid(blurred, kp, win)
        library = lambda: brief_cuda.extract_patches_grid_sample(
            blurred, kp, win, grid)
        lib_err = float((library() - p_p).abs().max())
        if not lib_err <= LIBRARY_TOL:
            _fail(f"K3 patches at {win}x{win}: grid_sample differs from "
                  f"the plain version by {lib_err:.3g} (> {LIBRARY_TOL})")
        t = _timed(lambda: brief_cuda.extract_patches(blurred, kp, win),
                   "patches_kernel")
        ms_p = _call_ms(lambda: brief_cuda.extract_patches_plain(
            blurred, kp, win))
        ms_lib = _device_ms(library)
        # Every keypoint's window of the frame, overlaps once, and every
        # patch written.
        b = _bound(_window_pixels(blurred, kp, win) * 4.0 + N_PATCHES * 8
                   + N_PATCHES * win * win * 4,
                   N_PATCHES * win * win * TAP_OPS)
        print(f"K3 extract_patches@{win}x{win} N={N_PATCHES}: patches "
              f"identical; {_ms_text(t)} vs plain {ms_p:.4f} ms, "
              f"grid_sample {ms_lib:.4f} ms (err {lib_err:.3g}), bound "
              f"{b['bound_us']:.3f} us ({b['bound_by']})")
        rows.append(_entry(f"extract_patches@{win}x{win}", BRIEF_SRC,
                           "vins_tpu/ops/klt_pallas.py:344", 0.0, t, ms_p,
                           b, library_ms=ms_lib, library_err=lib_err,
                           win=win, on_main_path=False))
    return rows


def _reset_counts() -> None:
    """Kernel launch counts to 0, and the marginalization priors' branches
    counted from here (on the device; _read_branches reads them)."""
    from vins_tpu_torch.core import marginalization as marg
    from vins_tpu_torch.ops import brief_cuda, klt_cuda
    klt_cuda.reset_launch_counts()
    brief_cuda.reset_launch_counts()
    marg.count_prior_branches()


def _read_branches() -> dict:
    """How many marginalization priors since _reset_counts took each
    branch of _info_to_sqrt (the ridge Cholesky, the 100x ridge, the
    eigen fallback) and how many Schur complements took a larger ridge
    than _schur's first: one host read at the end of a run; counting
    stops."""
    from vins_tpu_torch.core import marginalization as marg
    out = marg.prior_branches()
    marg.count_prior_branches(False)
    return out


def _branches_text(b: dict) -> str:
    return (f"marginalization priors {b['ridge']} by the ridge Cholesky, "
            f"{b['ridge_100x']} by the 100x ridge, {b['fallback']} by the "
            f"eigen fallback; Schur complements {b['schur_retry']} past the "
            f"first ridge")


def _read_counts() -> dict:
    from vins_tpu_torch.ops import brief_cuda, klt_cuda
    return {"klt_fb_ncc": klt_cuda.track_fb.launches,
            "klt_pyramid": klt_cuda.track_pyramid.launches,
            "patch_ncc": klt_cuda.patch_ncc.launches,
            "brief_raw_words": brief_cuda.extract_brief_raw.launches,
            "brief_words": brief_cuda.extract_brief_words.launches,
            "klt_level": klt_cuda.track_level.launches,
            "extract_patches": brief_cuda.extract_patches.launches}


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


def _mark_segments(sys_, counter: _SyncCounter):
    """Split the counter's record at the start of each dispatch_block and
    of each end-of-stream drain of sys_. Returns finish(), which restores
    the two methods and returns one record per segment: its syncs and the
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

    def finish():
        del sys_.dispatch_block, sys_.drain_loop_work
        ends = [(at, st) for _, at, st in marks[1:]] + [(counter.mark(),
                                                         loop_state())]
        return [dict(kind=kind, syncs=counter.count(at, at_end),
                     hits=st_end[0] - st[0],
                     attach_frames=st_end[1] - st[1],
                     pose_graph_runs=st_end[2] - st[2])
                for (kind, at, st), (at_end, st_end) in zip(marks, ends)]

    return finish


def _stream_counting_syncs(sys_, stream, counter: _SyncCounter,
                           profile_at=None):
    """Run stream() with sys_'s segments marked (_mark_segments) and, with
    profile_at, the cycle of that dispatch profiled (_BlockProfiler);
    returns stream()'s result, the segment records and the profiled
    cycle (None without one)."""
    finish = _mark_segments(sys_, counter)
    prof = _BlockProfiler(sys_, profile_at) if profile_at is not None \
        else None
    try:
        out = stream()
    finally:
        segments = finish()
    return out, segments, prof.result if prof is not None else None


class _BlockProfiler:
    """Record the start of every dispatch_block of sys_, and profile one
    steady-state cycle of the depth-2 stream under torch.profiler (CUDA
    activity only): from the start of dispatch `at` to the start of the
    next, i.e. that dispatch and the sync, keyframe insert and publish of
    the block before it. busy_share is the device time of its kernels,
    copies and sets over the profiled wall (the profiler's own host cost
    is in that wall). Install after _mark_segments: its finish() removes
    both wrappers."""

    def __init__(self, sys_, at: int = 3):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.starts, self.result, self._prof = [], None, None
        dispatch = sys_.dispatch_block

        def call(*args, **kwargs):
            k = len(self.starts)
            if self._prof is not None:
                torch.cuda.synchronize()
                wall = time.perf_counter() - self._t0
                self._prof.__exit__(None, None, None)
                self.result = dict(block=k - 1, wall_s=wall,
                                   busy_s=_device_busy_s(self._prof))
                self.result["busy_share"] = (self.result["busy_s"]
                                             / wall if wall > 0 else None)
                self._prof = None
            self.starts.append(time.perf_counter())
            if k == at:
                torch.cuda.synchronize()
                self._prof = profile(activities=[ProfilerActivity.CUDA])
                self._prof.__enter__()
                self._t0 = time.perf_counter()
            return dispatch(*args, **kwargs)

        sys_.dispatch_block = call


def _unprofiled_rate(frames: int, seconds: float, profiled,
                     block: int) -> float:
    """Block-mode frames/s with the profiled cycle (one block's frames and
    its wall, torch.profiler and its synchronizations included) left out."""
    if profiled is not None:
        frames, seconds = frames - block, seconds - profiled["wall_s"]
    return frames / seconds if seconds > 0 else 0.0


def _device_busy_s(prof) -> float:
    """Seconds of device activity in a torch.profiler trace."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    try:
        events = prof.profiler.kineto_results.events()
        return sum(e.duration_ns() for e in events
                   if e.device_type() == cuda) / 1e9
    except AttributeError:
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == cuda) / 1e6


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
                block: int = BLOCK, max_init_at=None,
                profile_at=None, ate_max=ATE_MAX) -> dict:
    """Drive VinsSystem.process_stream over a rendered sequence, the
    system bootstrapping itself (failing if that takes past frame
    max_init_at); returns the measurements, the initialization attempts
    and the synchronizing CUDA calls per block included, and with
    profile_at the device busy share of that dispatch's cycle. Runs on any
    device (the CPU takes the kernels' plain versions, and launch and
    sync counts stay 0 there). A loop-off run fails at an aligned ATE of
    ate_max or more (None: not gated)."""
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
            outs, segments, profiled = _stream_counting_syncs(
                sys_, lambda: sys_.process_stream(imgs, seq.chunks,
                                                  block=block, ts=ts),
                counter, profile_at=profile_at if on_card else None)
        sync()
    finally:
        stream_mod._attach_loop = attach
        del sys_._initialize_window
    wall = time.perf_counter() - t0
    launches = _read_counts()
    branches = _read_branches()

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
        block_frames_per_s=_unprofiled_rate(n_stream, block_s, profiled,
                                            block),
        blocks=sys_.timings["blocks"], timings=dict(sys_.timings),
        keyframe_syncs_per_block=((sys_.timings["host_syncs"]
                                   - sys_.timings["blocks"])
                                  / max(sys_.timings["blocks"], 1)),
        launches=launches, attach_tries=attach_tries,
        prior_branches=branches, syncs=_sync_summary(segments),
        sync_segments=segments, profiled_cycle=profiled)
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
    elif ate_max is not None and ate >= ate_max:
        _fail(f"aligned ATE RMSE {ate:.4f} m >= {ate_max} m")
    return res


def euroc_phase(device) -> dict:
    """The EuRoC entry point on the card: the port's generate_asl_fixture
    writes tests/test_euroc_path.py's revisit tree (360 frames at 20 Hz,
    seed 9, w = 0.42, bob 0.2, bob_w 1.9; frames rendered on the card,
    distorted 752x480 PNGs) under smoke_out/, then run_euroc.main runs it
    with --stream --global-ba --loop-freq 1. Fails unless the test's gates
    hold (359 frames, a loop hit, the ATE bounds, the keyframe ATE before
    and after the global BA), klt_fb_ncc launched once per tracked frame
    and K3 from the raw frame once per keyframe insert and attach try,
    with no other kernel. Also returns the init frame, block frames/s,
    syncs per block and the device busy share of one profiled
    steady-state cycle. Saves the global BA's harvested problem to
    EUROC_BA_PROBLEM (phase 9). Runs on any device (launch and sync counts
    and the profile only on the card)."""
    import shutil

    import torch
    from vins_tpu_torch import euroc_config, run_euroc
    from vins_tpu_torch import stream as stream_mod
    from vins_tpu_torch.io import euroc as euroc_mod
    from vins_tpu_torch.io.asl_fixture import generate_asl_fixture
    from vins_tpu_torch.parallel import harvest as harvest_mod

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    root = os.path.join("smoke_out", "euroc_fixture")
    out = os.path.join("smoke_out", "euroc_out")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    generate_asl_fixture(root, euroc_config(), n_frames=EUROC_FRAMES,
                         cam_hz=20.0, seed=EUROC_SEED,
                         traj_kwargs=EUROC_TRAJ, device=device)
    fixture_s = time.perf_counter() - t0

    made, hooks = [], {}
    make = run_euroc.VinsSystem
    counter = _SyncCounter(on_card)
    # Seconds spent decoding PNGs and in the end-of-run global BA.
    spent = {"png": 0.0, "global_ba": 0.0}

    def timed(fn, key):
        def call(*args, **kwargs):
            sync()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            spent[key] += time.perf_counter() - t
            return out
        return call

    def system(*args, **kwargs):
        sys_ = make(*args, **kwargs)
        made.append(sys_)
        hooks["finish"] = _mark_segments(sys_, counter)
        if on_card:
            hooks["profiler"] = _BlockProfiler(sys_)
        if sys_.loop is not None:
            sys_.loop.global_ba = timed(sys_.loop.global_ba, "global_ba")
        return sys_

    load_png = euroc_mod.load_gray_png

    attach = stream_mod._attach_loop
    attach_tries = 0

    def counted_attach(*args, **kwargs):
        nonlocal attach_tries
        attach_tries += 1
        return attach(*args, **kwargs)

    # The global BA's problem, kept on the device and saved after the run
    # for phase 9's sharded solves.
    harvest = harvest_mod.harvest_ba_problem
    captured = []

    def capture(*args, **kwargs):
        res = harvest(*args, **kwargs)
        if res is not None:
            captured.append(res)
        return res

    run_euroc.VinsSystem = system
    stream_mod._attach_loop = counted_attach
    euroc_mod.load_gray_png = timed(load_png, "png")
    harvest_mod.harvest_ba_problem = capture
    _reset_counts()
    t0 = time.perf_counter()
    try:
        with counter:
            result = run_euroc.main(
                ["--root", root, "--stream", "--global-ba", "--loop-freq",
                 "1", "--out", out, "--device", str(device)])
        sync()
    finally:
        run_euroc.VinsSystem = make
        stream_mod._attach_loop = attach
        euroc_mod.load_gray_png = load_png
        harvest_mod.harvest_ba_problem = harvest
    wall = time.perf_counter() - t0
    launches = _read_counts()
    branches = _read_branches()
    sys_ = made[0]
    segments = hooks["finish"]()
    prof = hooks.get("profiler")

    gates = [
        ("frames == 359", result["frames"] == EUROC_FRAMES - 1),
        ("ate_rmse present", "ate_rmse" in result),
        ("loop_hits >= 1", result.get("loop_hits", 0) >= 1),
        ("ate_rmse < 0.18", result.get("ate_rmse", 1e9) < EUROC_ATE_MAX),
        ("ate_rmse <= 1.05 ate_rmse_raw + 1e-3",
         result.get("ate_rmse", 1e9)
         <= 1.05 * result.get("ate_rmse_raw", 0.0) + 1e-3),
        ("kf_ate_pre_ba <= 1.02 kf_ate_raw",
         result.get("kf_ate_pre_ba", 1e9)
         <= 1.02 * result.get("kf_ate_raw", 0.0)),
        ("global_ba_cost present",
         result.get("global_ba_cost") is not None),
        ("kf_ate_post_ba <= 1.1 kf_ate_pre_ba + 5e-3",
         result.get("kf_ate_post_ba", 1e9)
         <= 1.1 * result.get("kf_ate_pre_ba", 0.0) + 5e-3),
    ]
    print(f"euroc: {result}")
    failed = [g for g, ok in gates if not ok]
    if failed:
        _fail(f"EuRoC gates failed: {failed} ({result})")
    lc = sys_.loop
    tracked = result["frames"] - 1          # the first frame only detects
    n_brief = lc.n_inserts + attach_tries
    if on_card and (launches["klt_fb_ncc"] != tracked
            or launches["brief_raw_words"] != n_brief
            or launches["brief_words"] or launches["klt_pyramid"]
            or launches["patch_ncc"] or launches["klt_level"]):
        _fail(f"EuRoC launches {launches} for {tracked} tracked frames, "
              f"{lc.n_inserts} keyframe inserts and {attach_tries} attach "
              f"tries")
    if not captured:
        _fail("the EuRoC run's global BA harvested no problem")
    res = captured[-1]
    torch.save({"state": tuple(x.cpu() for x in res.state),
                "prob": tuple(None if x is None else x.cpu()
                              for x in res.prob)}, EUROC_BA_PROBLEM)
    with np.load(os.path.join(out, "run.npz")) as z:
        init_at = int(np.argmax(z["initialized"]))
    n_block = sum(1 for s in segments if s["kind"] == "block")
    block_s = sum(sys_.timings[k] for k in ("dispatch", "sync", "insert",
                                            "publish", "drain"))
    block_frames = result["frames"] - init_at - 1
    cycles = np.diff(prof.starts) if prof is not None else []
    if prof is not None and prof.result is not None:
        cycles = np.delete(cycles, prof.result["block"])
    return dict(
        result=result, wall_s=wall, fixture_s=fixture_s, init_at=init_at,
        png_s=spent["png"], global_ba_s=spent["global_ba"],
        block_frames=block_frames, block_s=block_s,
        block_frames_per_s=_unprofiled_rate(
            block_frames, block_s, prof.result if prof is not None else None,
            EUROC_BLOCK),
        cycle_median_s=float(np.median(cycles)) if len(cycles) else None,
        blocks=n_block, launches=launches, attach_tries=attach_tries,
        prior_branches=branches, keyframes_inserted=lc.n_inserts,
        loop_stats=dict(sys_.loop_stats),
        timings=dict(sys_.timings), syncs=_sync_summary(segments),
        sync_segments=segments,
        profiled_cycle=prof.result if prof is not None else None)


def realtime_phase(cfg, device) -> dict:
    """process_stream(realtime=True) on the loop-off circle with the
    sequence's timestamps and blocks of 12: the bootstrap, then 96 frames
    (8 blocks, 7 cadence checks). Each block runs far over its 0.4 s of
    sensor time, so the solver budget must step from max_iters down to
    min_iters and stay within them; poses must be finite. Returns the
    budget each block ran with and the ATE (not gated). Runs on any
    device."""
    import torch
    from vins_tpu_torch.io import synthetic
    from vins_tpu_torch.pipeline import VinsSystem

    n = N_RT_BOOT + N_RT_AFTER
    seq = synthetic.make_synthetic_sequence(
        cfg, n_frames=n, n_landmarks=300, seed=SEED, frame_dt=1.0 / 30.0,
        traj_kwargs=TRAJ_OFF, imu_per_frame=4, device=device)
    imgs = synthetic.render_sequence_images(seq, cfg, seed=SEED,
                                            device=device)
    sys_ = VinsSystem(cfg, ext=seq.ext, device=device, use_loop=False)
    budgets = []
    dispatch = sys_.dispatch_block

    def logged(*args, **kwargs):
        budgets.append(sys_.solver_budget)
        return dispatch(*args, **kwargs)

    sys_.dispatch_block = logged
    _reset_counts()
    t0 = time.perf_counter()
    outs = sys_.process_stream(imgs, seq.chunks, block=N_RT_BLOCK,
                               ts=seq.timestamps.cpu().numpy(),
                               realtime=True)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    branches = _read_branches()
    del sys_.dispatch_block
    budgets.append(sys_.solver_budget)
    lo, hi = cfg.solver.min_iters, cfg.solver.max_iters
    init_at = next((i for i, o in enumerate(outs) if o.initialized), None)
    if init_at is None:
        _fail("real-time run: the system never initialized")
    est = np.stack([o.p for o in outs[init_at:]])
    if not (all(o.initialized for o in outs[init_at:])
            and np.all(np.isfinite(est))):
        _fail("real-time run: a pose after bootstrap is missing or not "
              "finite")
    if not all(lo <= b <= hi for b in budgets) or min(budgets) != lo:
        _fail(f"real-time run: solver budgets {budgets} leave "
              f"[{lo}, {hi}] or never reach {lo}")
    ate, ate_raw = _ate(est, seq.p.cpu().numpy()[init_at:])
    return dict(frames=n, init_at=init_at, budgets=budgets, wall_s=wall,
                blocks=len(budgets) - 1, ate_rmse_m=ate,
                ate_raw_rmse_m=ate_raw, prior_branches=branches)


def _record_loop_path(sys_, frame) -> tuple:
    """Record, by frame (frame[0]), the interactive path's loop events:
    verify RANSAC runs and their candidates' readouts, hits (frame, old
    DB row), stagings, the backend frames whose solve refined the staged
    edge, and pose-graph runs; and each BRIEF extraction's keypoint
    count on the card (K3 from the raw frame). Returns the record and a
    function that restores ops.brief.extract_brief (the other wrappers
    are the system's and its loop closer's instance attributes)."""
    from vins_tpu_torch.ops import brief as brief_mod
    lc = sys_.loop
    rec = dict(verify=[], hits=[], staged=[], ridden=[], pose_graph=[],
               brief_n=[])
    finish, stage = lc.finish_detect, sys_._stage_loop_from_hit
    refine, optimize = sys_._refine_edge_to_kf, lc.optimize
    extract = brief_mod.extract_brief

    def on_finish(pend, fetched):
        hits = finish(pend, fetched)
        if fetched:
            n = sum(b is not None for b in pend[1])
            n_in, _t, _yaw, good = [np.asarray(x)[:n]
                                    for x in fetched[0][:4]]
            rec["verify"].append((frame[0], n_in.astype(int).tolist(),
                                  good.astype(bool).tolist()))
        rec["hits"] += [(frame[0], h.old_idx) for h in hits
                        if h is not None]
        return hits

    def on_stage(hit, *a, **kw):
        ok = stage(hit, *a, **kw)
        if ok:
            rec["staged"].append(frame[0])
        return ok

    def on_refine(*a, **kw):
        rec["ridden"].append(frame[0])
        return refine(*a, **kw)

    def on_optimize(*a, **kw):
        rec["pose_graph"].append(frame[0])
        return optimize(*a, **kw)

    def on_extract(img, pts, *a, **kw):
        if pts.is_cuda:
            rec["brief_n"].append(int(pts.shape[0]))
        return extract(img, pts, *a, **kw)

    lc.finish_detect = on_finish
    sys_._stage_loop_from_hit = on_stage
    sys_._refine_edge_to_kf = on_refine
    lc.optimize = on_optimize
    brief_mod.extract_brief = on_extract
    return rec, lambda: setattr(brief_mod, "extract_brief", extract)


def interactive_phase(cfg, device, traj: dict, n_frames: int,
                      ground_truth_init: bool = False, revisit: bool = False,
                      ate_max=ATE_MAX, profile_frame=PROFILE_FRAME) -> dict:
    """Drive VinsSystem.process_frame (loop closure on) frame by frame over
    a rendered sequence: bootstrap (from the ground truth with
    ground_truth_init), then the interactive NON_LINEAR path. Returns the
    measurements: the initialization attempts, each frame's wall time by
    kind (boot, a 30 Hz frame with the motion-only solve, a backend
    frame), the motion-only solve's own time (pnp_step) and each keyframe
    insert's (insert and detection), and the loop path's events (verify
    runs, hits, stagings, ridden frames, pose-graph runs). Fails at an
    aligned ATE of ate_max or more (None: not gated); with revisit, fails
    unless a hit is verified, staged and attached, rides a good solve and
    the pose graph runs. Profiles the first backend frame from
    profile_frame on (None: none). Runs on any device."""
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
    sys_ = VinsSystem(cfg, ext=seq.ext, device=device, initializer=(
        synthetic.ground_truth_initializer(seq, cfg) if ground_truth_init
        else None))

    solve_ms, insert_ms = [], []
    profiled = None
    if on_card:
        from torch.profiler import ProfilerActivity, profile

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
    frame = [0]
    loop_rec, unrecord = _record_loop_path(sys_, frame)
    sys_._handle_keyframe = timed(sys_._handle_keyframe, insert_ms)
    frames, outs = [], []
    _reset_counts()
    try:
        with _SyncCounter(on_card) as counter:
            attempts = _record_attempts(sys_, counter, sync)
            sync()
            t_run = time.perf_counter()
            prof = None
            for k in range(n_frames):
                frame[0] = k
                kind = ("boot" if not sys_.initialized else "backend"
                        if sys_.frame_idx % cfg.freq == 0 else "solve")
                if on_card and profile_frame is not None \
                        and profiled is None and prof is None \
                        and k >= profile_frame and kind == "backend":
                    # One backend frame and the two 30 Hz frames after it.
                    prof = profile(activities=[ProfilerActivity.CUDA])
                    prof.__enter__()
                    t_prof, k_prof = time.perf_counter(), k
                n_ins = len(insert_ms)
                t0 = time.perf_counter()
                outs.append(sys_.process_frame(
                    imgs[k], ImuChunk(*[x[k] for x in seq.chunks]),
                    t=float(ts[k])))
                sync()
                frames.append(dict(kind=kind, insert=len(insert_ms) > n_ins,
                                   ms=(time.perf_counter() - t0) * 1e3))
                if prof is not None and k == k_prof + cfg.freq - 1:
                    wall_prof = time.perf_counter() - t_prof
                    prof.__exit__(None, None, None)
                    busy = _device_busy_s(prof)
                    profiled = dict(frames=[k_prof, k], wall_s=wall_prof,
                                    busy_s=busy, busy_share=busy / wall_prof)
                    prof = None
            wall = time.perf_counter() - t_run
    finally:
        pnp_mod.pnp_step = step
        unrecord()
        del sys_._handle_keyframe, sys_._initialize_window
    launches = _read_counts()
    branches = _read_branches()

    init_at = next((i for i, o in enumerate(outs) if o.initialized), None)
    if init_at is None:
        _fail(f"the interactive system never initialized (attempts "
              f"{attempts})")
    post = outs[init_at:]
    if not all(o.initialized for o in post):
        _fail("an interactive output after bootstrap is not initialized "
              f"(statuses {[o.status for o in post if o.status]})")
    est = np.stack([o.p for o in post])
    est_raw = np.stack([o.p_raw for o in post])
    quats = np.stack([o.q for o in post])
    if not (np.all(np.isfinite(est)) and np.all(np.isfinite(quats))):
        _fail("non-finite interactive pose after bootstrap")
    gt = seq.p.cpu().numpy()[init_at:]
    ate, ate_raw = _ate(est, gt)
    ate_nc, _ = _ate(est_raw, gt)
    if ate_max is not None and ate >= ate_max:
        _fail(f"interactive aligned ATE RMSE {ate:.4f} m >= {ate_max} m")
    lc = sys_.loop
    st = dict(sys_.loop_stats)
    if revisit and (st["hits"] < 1 or st["staged"] < 1
                    or st["attached"] < 1 or st["good_frames"] < 1
                    or lc.n_optimizes < 1):
        _fail(f"revisit: no hit verified, staged, attached and ridden, or "
              f"no pose-graph run (loop counters {st}, pose-graph runs "
              f"{lc.n_optimizes}, verify runs {loop_rec['verify']})")
    tracked = n_frames - 1          # frame 0 only detects
    if on_card:
        if launches["klt_fb_ncc"] != tracked:
            _fail(f"interactive: klt_fb_ncc launched "
                  f"{launches['klt_fb_ncc']} times for {tracked} tracked "
                  f"frames")
        if (lc.n_inserts < 1 or launches["brief_raw_words"] != lc.n_inserts
                or len(loop_rec["brief_n"]) != lc.n_inserts
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
    brief_n = loop_rec.pop("brief_n")
    return dict(
        frames=n_frames, traj=dict(traj),
        ground_truth_init=ground_truth_init, init_at=init_at,
        init_attempts=attempts,
        ate_rmse_m=ate, ate_raw_rmse_m=ate_raw,
        ate_rmse_uncorrected_m=ate_nc, wall_s=wall,
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
        keyframes_inserted=lc.n_inserts, loop_stats=st,
        pose_graph_runs=lc.n_optimizes, detect_stats=dict(lc.detect_stats),
        loop_events=loop_rec,
        brief_launches_by_n={n: brief_n.count(n) for n in sorted(set(
            brief_n))},
        launches=launches, prior_branches=branches,
        profiled_frames=profiled)


def _attempts_text(run: dict) -> str:
    return "; ".join(
        f"frame {a['frame']} {a['status']} {a['seconds']:.3f} s "
        f"{a['syncs']} syncs" for a in run["init_attempts"])


def _report_interactive(run: dict, card: str,
                        tag: str = "interactive") -> None:
    print(f"{tag} init: frame {run['init_at']}, "
          f"{len(run['init_attempts'])} attempts: {_attempts_text(run)}; "
          f"{card}")

    def ms(key):
        st = run[key]
        return (f"median {st['median_ms']:.2f} ms (mean {st['mean_ms']:.2f},"
                f" max {st['max_ms']:.2f}, n {st['n']})" if st["n"]
                else "none")

    print(f"{tag}: {run['frames']} frames, init at frame "
          f"{run['init_at']}, ATE {run['ate_rmse_m']:.4f} m aligned, "
          f"{run['ate_raw_rmse_m']:.4f} m raw; {run['frames_per_s']:.2f} "
          f"frames/s end to end, {run['frames_per_s_after_init']:.2f} after "
          f"init; motion-only solve (pnp_step) {ms('pnp_step')}; 30 Hz "
          f"frame {ms('solve_frame')}; backend frame {ms('backend_frame')};"
          f" backend frame with a keyframe insert {ms('insert_frame')}; "
          f"keyframe insert and detection {ms('keyframe_insert')}; boot "
          f"frame {ms('boot_frame')}; {run['keyframes_inserted']} keyframes"
          f" inserted; device busy in frames "
          f"{(run['profiled_frames'] or {}).get('frames')} "
          f"{_busy_text(run['profiled_frames'])}; launches "
          f"{run['launches']}; {_branches_text(run['prior_branches'])}; "
          f"{card}")
    ev = run["loop_events"]
    print(f"{tag} loop path: verify runs (frame, inliers, PnP accepted) "
          f"{ev['verify']}; hits (frame, old row) {ev['hits']}, staged at "
          f"{ev['staged']}, ridden with a good solve at {ev['ridden']}, "
          f"pose graph at {ev['pose_graph']}; counters {run['loop_stats']}; "
          f"ATE drift-corrected {run['ate_rmse_m']:.4f} m, uncorrected "
          f"{run['ate_rmse_uncorrected_m']:.4f} m (aligned); launches "
          f"klt_fb_ncc {run['launches']['klt_fb_ncc']}, K3 from the raw "
          f"frame {run['launches']['brief_raw_words']} (by keypoints "
          f"{run['brief_launches_by_n']}); {card}")


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
             f"syncs); device busy in one steady-state cycle "
             f"{_busy_text(run['profiled_cycle'])}; launches "
             f"{run['launches']}; {_branches_text(run['prior_branches'])}; "
             f"{card}")
    print(line)


def _busy_text(prof) -> str:
    if prof is None or prof.get("busy_share") is None:
        return "not measured"
    return (f"{prof['busy_share']:.4f} ({prof['busy_s']:.3f} s of "
            f"{prof['wall_s']:.3f} s profiled)")


def _report_euroc(run: dict, card: str) -> None:
    sy, r = run["syncs"], run["result"]
    busy = _busy_text(run["profiled_cycle"])
    print(f"euroc: fixture written in {run['fixture_s']:.1f} s; "
          f"{r['frames']} frames in {run['wall_s']:.1f} s (PNG decode "
          f"{run['png_s']:.2f} s, global BA {run['global_ba_s']:.3f} s), "
          f"init at frame "
          f"{run['init_at']}; ATE {r.get('ate_rmse')} m "
          f"({r.get('ate_rmse_raw')} raw), RPE(30) {r.get('rpe_30')}; "
          f"{r.get('loop_hits')} loop hits, {r.get('pose_graph_runs')} "
          f"pose-graph runs; keyframe ATE "
          f"{r.get('kf_ate_raw')} raw, {r.get('kf_ate_pre_ba')} before and "
          f"{r.get('kf_ate_post_ba')} after the global BA (cost "
          f"{r.get('global_ba_cost')}); {run['block_frames_per_s']:.2f} "
          f"frames/s in block mode over {run['block_frames']} frames "
          f"(median cycle {run['cycle_median_s']} s a block, the profiled "
          f"one left out); syncs per block: median {sy['median']}, max "
          f"{sy['max']} (per block {sy['per_block']}, drain {sy['drain']});"
          f" device busy in one steady-state cycle {busy}; "
          f"{run['keyframes_inserted']} keyframes inserted, "
          f"{run['attach_tries']} attach tries, loop {run['loop_stats']}; "
          f"launches {run['launches']}; "
          f"{_branches_text(run['prior_branches'])}; {card}")


def _stream_sequences(cfg, device):
    """N_STREAMS backend streams: stream s bootstrapped from
    make_synthetic_window(seed=s) at the frame interval STREAM_DTS[s % 2]
    and fed, step k, the newest frame of the window that starts k frame
    intervals later (its IMU edge, track ids
    and observations). Returns (states, inputs [T] per stream, ext,
    gravity)."""
    from vins_tpu_torch.core.estimator import BackendState, FrameInput
    from vins_tpu_torch.core.preintegration import ImuChunk
    from vins_tpu_torch.io.synthetic import make_synthetic_window
    from vins_tpu_torch.parallel import stack_inputs

    F = cfg.window.num_frames
    states, seqs = [], []
    for s in range(N_STREAMS):
        dt = STREAM_DTS[s % len(STREAM_DTS)]
        kw = dict(n_landmarks=STREAM_LANDMARKS, noise_px=STREAM_NOISE_PX,
                  frame_dt=dt, device=device)
        w = make_synthetic_window(cfg, seed=s, **kw)
        states.append(BackendState.bootstrap(cfg, w.state, w.feats,
                                             w.chunks, w.ext, w.gravity))
        frames = []
        for k in range(1, N_BATCH_STEPS + 1):
            wk = make_synthetic_window(cfg, seed=s, t0=k * dt, **kw)
            frames.append(FrameInput(
                chunk=ImuChunk(*[x[-1] for x in wk.chunks]),
                ids=wk.feats.track_id, obs=wk.feats.obs[F - 1],
                obs_valid=wk.feats.mask[F - 1] & wk.feats.valid))
        seqs.append(stack_inputs(frames))
    return states, seqs, w.ext, w.gravity


def _batched_part(cfg, device, sync) -> dict:
    """The N_STREAMS streams through make_batched_sequence_runner (N_BATCH_
    STEPS steps, one call), then each alone through run_sequence_scan;
    fails unless both slides occur (a keyframe and a non-keyframe step),
    every stream's keyframe and failure decisions are equal, and its
    poses are within STREAM_STEP1_TOL of its own run at the first step
    and STREAM_POSE_TOL at the later ones. Records each step's largest
    error over the streams."""
    import torch
    from vins_tpu_torch.core.estimator import run_sequence_scan
    from vins_tpu_torch.parallel import (make_batched_sequence_runner,
                                         stack_inputs, stack_states)

    states, seqs, ext, gravity = _stream_sequences(cfg, device)
    run = make_batched_sequence_runner(cfg, ext, gravity)
    sync()
    t0 = time.perf_counter()
    fin_b, out_b = run(stack_states(states), stack_inputs(seqs))
    sync()
    batched_s = time.perf_counter() - t0
    singles, single_s = [], []
    for st, seq in zip(states, seqs):
        sync()
        t0 = time.perf_counter()
        singles.append(run_sequence_scan(st, seq, cfg, ext, gravity))
        sync()
        single_s.append(time.perf_counter() - t0)
    errs = []
    for b, (fin, out) in enumerate(singles):
        same = (torch.equal(out_b.is_keyframe[b], out.is_keyframe)
                and torch.equal(out_b.failure[b], out.failure))
        # [T]: the largest coordinate error at each step.
        err = torch.abs(out_b.pose_p[b] - out.pose_p).amax(-1).tolist()
        if (not same or not err[0] <= STREAM_STEP1_TOL
                or not max(err[1:]) <= STREAM_POSE_TOL):
            _fail(f"batched stream {b}: decisions "
                  f"{out_b.is_keyframe[b].tolist()} / "
                  f"{out_b.failure[b].tolist()} against "
                  f"{out.is_keyframe.tolist()} / {out.failure.tolist()}, "
                  f"pose errors by step {err} m (tolerance "
                  f"{STREAM_STEP1_TOL} at the first, {STREAM_POSE_TOL} "
                  f"after)")
        errs.append(err)
    if not bool(torch.all(torch.isfinite(out_b.pose_p))):
        _fail("batched backend poses are not finite")
    kf = out_b.is_keyframe
    if not (bool(kf.any()) and not bool(kf.all())):
        _fail(f"batched backend: keyframe decisions {kf.tolist()} take "
              f"one slide only")
    step_err = np.max(np.asarray(errs), 0).tolist()
    n = N_STREAMS * N_BATCH_STEPS
    return dict(
        streams=N_STREAMS, steps=N_BATCH_STEPS, batched_s=batched_s,
        step_s=batched_s / N_BATCH_STEPS, frames_per_s=n / batched_s,
        single_s=single_s,
        single_frames_per_s=N_BATCH_STEPS / float(np.median(single_s)),
        frame_dts=[STREAM_DTS[s % len(STREAM_DTS)]
                   for s in range(N_STREAMS)],
        max_pose_err_m=max(step_err), step_pose_err_m=step_err,
        stream_step_pose_err_m=errs,
        keyframes=int(out_b.is_keyframe.sum()),
        failures=int(out_b.failure.sum()))


def _scan_part(cfg, device, sync, on_card: bool) -> dict:
    """bench.py's backend sequence at SCAN_DT (N_SCAN frames after the
    bootstrap) through run_sequence_scan, its synchronizing CUDA calls
    counted, then its first N_SCAN_HOST frames through the host-branch
    backend_step; fails unless the poses are finite, no frame fails,
    both slides occur and the scan matches the host branch."""
    import torch
    from vins_tpu_torch.core.estimator import (_sel, backend_step,
                                               run_sequence_scan, tree_index)
    from vins_tpu_torch.io.synthetic import (build_backend_inputs,
                                             make_synthetic_sequence)

    F = cfg.window.num_frames
    est, inputs, ext, gravity = build_backend_inputs(
        cfg, N_SCAN, seed=0, frame_dt=SCAN_DT, device=device)
    gt = make_synthetic_sequence(cfg, n_frames=F + N_SCAN, n_landmarks=300,
                                 seed=0, noise_px=0.5, frame_dt=SCAN_DT,
                                 device=device).p[F:]
    counter = _SyncCounter(on_card)
    sync()
    t0 = time.perf_counter()
    with counter:
        _, out = run_sequence_scan(est, inputs, cfg, ext, gravity)
        n_sync = counter.count(0)
        sync()
    wall = time.perf_counter() - t0
    host_kf, host_err = [], []
    for t in range(N_SCAN_HOST):
        est2, o = backend_step(est, tree_index(inputs, t), cfg, ext,
                               gravity)
        est = _sel(o.failure, est, est2)
        host_kf.append(bool(o.is_keyframe))
        host_err.append(float(torch.max(torch.abs(o.pose_p
                                                  - out.pose_p[t]))))
    err = torch.linalg.norm(out.pose_p - gt, dim=-1)
    kf = out.is_keyframe
    if (not bool(torch.all(torch.isfinite(out.pose_p)))
            or bool(out.failure.any()) or bool(kf.all())
            or not bool(kf.any())
            or host_kf != kf[:N_SCAN_HOST].tolist()
            or not host_err[0] <= STREAM_STEP1_TOL
            or not max(host_err[1:]) <= STREAM_POSE_TOL):
        _fail(f"sequence scan: failures {out.failure.tolist()}, "
              f"keyframes {kf.tolist()} (the host branch's {host_kf}), "
              f"pose errors against the host branch {host_err} m")
    return dict(frames=N_SCAN, frame_dt=SCAN_DT, wall_s=wall,
                frames_per_s=N_SCAN / wall,
                keyframe_share=float(kf.float().mean()), syncs=n_sync,
                host_frames=N_SCAN_HOST, host_pose_err_m=host_err,
                truth_err_m=err.tolist(), max_err_m=float(err.max()))


def _ba_rank(rank: int, world: int, backend: str, workdir: str,
             device: str, large: dict) -> None:
    """One spawned rank of phase 9's BA world (on `device`): every problem
    of workdir/problems.pt solved with solve_ba_sharded over a (1, world)
    mesh (a warm solve, then a timed one), and the scaling report on the
    map `large` (BA_LARGE) at the block counts the world forms; writes
    ("ok", results) to workdir/rank<rank>.pt, or ("fail", what stopped
    it) before it re-raises."""
    import traceback

    import torch
    import torch.distributed as dist
    path = os.path.join(workdir, f"rank{rank}.pt")
    try:
        out = _ba_rank_work(rank, world, backend, workdir, device, large)
    except BaseException as e:
        torch.save(("fail", f"{e!r}\n{traceback.format_exc()}"), path)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(("ok", out), path)


def _ba_rank_work(rank: int, world: int, backend: str, workdir: str,
                  device: str, large: dict) -> dict:
    import datetime

    import torch
    import torch.distributed as dist
    from vins_tpu_torch.parallel import (BAProblem, BAState, make_mesh,
                                         scaling_report, solve_ba_sharded)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dist.init_process_group(
        backend, init_method="file://" + os.path.abspath(
            os.path.join(workdir, "init")), world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=BA_RANKS_TIMEOUT_S))
    mesh = make_mesh(block=world, device_type=dev.type)
    out = {}
    for name, (st, pr) in torch.load(os.path.join(workdir,
                                                  "problems.pt")).items():
        st = BAState(*(x.to(dev) for x in st))
        pr = BAProblem(*(x.to(dev) for x in pr))
        solve_ba_sharded(st, pr, mesh, iters=BA_ITERS)
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        sol, cost, hist = solve_ba_sharded(st, pr, mesh, iters=BA_ITERS)
        sync()
        out[name] = dict(seconds=time.perf_counter() - t0, p=sol.p.cpu(),
                         cost=float(cost), hist=hist.cpu())
    out["scaling"] = scaling_report(
        blocks=(1, 2, 4), n_poses=large["n_poses"],
        n_landmarks=large["n_landmarks"], iters=BA_ITERS, n_rep=3,
        device_type=dev.type)
    return out


def _ba_problems(device) -> dict:
    """{name: (BAState, BAProblem)} on the device: phase 8's EuRoC problem
    and BA_LARGE with its BA_LARGE_PRIOR_W prior, each with L padded to an
    even count (both worlds' block sizes divide it) and the prior
    materialized."""
    import torch
    from vins_tpu_torch.io.synthetic import make_ba_problem
    from vins_tpu_torch.parallel import BAProblem, BAState
    from vins_tpu_torch.parallel.dist_ba import _materialize_prior
    from vins_tpu_torch.parallel.harvest import pad_landmarks_to

    saved = torch.load(EUROC_BA_PROBLEM)
    euroc = (BAState(*(x.to(device) for x in saved["state"])),
             BAProblem(*(None if x is None else x.to(device)
                         for x in saved["prob"])))
    _, init, prob = make_ba_problem(device=device, **BA_LARGE)
    prob = prob._replace(prior_p=init.p.clone(), prior_w=torch.tensor(
        BA_LARGE_PRIOR_W, device=init.p.device))
    out = {}
    for name, (st, pr) in (("euroc", euroc), ("K64_L2048", (init, prob))):
        st, pr = pad_landmarks_to(st, pr, 2)
        out[name] = (st, _materialize_prior(st, pr))
    return out


def _sharded_ba_part(device, sync) -> dict:
    """Each problem of _ba_problems solved by 2 spawned ranks over gloo on
    this card, by 1 spawned rank over NCCL (gloo off the card), and by
    solve_ba here (the reference, while the ranks start); fails unless
    both worlds end within BA_RANKS_TIMEOUT_S and match the reference:
    the cost within BA_COST_RTOL of it, each pose coordinate within
    BA_POSE_TOL of it."""
    import multiprocessing
    import shutil

    import torch
    from vins_tpu_torch.parallel import solve_ba

    probs = _ba_problems(device)
    shutil.rmtree(SCALE_OUT_DIR, ignore_errors=True)
    on_card = torch.device(device).type == "cuda"
    worlds = {"gloo2": ("gloo", 2), "nccl1": ("nccl" if on_card else "gloo",
                                              1)}
    ctx = multiprocessing.get_context("spawn")
    procs = {}
    for tag, (backend, n) in worlds.items():
        d = os.path.join(SCALE_OUT_DIR, tag)
        os.makedirs(d)
        torch.save({k: (tuple(x.cpu() for x in st),
                        tuple(x.cpu() for x in pr))
                    for k, (st, pr) in probs.items()},
                   os.path.join(d, "problems.pt"))
        procs[tag] = [ctx.Process(target=_ba_rank,
                                  args=(r, n, backend, d, str(device),
                                        BA_LARGE))
                      for r in range(n)]
        for p in procs[tag]:
            p.start()
    ref = {}
    try:
        for name, (st, pr) in probs.items():
            solve_ba(st, pr, iters=BA_ITERS)
            sync()
            t0 = time.perf_counter()
            sol, cost, _ = solve_ba(st, pr, iters=BA_ITERS)
            sync()
            ref[name] = dict(seconds=time.perf_counter() - t0, p=sol.p,
                             cost=float(cost), L=pr.mask.shape[0],
                             K=pr.mask.shape[1])
        deadline = time.monotonic() + BA_RANKS_TIMEOUT_S
        for ps in procs.values():
            for p in ps:
                p.join(max(1.0, deadline - time.monotonic()))
    finally:
        hung = [p for ps in procs.values() for p in ps if p.is_alive()]
        for p in hung:
            p.terminate()
            p.join()
    if hung:
        _fail(f"{len(hung)} BA rank(s) still running after "
              f"{BA_RANKS_TIMEOUT_S} s")
    out = {"solve_ba": {k: dict(seconds=v["seconds"], cost=v["cost"],
                                L=v["L"], K=v["K"])
                        for k, v in ref.items()}}
    for tag, (backend, n) in worlds.items():
        path = os.path.join(SCALE_OUT_DIR, tag, "rank0.pt")
        if not os.path.exists(path):
            _fail(f"BA world {tag}: rank 0 died (exit "
                  f"{procs[tag][0].exitcode})")
        status, res = torch.load(path)
        if status != "ok":
            _fail(f"BA world {tag}: {res}")
        for name, r in ref.items():
            got = res[name]
            err = float(torch.max(torch.abs(got["p"].to(r["p"].device)
                                            - r["p"])))
            if not (abs(got["cost"] - r["cost"])
                    <= BA_COST_RTOL * abs(r["cost"])
                    and err <= BA_POSE_TOL):
                _fail(f"BA world {tag}, {name}: cost {got['cost']} against "
                      f"{r['cost']}, pose error {err} m")
            got["pose_err_m"] = err
            del got["p"], got["hist"]
        out[tag] = res
    K = {k: v["K"] for k, v in ref.items()}
    out["all_reduce_bytes_per_iter"] = {
        k: 4 * ((6 * v) ** 2 + 6 * v + 1) for k, v in K.items()}
    return out


def _lm_iteration_sol(device) -> dict:
    """speed_of_light of one solve_ba LM iteration on BA_LARGE, beside its
    time (CUDA events around 5 iterations after a warm one)."""
    import torch
    from vins_tpu_torch.io.synthetic import make_ba_problem
    from vins_tpu_torch.parallel.dist_ba import (_lm_iteration,
                                                 _materialize_prior)
    from vins_tpu_torch.parallel.scaling import _Clock
    from vins_tpu_torch.utils.profiling import speed_of_light

    _, st, pr = make_ba_problem(device=device, **BA_LARGE)
    pr = _materialize_prior(st, pr)
    lam = torch.tensor(1e-4, device=device)

    def step():
        return _lm_iteration(st, pr, lam)

    step()
    clock = _Clock(torch.device(device))
    clock.start()
    for _ in range(5):
        step()
    measured = clock.stop() / 5
    return dict(speed_of_light(step, measured_s=measured),
                measured_s=measured, L=BA_LARGE["n_landmarks"],
                K=BA_LARGE["n_poses"])


def scale_out_phase(cfg, device, card: str) -> dict:
    """Phase 9: the batched backend (_batched_part), the sequence scan
    (_scan_part) and the sharded BA (_sharded_ba_part), each under a
    StageTimers stage, then the speed of light of one LM iteration at
    L = 2048 and the scaling report of both BA worlds. Prints the first
    two parts as they end (with the card line)."""
    import torch
    from vins_tpu_torch.utils.profiling import StageTimers

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    timers = StageTimers()
    t0 = time.perf_counter()
    with timers.stage("batched backend"):
        batched = _batched_part(cfg, device, sync)
    print(_batched_text(batched) + f"; {card}", flush=True)
    with timers.stage("sequence scan"):
        scan = _scan_part(cfg, device, sync, on_card)
    print(_scan_text(scan) + f"; {card}", flush=True)
    with timers.stage("sharded BA"):
        ba = _sharded_ba_part(device, sync)
    sol = _lm_iteration_sol(device)
    return dict(wall_s=time.perf_counter() - t0, batched=batched, scan=scan,
                ba=ba, lm_iteration_sol=sol, stages=timers.as_dict(),
                stage_report=timers.report())


def _batched_text(b: dict) -> str:
    return (f"scale-out: batched backend, {b['streams']} streams x "
            f"{b['steps']} steps in {b['batched_s']:.2f} s: "
            f"{b['step_s']:.3f} s a batched step, {b['frames_per_s']:.2f} "
            f"backend frames/s in all, against "
            f"{b['single_frames_per_s']:.2f} frames/s for one stream alone; "
            f"{b['keyframes']} keyframe and {b['failures']} failed "
            f"stream-steps; poses against each stream alone, the largest "
            f"error by step: "
            + ", ".join(f"{e:.3g}" for e in b["step_pose_err_m"]) + " m")


def _scan_text(sc: dict) -> str:
    return (f"scale-out: sequence scan, {sc['frames']} frames "
            f"{sc['frame_dt']} s apart in "
            f"{sc['wall_s']:.2f} s ({sc['frames_per_s']:.2f} frames/s), "
            f"keyframe share {sc['keyframe_share']:.3f}, {sc['syncs']} "
            f"synchronizing CUDA calls; the first {sc['host_frames']} "
            f"frames within {max(sc['host_pose_err_m']):.3g} m of the host "
            f"branch; up to {sc['max_err_m']:.4f} m from the truth (not "
            f"gated)")


def _report_scale_out(run: dict, card: str) -> None:
    """The BA, scaling, speed-of-light and stage lines of phase 9 (the
    first two parts printed as they ended)."""
    from vins_tpu_torch.parallel import format_scaling_md

    ba = run["ba"]
    for name, ref in ba["solve_ba"].items():
        print(f"scale-out: BA {name} (K = {ref['K']}, L = {ref['L']}, "
              f"{BA_ITERS} LM iterations): solve_ba {ref['seconds']:.4f} s, "
              f"2 gloo ranks {ba['gloo2'][name]['seconds']:.4f} s, 1 NCCL "
              f"rank {ba['nccl1'][name]['seconds']:.4f} s; cost "
              f"{ref['cost']:.6g}; poses within "
              f"{ba['gloo2'][name]['pose_err_m']:.3g} / "
              f"{ba['nccl1'][name]['pose_err_m']:.3g} m of solve_ba's; "
              f"all_reduce "
              f"{ba['all_reduce_bytes_per_iter'][name]} B an iteration; "
              f"{card}")
    for tag in ("gloo2", "nccl1"):
        print(format_scaling_md(ba[tag]["scaling"],
                                f"scale-out: scaling report, {tag} world "
                                f"(K = {BA_LARGE['n_poses']}, L = "
                                f"{BA_LARGE['n_landmarks']}; {card})"))
    sol = run["lm_iteration_sol"]
    print(f"scale-out: one solve_ba LM iteration at L = {sol['L']}: "
          f"{sol['measured_s'] * 1e3:.3f} ms, bound "
          f"{sol['t_bound_s'] * 1e3:.4f} ms ({sol['flops']:.4g} flops, "
          f"{sol['bytes']:.4g} bytes), {sol['sol_fraction']:.4f} of speed "
          f"of light; {card}")
    print("scale-out: stages\n" + run["stage_report"])
    print(f"scale-out: phase wall {run['wall_s']:.1f} s; {card}")


def _track_errors(cfg, seq, imgs, device) -> dict:
    """FeatureTracker over frames 0 and 1; the tracked points' distance
    to the renderer's exact correspondence (ground_truth_correspondence)
    and klt_fb_ncc's launches."""
    from vins_tpu_torch.frontend.tracker import FeatureTracker
    from vins_tpu_torch.io.synthetic import ground_truth_correspondence

    tracker = FeatureTracker(cfg, device=device)
    _reset_counts()
    out0 = tracker.process(imgs[0])
    out1 = tracker.process(imgs[1])
    launches = _read_counts()
    ids0, v0, p0, ids1, v1, p1 = (x.cpu().numpy() for x in (
        out0.ids, out0.obs_valid, out0.pts_px, out1.ids, out1.obs_valid,
        out1.pts_px))
    common, ia, ib = np.intersect1d(ids0[v0], ids1[v1], return_indices=True)
    expect = ground_truth_correspondence(seq, cfg, p0[v0][ia], 0, 1)
    err = np.linalg.norm(p1[v1][ib] - expect, axis=-1)
    return dict(levels=cfg.frontend.pyramid_levels, common=int(len(common)),
                median_px=float(np.median(err)) if len(err) else None,
                near_share=float((err < GEOM_FAR_PX).mean()) if len(err)
                else 0.0, max_px=float(err.max()) if len(err) else None,
                launches=launches)


def _domain_geometry(cfg, seq, imgs, device) -> dict:
    """_track_errors at DOMAIN_PATH's window and depth (not gated) and, on
    the card, the klt_fb_ncc launch the tracker made held against its
    plain version on the same inputs (_check_fb; fails otherwise)."""
    import types

    import torch
    from vins_tpu_torch.ops import klt as klt_mod
    from vins_tpu_torch.ops import klt_cuda

    calls = []

    def recorded(*args):
        calls.append(args)
        return klt_cuda.track_fb(*args)

    win, levels = DOMAIN_PATH
    klt_mod.klt_cuda = types.SimpleNamespace(**dict(vars(klt_cuda),
                                                    track_fb=recorded))
    try:
        out = _track_errors(_with_window(cfg, win, levels), seq, imgs,
                            device)
    finally:
        klt_mod.klt_cuda = klt_cuda
    if torch.device(device).type == "cuda":
        if len(calls) != 1 or out["launches"]["klt_fb_ncc"] != 1:
            _fail(f"geometry at {DOMAIN_PATH}: {len(calls)} tracking calls, "
                  f"launches {out['launches']}")
        chk = _check_fb(calls[0], f"klt_fb_ncc in the tracker at "
                        f"{DOMAIN_PATH}", ncc_tol=NCC_TOL_DOMAIN)
        out["against_plain"] = {k: v for k, v in chk.items() if k != "out"}
    return out


def _geometry_part(cfg, device) -> dict:
    """tests/test_frontend.py's fixture at 4 levels, rendered on the
    device, gated on that test's bounds; the same frames at DOMAIN_PATH
    (the card against the plain version gated, the distances not); then
    frames 0-1 of the demo's 30 Hz sequence at cfg (3 levels), not
    gated."""
    import dataclasses

    import torch
    from vins_tpu_torch import run_synthetic
    from vins_tpu_torch.io import synthetic

    on_card = torch.device(device).type == "cuda"
    cfg4 = dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, pyramid_levels=4))
    seq = synthetic.make_synthetic_sequence(
        cfg4, n_frames=GEOM_FRAMES, n_landmarks=GEOM_LANDMARKS,
        seed=GEOM_SEED, traj_kwargs=GEOM_TRAJ, device=device)
    imgs = synthetic.render_sequence_images(seq, cfg4, seed=GEOM_SEED,
                                            device=device)
    fixture = _track_errors(cfg4, seq, imgs, device)
    ok = (fixture["common"] >= GEOM_COMMON_MIN
          and fixture["median_px"] < GEOM_MEDIAN_MAX
          and fixture["near_share"] > GEOM_NEAR_SHARE)
    if not ok:
        _fail(f"tracking against exact geometry: {fixture} (bounds: "
              f">= {GEOM_COMMON_MIN} common, median < {GEOM_MEDIAN_MAX} px,"
              f" > {GEOM_NEAR_SHARE} under {GEOM_FAR_PX} px)")
    if on_card and fixture["launches"]["klt_fb_ncc"] != 1:
        _fail(f"geometry: launches {fixture['launches']} for 1 tracked "
              f"frame")
    seq30 = synthetic.make_synthetic_sequence(
        cfg, n_frames=2, n_landmarks=60, seed=run_synthetic.SEED,
        frame_dt=1.0 / 30.0, traj_kwargs=dict(w=0.35, bob=0.15),
        imu_per_frame=4, device=device)
    imgs30 = synthetic.render_sequence_images(seq30, cfg,
                                              seed=run_synthetic.SEED,
                                              device=device)
    return dict(fixture=fixture,
                domain=_domain_geometry(cfg4, seq, imgs, device),
                demo_30hz=_track_errors(cfg, seq30, imgs30, device))


def _png_rgb(path: str):
    """(width, height, RGB uint8 [H, W, 3]) of a PNG run_synthetic wrote
    (8-bit RGB, filter 0 rows); fails on anything else."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        _fail(f"{path} is not a PNG")
    W, H, depth, color = struct.unpack(">IIBB", data[16:26])
    pos, idat = 8, b""
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    rows = raw.reshape(H, 1 + 3 * W)
    if (depth, color) != (8, 2) or rows[:, 0].any():
        _fail(f"{path}: not the writer's 8-bit RGB with filter-0 rows")
    return W, H, rows[:, 1:].reshape(H, W, 3)


def _demo_part(device) -> dict:
    """run_synthetic.main(--frames 120 --loop) on the device: it must
    return 0 and initialize, its poses after initialization be finite,
    both PNGs valid at 640x640 and 640x480 with pixels other than their
    background, klt_fb_ncc launch once per tracked frame and K3 from the
    raw frame once per keyframe insert (at least one), no other kernel."""
    import torch
    from vins_tpu_torch import run_synthetic
    from vins_tpu_torch.viz.renderer import TrajectoryRenderer

    on_card = torch.device(device).type == "cuda"
    runs = []
    run = run_synthetic.run

    def capture(*args, **kwargs):
        r = run(*args, **kwargs)
        runs.append(r)
        return r

    run_synthetic.run = capture
    _reset_counts()
    t0 = time.perf_counter()
    try:
        rc = run_synthetic.main(["--frames", str(DEMO_FRAMES), "--loop",
                                 "--out", DEMO_OUT, "--device", str(device)])
    finally:
        run_synthetic.run = run
    wall = time.perf_counter() - t0
    launches = _read_counts()
    branches = _read_branches()
    if rc != 0 or not runs:
        _fail(f"the demo returned {rc}")
    r = runs[0]
    init_at = run_synthetic.init_frame(r.outs)
    if init_at is None:
        _fail("the demo never initialized")
    post = r.outs[init_at:]
    est = np.stack([o.p for o in post])
    quats = np.stack([o.q for o in post])
    if not (all(o.initialized for o in post) and np.all(np.isfinite(est))
            and np.all(np.isfinite(quats))):
        _fail("the demo has an uninitialized or non-finite pose after "
              "initialization")
    ate, ate_raw = _ate(est, r.seq.p.cpu().numpy()[init_at:])

    cam = r.system.cfg.camera
    W, H, traj = _png_rgb(os.path.join(DEMO_OUT, "trajectory.png"))
    view = TrajectoryRenderer()
    background = int(np.float32(0.08) * 255)
    if (W, H) != (view.W, view.H) or not (traj != background).any():
        _fail(f"trajectory.png is {W}x{H} or holds only the background")
    W, H, ar = _png_rgb(os.path.join(DEMO_OUT, "ar_overlay.png"))
    frame = (np.clip(r.imgs[-1].cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    if (W, H) != (cam.width, cam.height) or not (
            ar != frame[:, :, None]).any():
        _fail(f"ar_overlay.png is {W}x{H} or holds only the frame")

    lc = r.system.loop
    tracked = DEMO_FRAMES - 1       # frame 0 only detects
    if on_card and (launches["klt_fb_ncc"] != tracked or lc.n_inserts < 1
                    or launches["brief_raw_words"] != lc.n_inserts
                    or launches["brief_words"] or launches["klt_pyramid"]
                    or launches["patch_ncc"] or launches["klt_level"]):
        _fail(f"demo launches {launches} for {tracked} tracked frames and "
              f"{lc.n_inserts} keyframe inserts")
    after = r.frame_s[init_at + 1:]
    return dict(frames=DEMO_FRAMES, rc=rc, init_at=init_at, ate_rmse_m=ate,
                ate_raw_rmse_m=ate_raw, wall_s=wall,
                frames_per_s_after_init=len(after) / sum(after),
                keyframes_inserted=lc.n_inserts, loop_hits=lc.n_loops,
                launches=launches, prior_branches=branches)


def _sensor_events(t_end=1.0, accel_hz=100.0, gyro_hz=97.0, img_hz=10.0):
    """tests/test_native_runtime.py's event stream: accel at 100 Hz, gyro
    at 97 Hz, images at 10 Hz, in time order."""
    t_a = np.arange(0.0, t_end, 1.0 / accel_hz)
    t_g = np.arange(0.0005, t_end, 1.0 / gyro_hz)
    t_i = np.arange(0.105, t_end - 0.05, 1.0 / img_hz)
    acc = np.stack([np.sin(3 * t_a), np.cos(2 * t_a), 9.8 + 0.1 * t_a], 1)
    gyr = np.stack([0.1 * t_g, np.cos(t_g), np.sin(t_g)], 1)
    events = ([("a", t, acc[i]) for i, t in enumerate(t_a)]
              + [("g", t, gyr[i]) for i, t in enumerate(t_g)]
              + [("i", t, None) for t in t_i])
    events.sort(key=lambda e: e[1])
    return events


def _feed(sync, events):
    out, img_id = [], 0
    for kind, t, v in events:
        if kind == "a":
            sync.push_accel(t, v)
        elif kind == "g":
            sync.push_gyro(t, v)
        else:
            sync.push_image(t, img_id)
            img_id += 1
        r = sync.poll()
        while r is not None:
            out.append(r)
            r = sync.poll()
    return out


def _runtime_part(device) -> dict:
    """The port's NativeStreamSync (native/runtime.cpp built with g++
    into vins_tpu_torch/_build/) against its StreamSync, both on the
    device, on tests/test_native_runtime.py's stream with that test's
    bounds; every chunk on the device."""
    import torch
    from vins_tpu_torch.io.native_runtime import NativeStreamSync, StreamSync

    events = _sensor_events()
    t0 = time.perf_counter()
    sync = NativeStreamSync(32, device=device)      # builds and loads
    open_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native = _feed(sync, events)
    native_s = time.perf_counter() - t0
    sync.close()
    t0 = time.perf_counter()
    python = _feed(StreamSync(32, device=device), events)
    python_s = time.perf_counter() - t0
    dev = torch.device(device)
    if len(native) != len(python) or len(native) < 7:
        _fail(f"native runtime: {len(native)} chunks, Python {len(python)}")
    worst = dict(t=0.0, dt=0.0, acc=0.0, gyr=0.0)
    for (ia, ta, ca), (ib, tb, cb) in zip(native, python):
        if ia != ib:
            _fail(f"native runtime: image id {ia} against {ib}")
        if any(x.device != dev for x in (*ca, *cb)):
            _fail(f"native runtime: a chunk is not on {dev}")
        worst["t"] = max(worst["t"], abs(ta - tb))
        for k in ("dt", "acc", "gyr"):
            worst[k] = max(worst[k], float(torch.max(torch.abs(
                getattr(ca, k) - getattr(cb, k)))))
    bounds = dict(t=1e-12, dt=1e-6, acc=1e-5, gyr=1e-5)
    if any(worst[k] > bounds[k] for k in bounds):
        _fail(f"native runtime differs from StreamSync: {worst}")
    return dict(chunks=len(native), events=len(events), max_err=worst,
                open_s=open_s, native_s=native_s, python_s=python_s)


def _loader_part(device, root: str) -> dict:
    """The native prefetcher over every PNG of the ASL tree at `root`
    (4 workers, queue_cap 2) under a LOADER_TIMEOUT_S watchdog, each frame
    equal to euroc.load_gray_png's; then run_euroc --native-loader --stream
    --no-loop over NATIVE_EUROC_FRAMES of it: initialized, finite poses,
    klt_fb_ncc once per tracked frame and no other kernel. Returns
    {"skipped": reason} where the host has no zlib headers."""
    import threading

    import torch
    from vins_tpu_torch import run_euroc
    from vins_tpu_torch.io import euroc, native_build
    from vins_tpu_torch.io.native_loader import PrefetchingImageLoader

    on_card = torch.device(device).type == "cuda"
    try:
        native_build.build("vinsloader")
    except native_build.BuildError as e:
        if "zlib.h" not in str(e):
            raise
        return dict(skipped="no zlib headers on this host: the native "
                            "loader cannot be built")
    data = euroc.load_euroc(root)
    paths = data.cam_files
    first = euroc.load_gray_png(paths[0])
    H, W = first.shape
    t0 = time.perf_counter()
    ref = [first] + [euroc.load_gray_png(p) for p in paths[1:]]
    python_s = time.perf_counter() - t0

    got, failed = [], []

    def drain():
        try:
            loader = PrefetchingImageLoader(paths, W, H,
                                            n_workers=LOADER_WORKERS,
                                            queue_cap=LOADER_QUEUE_CAP)
            got.extend(loader)
            loader.close()
        except Exception as e:          # reported below, by the main thread
            failed.append(repr(e))

    t0 = time.perf_counter()
    th = threading.Thread(target=drain, daemon=True)
    th.start()
    th.join(LOADER_TIMEOUT_S)
    native_s = time.perf_counter() - t0
    if th.is_alive():
        _fail(f"the native prefetcher did not finish {len(paths)} frames "
              f"in {LOADER_TIMEOUT_S} s ({len(got)} delivered)")
    if failed or len(got) != len(ref):
        _fail(f"native prefetcher: {len(got)} of {len(ref)} frames {failed}")
    bad = [i for i, (a, b) in enumerate(zip(got, ref))
           if not np.array_equal(a, b)]
    if bad:
        _fail(f"native prefetcher: frames {bad[:10]} differ from "
              f"load_gray_png's")

    out = os.path.join("smoke_out", "euroc_native_out")
    _reset_counts()
    t0 = time.perf_counter()
    result = run_euroc.main(["--root", root, "--native-loader", "--stream",
                             "--no-loop", "--frames",
                             str(NATIVE_EUROC_FRAMES), "--out", out,
                             "--device", str(device)])
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    branches = _read_branches()
    with np.load(os.path.join(out, "run.npz")) as z:
        init = z["initialized"]
        p, q = z["p"], z["q"]
    if result["frames"] != NATIVE_EUROC_FRAMES - 1 or not init.any():
        _fail(f"run_euroc --native-loader: {result}, initialized "
              f"{bool(init.any())}")
    init_at = int(np.argmax(init))
    if not (init[init_at:].all() and np.all(np.isfinite(p[init_at:]))
            and np.all(np.isfinite(q[init_at:]))):
        _fail("run_euroc --native-loader: a non-finite or uninitialized "
              "pose after initialization")
    tracked = result["frames"] - 1
    if on_card and (launches["klt_fb_ncc"] != tracked
                    or any(v for k, v in launches.items()
                           if k != "klt_fb_ncc")):
        _fail(f"run_euroc --native-loader launches {launches} for "
              f"{tracked} tracked frames")
    return dict(frames=len(paths), width=W, height=H, python_s=python_s,
                native_s=native_s, workers=LOADER_WORKERS,
                queue_cap=LOADER_QUEUE_CAP,
                euroc=dict(result=result, init_at=init_at, wall_s=wall,
                           launches=launches, prior_branches=branches))


def last_slice_phase(cfg, device) -> dict:
    """Phase 10: tracking against exact geometry, the demo, the native
    sensor runtime and the native loader with run_euroc --native-loader
    (on phase 8's ASL tree). Runs on any device (launch counts only on
    the card)."""
    t0 = time.perf_counter()
    parts = {}
    for name, fn in (("geometry", lambda: _geometry_part(cfg, device)),
                     ("demo", lambda: _demo_part(device)),
                     ("runtime", lambda: _runtime_part(device)),
                     ("loader", lambda: _loader_part(
                         device, os.path.join("smoke_out",
                                              "euroc_fixture")))):
        t = time.perf_counter()
        parts[name] = fn()
        parts[name]["part_s"] = time.perf_counter() - t
    parts["wall_s"] = time.perf_counter() - t0
    return parts


def _report_last_slice(run: dict, card: str) -> None:
    g = run["geometry"]
    for tag, e in (("fixture (test_frontend, 4 levels, gated)",
                    g["fixture"]),
                   (f"fixture at window {DOMAIN_PATH[0]}, {DOMAIN_PATH[1]} "
                    f"levels (not gated; card against plain "
                    f"{g['domain'].get('against_plain')})", g["domain"]),
                   ("demo 30 Hz sequence (3 levels, not gated)",
                    g["demo_30hz"])):
        print(f"last-slice geometry, {tag}: frames 0->1, {e['common']} "
              f"common tracks, median error {e['median_px']:.4f} px, "
              f"{e['near_share']:.4f} under {GEOM_FAR_PX} px, max "
              f"{e['max_px']:.4f} px; {card}")
    d = run["demo"]
    print(f"last-slice demo: run_synthetic --frames {d['frames']} --loop "
          f"returned {d['rc']}, init at frame {d['init_at']}, ATE "
          f"{d['ate_rmse_m']:.4f} m aligned (not gated), "
          f"{d['frames_per_s_after_init']:.2f} frames/s after init, "
          f"{d['keyframes_inserted']} keyframe inserts, wall "
          f"{d['wall_s']:.1f} s; launches {d['launches']}; "
          f"{_branches_text(d['prior_branches'])}; {card}")
    rt = run["runtime"]
    print(f"last-slice runtime: {rt['chunks']} chunks from {rt['events']} "
          f"events, native {rt['native_s']:.4f} s (build and load "
          f"{rt['open_s']:.3f} s before it), Python {rt['python_s']:.4f} s,"
          f" max differences {rt['max_err']}; {card}")
    ld = run["loader"]
    if "skipped" in ld:
        print(f"last-slice loader: not run: {ld['skipped']}")
    else:
        eu = ld["euroc"]
        print(f"last-slice loader: {ld['frames']} PNGs "
              f"{ld['width']}x{ld['height']}, Python decoder "
              f"{ld['python_s']:.3f} s, native prefetcher "
              f"({ld['workers']} workers, queue {ld['queue_cap']}) "
              f"{ld['native_s']:.3f} s, frames equal; run_euroc "
              f"--native-loader: {eu['result']['frames']} frames, init at "
              f"frame {eu['init_at']}, {eu['wall_s']:.1f} s, launches "
              f"{eu['launches']}; {_branches_text(eu['prior_branches'])}; "
              f"{card}")
    print(f"last-slice: phase wall {run['wall_s']:.1f} s (geometry "
          f"{g['part_s']:.1f}, demo {d['part_s']:.1f}, runtime "
          f"{rt['part_s']:.1f}, loader {ld['part_s']:.1f}); {card}")


def domain_slice_phase(cfg, device) -> dict:
    """Phase 11: the system at DOMAIN_PATH's window and depth (cfg's
    frontend otherwise), loop off, over N_FRAMES_DOMAIN frames of the
    w = 0.35 circle: it must initialize, give finite poses and launch the
    runtime-window klt_fb_ncc once per tracked frame (slice_phase's
    gates); its aligned ATE is recorded, not gated (the JAX package's
    config notes record 4 levels tracking worse than 3)."""
    win, levels = DOMAIN_PATH
    return slice_phase(_with_window(cfg, win, levels), device, False,
                       TRAJ_OFF, N_FRAMES_DOMAIN, ate_max=None)


def revisit_phase(cfg, device) -> dict:
    """Phase 13: interactive_phase over REVISIT_TRAJ from a ground-truth
    bootstrap: fails unless a hit is verified, staged and attached, rides
    a good window solve and the pose graph runs; klt_fb_ncc once per
    tracked frame and K3 from the raw frame once per keyframe insert
    (interactive_phase's gates)."""
    return interactive_phase(cfg, device, REVISIT_TRAJ, N_FRAMES_REVISIT,
                             ground_truth_init=True, revisit=True,
                             ate_max=None, profile_frame=None)


def _loop_on_child(path: str, device: str) -> None:
    """Phases 4, 11 and 13 in a child process: pickles ("ok",
    (slice_phase's result, domain_slice_phase's, revisit_phase's)) or
    ("fail", what stopped it) to path."""
    import pickle
    import traceback

    import torch
    from vins_tpu_torch import default_config
    try:
        dev = torch.device(device)
        loop = slice_phase(default_config(), dev, True, TRAJ_LOOP,
                           N_FRAMES_LOOP, max_init_at=N_BOOT_MAX - 1,
                           profile_at=PROFILE_AT)
        dom = domain_slice_phase(default_config(), dev)
        out = ("ok", (loop, dom, revisit_phase(default_config(), dev)))
    except BaseException as e:      # _fail exits with SystemExit
        out = ("fail", f"{e!r}\n{traceback.format_exc()}")
    with open(path, "wb") as f:
        pickle.dump(out, f)


def _start_loop_on(device: str):
    """Start phases 4, 11 and 13 in a spawned process; returns (process,
    result path)."""
    import multiprocessing
    os.makedirs("smoke_out", exist_ok=True)
    path = os.path.join("smoke_out", "loop_on.pkl")
    if os.path.exists(path):
        os.remove(path)
    proc = multiprocessing.get_context("spawn").Process(
        target=_loop_on_child, args=(path, device))
    proc.start()
    return proc, path


def _join_loop_on(proc, path: str) -> tuple:
    """Wait for the process of phases 4, 11 and 13 (at most
    LOOP_ON_TIMEOUT_S) and return their results; fails if it failed, died
    or ran over."""
    import pickle
    proc.join(LOOP_ON_TIMEOUT_S)
    if proc.is_alive():
        proc.terminate()
        proc.join()
        _fail(f"the loop-on, domain and revisit runs took over "
              f"{LOOP_ON_TIMEOUT_S} s")
    if not os.path.exists(path):
        _fail(f"the loop-on run's process died (exit {proc.exitcode})")
    with open(path, "rb") as f:
        status, out = pickle.load(f)
    if status != "ok":
        _fail(f"loop-on run: {out}")
    return out


def _start_card_tests() -> tuple:
    """Start phase 12: the card's parity tests (CARD_TEST_ARGS on
    CARD_TEST_FILES, JAX not needed) in one pytest process per entry of
    CARD_TEST_GROUPS, all at once, each one's report in
    smoke_out/<name>.xml and its output in smoke_out/<name>.log. Returns
    ([(process, report path, log path), ...], start time)."""
    os.makedirs("smoke_out", exist_ok=True)
    runs = []
    for name, files in CARD_TEST_GROUPS:
        xml = os.path.join("smoke_out", name + ".xml")
        log = os.path.join("smoke_out", name + ".log")
        if os.path.exists(xml):
            os.remove(xml)
        with open(log, "w") as out:
            runs.append((subprocess.Popen(
                [sys.executable, "-m", "pytest", *CARD_TEST_ARGS,
                 f"--junitxml={xml}", *files], stdout=out,
                stderr=subprocess.STDOUT), xml, log))
    return runs, time.perf_counter()


def _join_card_tests(run: tuple) -> dict:
    """Wait for phase 12's processes (at most CARD_TESTS_TIMEOUT_S from
    their start); fails unless each pytest exits 0 and every collected
    case passed, none skipped. A process that runs over is killed."""
    import xml.etree.ElementTree as ET
    runs, t0 = run
    passed, text = 0, ""
    for proc, xml, log in runs:
        try:
            rc = proc.wait(timeout=max(
                1.0, CARD_TESTS_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for p, _, _ in runs:
                p.kill()
                p.wait()
            _fail(f"the card tests took over {CARD_TESTS_TIMEOUT_S} s")
        with open(log) as f:
            out = f.read()
        tail = out[-3000:]
        if not os.path.exists(xml):
            _fail(f"the card tests wrote no report (pytest exit {rc}):\n"
                  f"{tail}")
        root = ET.parse(xml).getroot()
        suite = root if root.tag == "testsuite" else root.find("testsuite")
        n = {k: int(suite.get(k, 0))
             for k in ("tests", "failures", "errors", "skipped")}
        if rc != 0 or n["tests"] == 0 or n["failures"] or n["errors"] \
                or n["skipped"]:
            _fail(f"the card tests: pytest exit {rc}, {n}:\n{tail}")
        passed += n["tests"]
        text += out
    first = lambda head: next((line for line in text.splitlines()
                               if line.startswith(head)), None)
    return dict(passed=passed, seconds=time.perf_counter() - t0,
                files=list(CARD_TEST_FILES),
                stream=first("card against CPU"),
                revisit=first("revisit, card against CPU"))


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

    from vins_tpu_torch import default_config, euroc_config
    from vins_tpu_torch.ops import native

    t0 = time.perf_counter()
    # Seconds from here to the end of each part of the run.
    timeline = {}
    mark = lambda part: timeline.setdefault(part, time.perf_counter() - t0)
    native.library()
    report["build"] = dict(native.build_info,
                           load_s=time.perf_counter() - t0)
    print(f"build: {report['build']['seconds']:.1f} s nvcc "
          f"({time.perf_counter() - t0:.1f} s to load)")
    mark("build")

    cfg = default_config()
    device = torch.device("cuda", 0)
    kernels = kernel_phase(cfg, device)
    kernels_euroc = euroc_kernel_phase(euroc_config(), device)
    kernels_domain = domain_kernel_phase(cfg, device)
    mark("kernel phases")

    run_cards = _join_card_tests(_start_card_tests())
    mark("card tests")
    print(f"card tests: {run_cards['passed']} gpu cases of "
          f"{', '.join(CARD_TEST_FILES)} passed on the card without JAX, "
          f"none skipped, in {run_cards['seconds']:.1f} s; the stream at "
          f"klt_eps 0.01: {run_cards['stream']}; the revisit: "
          f"{run_cards['revisit']}; {card}")

    from vins_tpu_torch.core import marginalization as marg
    print(f"marginalization: every bootstrap prior held at "
          f"{marg.BOOT_HOLD:g} of its largest diagonal entry in every "
          f"direction, every dropped block ridged at "
          f"{marg.SCHUR_RIDGES[0]:g} of its unit diagonal, then "
          f"{', '.join(f'{r:g}' for r in marg.SCHUR_RIDGES[1:])} where that "
          f"factorization fails (constants of core/marginalization.py, the "
          f"same in every run below)")
    proc, loop_path = _start_loop_on(str(device))
    try:
        run_eu = euroc_phase(device)
        _report_euroc(run_eu, card)
        run_so = scale_out_phase(cfg, device, card)
        _report_scale_out(run_so, card)
        run_last = last_slice_phase(cfg, device)
        _report_last_slice(run_last, card)
        run_off = slice_phase(cfg, device, False, TRAJ_OFF, N_FRAMES_OFF,
                              max_init_at=INIT_AT_MAX_OFF)
        _report_run("loop-off", run_off, card)
        run_rt = realtime_phase(cfg, device)
        print(f"realtime: {run_rt['frames']} frames in blocks of "
              f"{N_RT_BLOCK}, init at frame {run_rt['init_at']}, solver "
              f"budget per block {run_rt['budgets'][:-1]} then "
              f"{run_rt['budgets'][-1]}, ATE {run_rt['ate_rmse_m']:.4f} m "
              f"aligned (not gated), {run_rt['wall_s']:.1f} s; "
              f"{_branches_text(run_rt['prior_branches'])}; {card}")
        run_int = interactive_phase(cfg, device, TRAJ_OFF,
                                    N_FRAMES_INTERACTIVE)
        _report_interactive(run_int, card)
        mark("phases 8-10, 5-7")
        run_loop, run_dom, run_rev = _join_loop_on(proc, loop_path)
        mark("loop-on child (4, 11, 13)")
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join()
    _report_run("loop", run_loop, card)
    _report_run(f"domain (window {DOMAIN_PATH[0]}, {DOMAIN_PATH[1]} "
                f"levels, loop off)", run_dom, card)
    _report_interactive(run_rev, card, tag="revisit")

    for k in kernels:
        k["launches"] = run_loop["launches"][k["name"]]
        k["launches_loop_off"] = run_off["launches"][k["name"]]
        k["launches_interactive"] = run_int["launches"][k["name"]]
        k["launches_revisit"] = run_rev["launches"][k["name"]]
        k["launches_demo"] = run_last["demo"]["launches"][k["name"]]
    native_eu = run_last["loader"].get("euroc")
    for k in kernels_euroc:
        k["launches"] = run_eu["launches"][k["name"].split("@")[0]]
        k["launches_path"] = "euroc"
        k["launches_native_loader"] = (
            native_eu["launches"][k["name"].split("@")[0]]
            if native_eu else None)
    for k in kernels_domain:
        on_path = (k.get("win"), k.get("levels")) == DOMAIN_PATH
        k["launches"] = (run_dom["launches"][k["name"].split("@")[0]]
                         if on_path else 0)
        k["launches_path"] = "domain"
    kernels = kernels + kernels_euroc + kernels_domain
    report["loop"], report["loop_off"] = run_loop, run_off
    report["domain"] = run_dom
    report["realtime"], report["euroc"] = run_rt, run_eu
    report["scale_out"] = run_so
    report["last_slice"] = run_last
    report["interactive"] = run_int
    report["revisit"] = run_rev
    report["card_tests"] = run_cards
    report["kernels"] = kernels
    mark("end")
    report["timeline_s"] = timeline
    print("timeline (s from the build's start to each part's end): "
          + ", ".join(f"{k} {v:.1f}" for k, v in timeline.items()))
    os.makedirs("smoke_out", exist_ok=True)
    with open(os.path.join("smoke_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
