"""Typed configuration for the PyTorch/CUDA port of the VIO/SLAM engine.

A field-for-field copy of vins_tpu/config.py (importing that module would
run vins_tpu/__init__.py, which imports jax). tests/test_torch_ops.py
asserts dataclasses.asdict equality with the JAX package's config so the
two copies cannot drift.

Replaces the reference's three-tier config (compile-time #defines in
VINS_ios/global_param.hpp:23-53, per-device runtime table in
VINS_ios/global_param.cpp:24-132, and runtime toggles) with one frozen
dataclass tree usable as a jit static argument.

All shape-determining fields (window size, feature budget, IMU buffer
length, solver iteration counts) are Python ints so every jitted program
has static shapes — the core architectural transformation relative to the
reference's dynamic containers (SURVEY.md §7.1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics + camera-IMU extrinsics for one device profile.

    Mirrors the per-device table in reference global_param.cpp:24-132
    (fx/fy/cx/cy, TIC, RIC=ypr(0,0,180°)) and EuRoC-style calibrations.
    The mobile profiles are portrait 480×640 (reference
    feature_tracker.hpp:26-27 COL=480, ROW=640).
    """

    width: int = 480
    height: int = 640
    fx: float = 526.600
    fy: float = 526.678
    cx: float = 243.481
    cy: float = 315.280
    # Radial-tangential distortion (EuRoC cam0 style); reference assumes
    # pre-undistorted mobile frames, so defaults are zero.
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    # Camera-IMU extrinsics: p_imu = ric @ p_cam + tic.
    tic: Tuple[float, float, float] = (0.0, 0.092, 0.01)
    # Extrinsic rotation as ypr radians (reference: ypr(0,0,180°) deg,
    # global_param.hpp:23-25).
    ric_ypr: Tuple[float, float, float] = (0.0, 0.0, math.pi)
    # Full camera→IMU rotation R_bc as a row-major 9-tuple; overrides
    # ric_ypr when set (EuRoC's calibrated R_BS is not a ypr composition).
    ric_full: Optional[Tuple[float, ...]] = None

    def ric_matrix(self):
        import numpy as _np
        if self.ric_full is not None:
            return _np.asarray(self.ric_full, _np.float32).reshape(3, 3)
        y, p, r = self.ric_ypr
        cy, sy = math.cos(y), math.sin(y)
        cp, sp = math.cos(p), math.sin(p)
        cr, sr = math.cos(r), math.sin(r)
        Rz = _np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        Ry = _np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        Rx = _np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        return (Rz @ Ry @ Rx).astype(_np.float32)

    @property
    def focal(self) -> float:
        return 0.5 * (self.fx + self.fy)


@dataclasses.dataclass(frozen=True)
class ImuConfig:
    """IMU noise model (reference global_param.hpp:42-46)."""

    acc_n: float = 0.5
    acc_w: float = 0.002
    gyr_n: float = 0.2
    gyr_w: float = 4e-5
    gravity: float = 9.805
    rate_hz: float = 100.0


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Sliding-window NLLS solver budget.

    The reference uses wall-clock budgets (≤10 iter / ≤60 ms, VINS.cpp:639-653);
    under XLA we compile a fixed iteration count with early-exit masking.
    """

    max_iters: int = 8
    # Floor for the runtime backpressure budget: real-time streaming
    # degrades the LM iteration budget from max_iters toward this when
    # blocks fall behind the camera rate (the reference's 60→40→30 ms
    # solver-cap ladder bottoms out the same way, global_param.cpp:34,
    # VINS.cpp:646-653).
    min_iters: int = 3
    # Levenberg-Marquardt damping schedule.
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.3
    lambda_min: float = 1e-9
    lambda_max: float = 1e2
    # Cauchy robust-loss scale on whitened projection residuals
    # (reference uses CauchyLoss(1.0), VINS.cpp:485).
    cauchy_c: float = 1.0
    # Convergence: stop when relative cost decrease falls below this.
    rel_tol: float = 1e-6
    # Eigenvalue clamp for the marginalization sqrt factorization
    # (reference: marginalization_factor.hpp:75, eps=1e-8).
    eig_eps: float = 1e-8
    # Marginalization sqrt method: "chol" (fast, ridge-regularized) or
    # "eigh" (reference-parity eigenvalue clamping).
    marg_sqrt: str = "chol"
    # Projection-factor budget per solve: active (frame, landmark) cells
    # are compacted into this many slots instead of evaluating the full
    # F×max_landmarks grid (reference bounds the same quantity via
    # NUM_OF_F=1000 parameter blocks). ~70 tracked features × ≤10
    # co-observing frames ≈ 650; on overflow, cells of longer tracks win
    # (select_proj_factors scores by per-landmark track length, so the
    # best-constrained factors survive).
    max_proj_factors: int = 768
    # Loop-reprojection factor budget (observations of current-window
    # landmarks in a retrieved old keyframe, VINS.cpp:571-637). Bounded by
    # the tracked-feature count, not max_landmarks.
    max_loop_factors: int = 128
    # Motion-only (vinsPnP) solver budget: the reference runs ≤5 Ceres
    # iterations in a ≤10 ms cap (vins_pnp.cpp:329-331); the dead-
    # reckoned warm start makes 3 fixed LM iterations equivalent on the
    # 30 Hz path (each iteration = one linearize + one residual-only
    # accept test). Perspective factors are compacted from the S×Mp grid
    # (~7×256) into this many active slots (~70 live features × ≤6 free
    # frames) before linearization — the grid is >80% padding.
    pnp_iters: int = 3
    pnp_max_factors: int = 448
    # Streaming-scan policy for the motion-only solve:
    #   "all"        — solve every frame (reference USE_PNP parity);
    #   "nonbackend" — skip the solve on backend frames (their published
    #                  pose is the backend's and the pnp window is
    #                  re-anchored right after — the solve is dead work);
    #   "deadreckon" — never solve in the scan; publish IMU dead-reckoned
    #                  poses between backend anchors. In the fused scan
    #                  the anchor is at most freq-1 frames (~66 ms) old,
    #                  so double-integration error is sub-mm — the 30 Hz
    #                  refinement the reference needs against its ~100 ms
    #                  backend latency (vins_pnp.cpp:264-341) is
    #                  redundant here. Gated by the per-round accuracy
    #                  artifact (ACCURACY_r*.json); round-4 ATE matrix
    #                  measured deadreckon == solve-every-frame to 1e-4
    #                  over a 260-frame stream, so deadreckon is the
    #                  default. (The interactive 30 Hz path always
    #                  solves — it faces real backend latency.)
    pnp_stream_solve: str = "deadreckon"


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """KLT front-end budget (reference feature_tracker.hpp:24-29)."""

    max_features: int = 128          # padded slot count (reference MAX_CNT=70)
    target_features: int = 70        # top-up target per keyframe batch
    min_distance: int = 30           # NMS spacing in px (MIN_DIST)
    # 3 levels, matching the reference's LK (feature_tracker.cpp:181,
    # maxLevel=3 pyramid). Round-4 ATE matrix: 4 levels measured 6x WORSE
    # ATE on a 260-frame stream (1.61 vs 0.27) — the 1/8-scale level's
    # aliased flow seeds drag good tracks off basin — and costs ~10% more
    # KLT time.
    pyramid_levels: int = 3
    klt_window: int = 21             # LK window (21x21)
    klt_iters: int = 10              # LK iterations per level
    klt_eps: float = 0.01            # LK convergence threshold (px)
    f_ransac_thresh: float = 1.0     # F-matrix RANSAC threshold in px (F_THRESHOLD)
    f_ransac_hyps: int = 256         # fixed hypothesis count (batched RANSAC)
    clahe_clip: float = 3.0          # CLAHE clip limit (ViewController.mm:439)
    clahe_grid: int = 8
    # CLAHE histogram bins. cv::CLAHE uses 256; the histogram
    # compare-reduce and the one-hot LUT contraction both scale linearly
    # in bins, and 128 is visually indistinguishable for tracking.
    clahe_bins: int = 256
    min_track_for_stable: int = 2
    # Streaming scan: detect replacement corners every frame (True) or
    # only on backend frames (False — the reference's cadence,
    # feature_tracker.cpp:231-307). Per-frame top-up costs ~0.5 ms/frame
    # extra in the scan for no measured accuracy benefit (round-4 ATE
    # matrix: 1.614 vs 1.602 over a 260-frame stream — noise; the round-2
    # "2x ATE" regression predates the fb+NCC KLT survival fixes), so the
    # scan follows the reference's cadence. The interactive path still
    # tops up every frame (it publishes through the same tracker).
    topup_every_frame: bool = False


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop closure / pose graph (reference global_param.hpp:26-27 etc.)."""

    enabled: bool = True
    max_keyframes: int = 512         # pose-graph cap (reference: 500)
    loop_freq: int = 3               # detect every 3rd keyframe
    min_loop_matches: int = 22       # MIN_LOOP_NUM
    brief_bits: int = 256
    max_kf_features: int = 512       # FAST corners per keyframe for BRIEF
    dislocal: int = 20               # exclude this many recent keyframes from query
    similarity_alpha: float = 0.3    # normalized-similarity gate (demoDetector.h:126)
    min_similarity: float = 0.15     # absolute cosine-score floor (grid scorer)
    temporal_k: int = 1              # temporal consistency matches (demoDetector.h:128)
    # Place recognition: "bow" = hierarchical tf-idf vocabulary tree
    # (DBoW2 parity, loop/vocabulary.py), "grid" = spatially-pooled
    # binary-statistics descriptor (ops/brief.global_descriptor).
    place_recognition: str = "bow"
    vocab_k: int = 10                # tree branching (reference: k=10)
    vocab_levels: int = 3            # tree depth (reference: L=6, 1e6 words;
                                     # 1e3 words is ample at ≤512 keyframes)
    vocab_train_after: int = 16      # auto-train once this many kf exist
    vocab_train_iters: int = 6       # Lloyd iterations per tree node
    min_similarity_bow: float = 0.04  # absolute L1-score floor (BoW scorer)
    island_gap: int = 3              # entry-id gap closing match islands
    temporal_radius: int = 10        # consecutive-query match proximity for
                                     # the temporal-consistency k test
                                     # (TemplatedLoopDetector.h:668-877)
    # Spatial alternative for the temporal-consistency test: consecutive
    # queries whose matches are within this many meters of each other
    # are consistent even if their ENTRY ids are far apart. The
    # reference's entry-id proximity assumes each place appears once in
    # the DB; after distance resampling + multi-lap revisits a place has
    # aliased copies at scattered entry ids, and pure index proximity
    # suppressed ~70% of true cross-lap re-matches (r4 soak).
    temporal_spatial_m: float = 2.5
    yaw_reject_deg: float = 30.0     # loop sanity: |yaw|>30° rejected
    trans_reject_m: float = 10.0     # loop sanity: |t|>10 m rejected
    pose_graph_iters: int = 12
    sequential_edges: int = 5        # chain edges per node (keyfame_database.cpp:239)
    # Geometric verification (loop/keyframe_db.py): F-RANSAC threshold in
    # PIXELS (divided by the camera focal at use — the previous hardcoded
    # 2.0/460 broke on non-EuRoC focal lengths), descriptor-match gates
    # (keyframe.cpp:161-187), and the old-pose PnP acceptance residual.
    geo_ransac_px: float = 2.0
    geo_ransac_hyps: int = 256
    match_max_dist: int = 80         # Hamming distance gate (of 256 bits)
    match_ratio: float = 0.85        # best/second-best neigh-ratio test
    pnp_max_msr: float = 5e-3        # mean-squared reproj gate (normalized²)
    # Streaming ride-time re-attachment (stream.vio_scan_step): a staged
    # loop constraint carries the OLD keyframe's descriptors and is
    # matched against the CURRENT frame's features inside the scan, so
    # detection/staging latency cannot starve the track-id join (the
    # host-side join measured ZERO surviving ids at 2-block latency —
    # track lifetime is shorter than the in-flight pipeline depth).
    # Ride-time attach reprojection gates (normalized plane, old frame).
    # attach_gate bounds a match's DEVIATION from the median reprojection
    # offset (raw drift shifts all true matches coherently; false ones
    # scatter by radians); attach_max is a loose absolute cap.
    attach_gate: float = 0.12
    attach_max: float = 0.8
    # Backend frames to keep trying the attach before the anchor
    # retires. Generous on purpose: by injection time the vehicle is
    # typically PAST the detected place (multi-block content latency);
    # on a revisiting trajectory it re-enters the old keyframe's view
    # within a lap, and the attach_gate reprojection test keeps
    # far-away frames from attaching in the meantime. ~1 lap of the
    # test fixtures' circles at backend rate.
    attach_ttl: int = 120


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    """Sliding-window shape constants (reference global_param.hpp:28-37)."""

    window_size: int = 10            # => 11 frames in window
    pnp_size: int = 6                # motion-only window => 7 frames
    max_imu_per_edge: int = 32       # padded IMU samples between frames
    # Estimator landmark-slot budget, decoupled from the tracker's
    # per-frame feature budget (reference: NUM_OF_F=1000 estimator slots
    # vs MAX_CNT=70 tracked, global_param.hpp:37). Dead tracks hold their
    # slot until their observations leave the window (~F frames), so this
    # must exceed max_features by the expected churn headroom.
    max_landmarks: int = 256
    max_depth: float = 1e3
    min_depth: float = 0.1
    init_depth: float = 5.0          # INIT_DEPTH (feature_manager.hpp)
    min_parallax_px: float = 10.0    # keyframe parallax threshold (MIN_PARALLAX)

    @property
    def num_frames(self) -> int:
        return self.window_size + 1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for scale-out (SURVEY.md §7.1 'Scale-out').

    Axes: `batch` = data-parallel frame/window replicas, `block` =
    keyframe/landmark block partition of distributed BA.
    """

    batch_axis: str = "batch"
    block_axis: str = "block"
    batch_size: int = 1
    block_size: int = 1


@dataclasses.dataclass(frozen=True)
class VinsConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    imu: ImuConfig = dataclasses.field(default_factory=ImuConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    loop: LoopConfig = dataclasses.field(default_factory=LoopConfig)
    window: WindowConfig = dataclasses.field(default_factory=WindowConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # Backend solve cadence: process every `freq`-th camera frame
    # (reference FREQ=3: 30 Hz camera -> 10 Hz backend).
    freq: int = 3
    # Failure-detection thresholds (reference VINS.cpp:214-265).
    fail_min_features: int = 4
    fail_max_gyr_bias: float = 1.0
    fail_max_acc_bias: float = 2.5
    fail_max_trans_jump: float = 1.0
    fail_max_z_jump: float = 0.5
    fail_max_rot_jump_deg: float = 40.0
    # Initialization acceptance: final cost threshold (VINS.cpp:416).
    init_max_cost: float = 200.0
    # Init IMU-excitation gate: stddev of per-edge mean specific force
    # (delta_v / dt) across the boot window must exceed this, else
    # FAIL_IMU (VINS.cpp:839-858; the reference ships the check commented
    # out with threshold 0.25 — we enable it, since an unexcited window
    # makes the scale unobservable and wastes a full SfM+align attempt).
    # 0.08 rather than 0.25: measured excitation of smooth-but-
    # observable trajectories (slow MAV arcs) sits at 0.13; truly
    # degenerate (constant-velocity) windows measure < 0.005.
    init_min_acc_var: float = 0.08
    # SfM incremental-PnP acceptance: mean-squared reprojection residual
    # (normalized image plane) for a chained frame pose (inital_sfm.cpp:22).
    init_pnp_max_msr: float = 1e-3
    # Planar-degeneracy guard: if the essential-matrix rotation differs
    # from the gyro-preintegrated rotation by more than this, re-seed
    # with gyro rotation + linear translation (initialization.py).
    init_max_gyro_visual_deg: float = 8.0

    def replace(self, **kw) -> "VinsConfig":
        return dataclasses.replace(self, **kw)


# Device profile table, mirroring reference global_param.cpp:24-132.
DEVICE_PROFILES = {
    "iphone7p": CameraConfig(width=480, height=640,
                             fx=526.600, fy=526.678, cx=243.481, cy=315.280,
                             tic=(0.0, 0.092, 0.01)),
    "iphone7": CameraConfig(width=480, height=640,
                            fx=549.476, fy=549.458, cx=240.315, cy=320.617,
                            tic=(0.0, 0.065, 0.0)),
    "iphone6s": CameraConfig(width=480, height=640,
                             fx=549.477, fy=549.477, cx=240.0, cy=320.0,
                             tic=(0.0, 0.065, 0.0)),
    "iphone6sp": CameraConfig(width=480, height=640,
                              fx=547.565, fy=547.998, cx=239.033, cy=309.452,
                              tic=(0.0, 0.065, 0.0)),
    # iPad Pro 9.7"/12.9" share intrinsics in the reference table
    # (global_param.cpp:92-124); only the lever arm differs from iPhones.
    "ipadpro97": CameraConfig(width=480, height=640,
                              fx=547.234, fy=547.464, cx=241.549, cy=317.957,
                              tic=(0.0, 0.092, 0.1)),
    "ipadpro129": CameraConfig(width=480, height=640,
                               fx=547.234, fy=547.464, cx=241.549, cy=317.957,
                               tic=(0.0, 0.092, 0.1)),
    # EuRoC MAV cam0 (for dataset replay; values from the public EuRoC calib:
    # mav0/cam0/sensor.yaml T_BS — full R_bc, not a ypr approximation).
    "euroc": CameraConfig(width=752, height=480,
                          fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                          k1=-0.28340811, k2=0.07395907,
                          p1=0.00019359, p2=1.76187114e-05,
                          tic=(-0.0216401454975, -0.064676986768, 0.00981073058949),
                          ric_full=(0.0148655429818, -0.999880929698, 0.00414029679422,
                                    0.999557249008, 0.0149672133247, 0.025715529948,
                                    -0.0257744366974, 0.00375618835797, 0.999660727178)),
}


def default_config() -> VinsConfig:
    return VinsConfig()


def euroc_config() -> VinsConfig:
    return VinsConfig(camera=DEVICE_PROFILES["euroc"], imu=ImuConfig(
        acc_n=0.08, acc_w=0.00004, gyr_n=0.004, gyr_w=2e-6, gravity=9.81007,
        rate_hz=200.0))
