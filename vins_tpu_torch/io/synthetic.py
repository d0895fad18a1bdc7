"""Synthetic visual-inertial world (port of vins_tpu/io/synthetic.py):
the closed-form circle trajectory, one ground-truth window
(make_synthetic_window), the per-frame sequence generator and bench.py's
bootstrapped backend sequence (build_backend_inputs), the ray-cast
textured-cylinder renderer, a synthetic global-BA problem
(make_ba_problem), the renderer's exact pixel correspondence between two
frames (ground_truth_correspondence, for checking tracking) and a
ground-truth initializer for pipeline.VinsSystem's test seam
(`initializer=`), which the system otherwise fills by visual-inertial
initialization.

The window, the sequence, the BA problem and the texture come from numpy
with a seed, the same draws in the same order as in the JAX module; the
renderer runs in PyTorch on any device and draws its image noise from a
torch.Generator (so noisy frames differ from the JAX renders; noise-free
renders agree).
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..config import VinsConfig
from ..core import feature_manager as fm
from ..core.factors import Extrinsics
from ..core.preintegration import ImuChunk
from ..core.state import FeatureTable, WindowState
from ..utils import camera as cam_mod
from ..utils import lie


def _traj(t, r=3.0, w=0.6, bob=0.3, bob_w=1.7):
    """Closed-form circle trajectory. Returns p, v, a, yaw, yaw_rate."""
    t = np.asarray(t, np.float64)
    p = np.stack([r * np.cos(w * t), r * np.sin(w * t),
                  bob * np.sin(bob_w * t)], -1)
    v = np.stack([-r * w * np.sin(w * t), r * w * np.cos(w * t),
                  bob * bob_w * np.cos(bob_w * t)], -1)
    a = np.stack([-r * w * w * np.cos(w * t), -r * w * w * np.sin(w * t),
                  -bob * bob_w * bob_w * np.sin(bob_w * t)], -1)
    yaw = w * t + np.pi / 2.0
    yaw_rate = np.full_like(t, w)
    return p, v, a, yaw, yaw_rate


class SyntheticWindow(NamedTuple):
    """Ground-truth window snapshot, raw IMU chunks, landmark geometry."""

    state: WindowState           # ground-truth window state (F frames)
    chunks: ImuChunk             # stacked [W, N] raw IMU between frames
    feats: FeatureTable          # observations of the landmarks
    landmarks: torch.Tensor      # [L, 3] world points
    ext: Extrinsics
    gravity: torch.Tensor        # [3]
    timestamps: torch.Tensor     # [F]


_R_IC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]],
                 np.float32)
_T_IC = np.array([0.05, 0.0, 0.02], np.float32)


def make_synthetic_window(cfg: VinsConfig, n_landmarks: int = 80,
                          seed: int = 0, noise_px: float = 0.0,
                          imu_noise: float = 0.0, t0: float = 0.0,
                          frame_dt: float = 0.1,
                          device=None) -> SyntheticWindow:
    """One full window of ground truth around the circle: frame states,
    the IMU chunks between frames (row 0 is the sample at frame e), the
    landmarks' observations, anchors (first observing frame) and
    ground-truth inverse depths. noise_px: observation noise in pixels;
    imu_noise: a multiplier on the config's noise densities. The same
    numpy draws as the JAX generator for the same seed. device=None
    means the first CUDA card."""
    device = device_mod.resolve(device)
    rng = np.random.default_rng(seed)
    F = cfg.window.num_frames
    W = F - 1
    M = cfg.window.max_landmarks
    N = cfg.window.max_imu_per_edge
    gravity = np.array([0.0, 0.0, cfg.imu.gravity])

    t_frames = t0 + frame_dt * np.arange(F)
    p_f, v_f, _, yaw_f, _ = _traj(t_frames)
    q_f = lie.np_yaw_quat(yaw_f)

    n_sub = N - 1
    dt_imu = frame_dt / n_sub
    dts = np.zeros((W, N), np.float32)
    accs = np.zeros((W, N, 3), np.float32)
    gyrs = np.zeros((W, N, 3), np.float32)
    for e in range(W):
        ts = t_frames[e] + dt_imu * np.arange(N)
        _, _, a_w, yaw, yaw_rate = _traj(ts)
        Rwb = lie.np_quat_to_rotmat(lie.np_yaw_quat(yaw))
        accs[e] = np.einsum("nij,nj->ni", Rwb.transpose(0, 2, 1),
                            a_w + gravity)
        gyrs[e] = np.stack([np.zeros_like(yaw), np.zeros_like(yaw),
                            yaw_rate], -1)
        dts[e, 1:] = dt_imu
    if imu_noise > 0:
        sq = 1.0 / np.sqrt(dt_imu)
        accs += (rng.normal(size=accs.shape) * cfg.imu.acc_n * imu_noise
                 * sq * 0.01)
        gyrs += (rng.normal(size=gyrs.shape) * cfg.imu.gyr_n * imu_noise
                 * sq * 0.01)

    ang = rng.uniform(0, 2 * np.pi, n_landmarks)
    rad = rng.uniform(5.0, 9.0, n_landmarks)
    height = rng.uniform(-1.5, 1.5, n_landmarks)
    lms = np.stack([rad * np.cos(ang), rad * np.sin(ang), height], -1)

    obs = np.zeros((F, M, 2), np.float32)
    mask = np.zeros((F, M), bool)
    Rwb_f = lie.np_quat_to_rotmat(q_f)
    n_use = min(n_landmarks, M)
    fov_lim = 0.7
    for f in range(F):
        pts_b = np.einsum("ij,nj->ni", Rwb_f[f].T, lms[:n_use] - p_f[f])
        pts_c = np.einsum("ij,nj->ni", _R_IC.T, pts_b - _T_IC)
        z = pts_c[:, 2]
        ok = z > 0.3
        xy = pts_c[:, :2] / np.maximum(z[:, None], 1e-6)
        ok &= (np.abs(xy[:, 0]) < fov_lim) & (np.abs(xy[:, 1]) < fov_lim)
        if noise_px > 0:
            xy = xy + rng.normal(size=xy.shape) * (noise_px / cfg.camera.focal)
        obs[f, :n_use] = xy
        mask[f, :n_use] = ok

    first = np.argmax(mask, axis=0).astype(np.int32)
    valid = mask.sum(axis=0) >= 2
    track_id = np.where(valid, np.arange(M), -1).astype(np.int32)
    inv_depth = np.zeros(M, np.float32)
    for m in range(n_use):
        if not valid[m]:
            continue
        f = first[m]
        pts_b = Rwb_f[f].T @ (lms[m] - p_f[f])
        pts_c = _R_IC.T @ (pts_b - _T_IC)
        inv_depth[m] = 1.0 / max(pts_c[2], 1e-3)

    T = lambda x, dt=torch.float32: torch.as_tensor(
        np.asarray(x), dtype=dt, device=device)
    z3 = T(np.zeros((F, 3)))
    state = WindowState(p=T(p_f), q=T(q_f), v=T(v_f), ba=z3,
                        bg=z3.clone(), inv_depth=T(inv_depth))
    feats = FeatureTable(obs=T(obs), mask=T(mask, torch.bool),
                         anchor=T(first, torch.int32),
                         valid=T(valid, torch.bool),
                         track_id=T(track_id, torch.int32))
    return SyntheticWindow(
        state=state, chunks=ImuChunk(T(dts), T(accs), T(gyrs)), feats=feats,
        landmarks=T(lms), ext=Extrinsics(tic=T(_T_IC),
                                         qic=T(lie.np_rotmat_to_quat(_R_IC))),
        gravity=T(gravity), timestamps=T(t_frames))


class SyntheticSequence(NamedTuple):
    p: torch.Tensor           # [N, 3] ground-truth positions
    q: torch.Tensor           # [N, 4]
    v: torch.Tensor           # [N, 3]
    chunks: ImuChunk          # stacked [N, S]; chunk k covers (k-1 -> k)
    ids: torch.Tensor         # [N, Mi]
    obs: torch.Tensor         # [N, Mi, 2]
    obs_valid: torch.Tensor   # [N, Mi]
    landmarks: torch.Tensor   # [L, 3]
    ext: Extrinsics
    gravity: torch.Tensor
    timestamps: torch.Tensor  # [N]


def make_synthetic_sequence(cfg: VinsConfig, n_frames: int = 60,
                            n_landmarks: int = 400, seed: int = 0,
                            noise_px: float = 0.0, frame_dt: float = 0.1,
                            t0: float = 0.0, traj_kwargs: dict | None = None,
                            imu_per_frame: int | None = None,
                            device=None) -> SyntheticSequence:
    """Per-frame IMU chunks and landmark observations around the circle,
    with the same numpy draws as the JAX generator for the same seed.
    device=None means the first CUDA card."""
    device = device_mod.resolve(device)
    tk = traj_kwargs or {}
    traj = lambda t: _traj(t, **tk)
    rng = np.random.default_rng(seed)
    S = cfg.window.max_imu_per_edge
    Mi = cfg.frontend.max_features
    gravity = np.array([0.0, 0.0, cfg.imu.gravity])

    t_frames = t0 + frame_dt * np.arange(n_frames)
    p_f, v_f, _, yaw_f, _ = traj(t_frames)
    q_f = lie.np_yaw_quat(yaw_f)

    n_sub = (S - 1) if imu_per_frame is None else imu_per_frame
    if n_sub > S - 1:
        raise ValueError(f"imu_per_frame {n_sub} exceeds the {S - 1} "
                         "integration rows of a chunk")
    dt_imu = frame_dt / n_sub
    dts = np.zeros((n_frames, S), np.float32)
    accs = np.zeros((n_frames, S, 3), np.float32)
    gyrs = np.zeros((n_frames, S, 3), np.float32)
    for k in range(1, n_frames):
        ts = t_frames[k - 1] + dt_imu * np.arange(n_sub + 1)
        _, _, a_w, yaw, yaw_rate = traj(ts)
        Rwb = lie.np_quat_to_rotmat(lie.np_yaw_quat(yaw))
        accs[k, :n_sub + 1] = np.einsum("nij,nj->ni", Rwb.transpose(0, 2, 1),
                                        a_w + gravity)
        gyrs[k, :n_sub + 1] = np.stack([np.zeros_like(yaw),
                                        np.zeros_like(yaw), yaw_rate], -1)
        dts[k, 1:n_sub + 1] = dt_imu

    ang = rng.uniform(0, 2 * np.pi, n_landmarks)
    rad = rng.uniform(5.0, 9.0, n_landmarks)
    height = rng.uniform(-1.5, 1.5, n_landmarks)
    lms = np.stack([rad * np.cos(ang), rad * np.sin(ang), height], -1)

    Rwb_f = lie.np_quat_to_rotmat(q_f)
    fov_lim = 0.7
    ids_out = np.full((n_frames, Mi), -1, np.int32)
    obs_out = np.zeros((n_frames, Mi, 2), np.float32)
    ok_out = np.zeros((n_frames, Mi), bool)
    for f in range(n_frames):
        pts_b = np.einsum("ij,nj->ni", Rwb_f[f].T, lms - p_f[f])
        pts_c = np.einsum("ij,nj->ni", _R_IC.T, pts_b - _T_IC)
        z = pts_c[:, 2]
        vis = z > 0.3
        xy = pts_c[:, :2] / np.maximum(z[:, None], 1e-6)
        vis &= (np.abs(xy[:, 0]) < fov_lim) & (np.abs(xy[:, 1]) < fov_lim)
        sel = np.flatnonzero(vis)[:Mi]
        if noise_px > 0:
            xy = xy + rng.normal(size=xy.shape) * (noise_px / cfg.camera.focal)
        ids_out[f, :len(sel)] = sel
        obs_out[f, :len(sel)] = xy[sel]
        ok_out[f, :len(sel)] = True

    T = lambda x, dt=torch.float32: torch.as_tensor(
        np.asarray(x), dtype=dt, device=device)
    ext = Extrinsics(tic=T(_T_IC), qic=T(lie.np_rotmat_to_quat(_R_IC)))
    return SyntheticSequence(
        p=T(p_f), q=T(q_f), v=T(v_f),
        chunks=ImuChunk(T(dts), T(accs), T(gyrs)),
        ids=T(ids_out, torch.int32), obs=T(obs_out),
        obs_valid=T(ok_out, torch.bool), landmarks=T(lms), ext=ext,
        gravity=T(gravity), timestamps=T(t_frames))


def camera_ray_grid(cfg: VinsConfig, distorted: bool = False) -> np.ndarray:
    """[H, W, 3] unit camera-frame ray directions for every pixel. With
    `distorted`, each pixel is undistorted through the camera's
    radial-tangential model (utils.camera.pixel_to_normalized, float32 on
    the CPU), so rendered frames look like the distorted camera's output."""
    H, W = cfg.camera.height, cfg.camera.width
    cam = cfg.camera
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    if distorted:
        uv = torch.as_tensor(np.stack([u, v], -1).reshape(-1, 2))
        xy = cam_mod.pixel_to_normalized(cam, uv).numpy().reshape(H, W, 2)
        dirs_c = np.concatenate([xy, np.ones((H, W, 1), np.float32)], -1)
    else:
        dirs_c = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                           np.ones_like(u)], -1)
    return dirs_c / np.linalg.norm(dirs_c, axis=-1, keepdims=True)


def render_camera_frames(p_cam, R_wc, cfg: VinsConfig, seed: int = 0,
                         wall_radius: float = 8.0, floor_z: float = -2.0,
                         ceil_z: float = 2.0, noise_sigma: float = 0.005,
                         distorted: bool = False, tex_gain: float = 1.0,
                         tex_freq_max: float = 25.0, device=None,
                         frames_per_pass: int = 8) -> torch.Tensor:
    """Ray-cast [N, H, W] frames of the textured cylinder room from camera
    centers p_cam [N, 3] and camera-to-world rotations R_wc [N, 3, 3].
    The texture basis is the JAX renderer's (same numpy stream); the
    noise comes from a torch.Generator seeded with `seed`. distorted:
    cast the rays of the distorted camera (camera_ray_grid). device=None
    means the first CUDA card."""
    H, W = cfg.camera.height, cfg.camera.width
    tex_rng = np.random.default_rng(seed + 77)
    n_waves = 96
    freqs = tex_rng.uniform(0.5, tex_freq_max, (n_waves, 3)).astype(
        np.float32)
    mags = np.linalg.norm(freqs, axis=1, keepdims=True)
    amps = (1.0 / mags[:, 0]) ** 0.5
    amps = (amps / amps.sum() * tex_gain).astype(np.float32)
    phases = tex_rng.uniform(0, 2 * np.pi, n_waves).astype(np.float32)

    dev = device_mod.resolve(device)
    f32 = torch.float32
    dirs_c = torch.as_tensor(camera_ray_grid(cfg, distorted), dtype=f32,
                             device=dev)
    freqs_t = torch.as_tensor(freqs, device=dev)
    amps_t = torch.as_tensor(amps, device=dev)
    phases_t = torch.as_tensor(phases, device=dev)
    p_cam = torch.as_tensor(np.asarray(p_cam), dtype=f32, device=dev)
    R_wc = torch.as_tensor(np.asarray(R_wc), dtype=f32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    N = p_cam.shape[0]
    out = torch.empty((N, H, W), dtype=f32, device=dev)
    for s in range(0, N, frames_per_pass):
        e = min(s + frames_per_pass, N)
        o = p_cam[s:e, None, None, :]                      # [n,1,1,3]
        d = torch.einsum("hwj,nij->nhwi", dirs_c, R_wc[s:e])
        a = d[..., 0] ** 2 + d[..., 1] ** 2
        b = 2 * (o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1])
        c = o[..., 0] ** 2 + o[..., 1] ** 2 - wall_radius ** 2
        disc = torch.clamp(b * b - 4 * a * c, min=0.0)
        t_cyl = (-b + torch.sqrt(disc)) / torch.clamp(2 * a, min=1e-9)
        dz = d[..., 2]
        safe = torch.where(torch.abs(dz) < 1e-6,
                           torch.sign(dz) * 1e-6 + 1e-12, dz)
        inf = torch.full_like(dz, float("inf"))
        t_flo = torch.where(dz < -1e-6, (floor_z - o[..., 2]) / safe, inf)
        t_cei = torch.where(dz > 1e-6, (ceil_z - o[..., 2]) / safe, inf)
        t_hit = torch.minimum(torch.minimum(t_cyl, t_flo), t_cei)
        pts = (o + d * t_hit[..., None]).reshape(e - s, -1, 3)
        ang = pts @ freqs_t.T + phases_t                   # [n, HW, K]
        tex = 0.5 + 1.6 * (torch.cos(ang) @ amps_t)
        img = torch.clamp(0.15 + 0.55 * torch.clamp(tex, 0.0, 1.3), 0.0, 1.0)
        if noise_sigma > 0:
            img = img + noise_sigma * torch.randn(
                img.shape, generator=gen, dtype=f32, device=dev)
        out[s:e] = torch.clamp(img, 0.0, 1.0).reshape(e - s, H, W)
    return out


def render_sequence_images(seq: SyntheticSequence, cfg: VinsConfig,
                           seed: int = 0, wall_radius: float = 8.0,
                           floor_z: float = -2.0, ceil_z: float = 2.0,
                           noise_sigma: float = 0.005,
                           device=None, distorted: bool = False
                           ) -> torch.Tensor:
    """[N, H, W] float32 frames rendered along the sequence's trajectory
    (device=None: the first CUDA card; distorted: through the camera's
    radial-tangential model)."""
    R_ic = lie.np_quat_to_rotmat(seq.ext.qic.cpu().numpy())
    t_ic = seq.ext.tic.cpu().numpy()
    Rwb = lie.np_quat_to_rotmat(seq.q.cpu().numpy())
    p_f = seq.p.cpu().numpy()
    R_wc = np.einsum("nij,jk->nik", Rwb, R_ic)
    p_cam = p_f + np.einsum("nij,j->ni", Rwb, t_ic)
    return render_camera_frames(p_cam, R_wc, cfg, seed, wall_radius,
                                floor_z, ceil_z, noise_sigma,
                                distorted=distorted, device=device)


def ground_truth_correspondence(seq: SyntheticSequence, cfg: VinsConfig,
                                pts_px, frame_a: int, frame_b: int,
                                wall_radius: float = 8.0,
                                floor_z: float = -2.0,
                                ceil_z: float = 2.0) -> np.ndarray:
    """Exact correspondence of frame-a pixels pts_px [K, 2] (numpy or a
    tensor) in frame b, from the renderer's geometry: each pixel's ray is
    cast against the cylinder wall, floor and ceiling, and the hit is
    projected into frame b. Host numpy, as in the JAX module; returns
    numpy [K, 2] pixel coordinates."""
    fx, fy, cx, cy = (cfg.camera.fx, cfg.camera.fy,
                      cfg.camera.cx, cfg.camera.cy)
    qic, tic, q, p, pts_px = device_mod.host_args(
        seq.ext.qic, seq.ext.tic, seq.q, seq.p, pts_px)
    pts_px = np.asarray(pts_px)
    R_ic = lie.np_quat_to_rotmat(qic)
    Rwb = lie.np_quat_to_rotmat(q)

    R_wc = Rwb[frame_a] @ R_ic
    o = p[frame_a] + Rwb[frame_a] @ tic
    d_c = np.stack([(pts_px[:, 0] - cx) / fx, (pts_px[:, 1] - cy) / fy,
                    np.ones(len(pts_px), np.float32)], -1)
    d = d_c @ R_wc.T
    a = d[:, 0] ** 2 + d[:, 1] ** 2
    b = 2 * (o[0] * d[:, 0] + o[1] * d[:, 1])
    c = o[0] ** 2 + o[1] ** 2 - wall_radius ** 2
    t_cyl = (-b + np.sqrt(np.maximum(b * b - 4 * a * c, 0))) / np.maximum(
        2 * a, 1e-9)
    dz = d[:, 2]
    t_flo = np.where(dz < -1e-6, (floor_z - o[2]) / np.where(
        np.abs(dz) < 1e-6, -1e-6, dz), np.inf)
    t_cei = np.where(dz > 1e-6, (ceil_z - o[2]) / np.where(
        np.abs(dz) < 1e-6, 1e-6, dz), np.inf)
    t_hit = np.minimum(np.minimum(t_cyl, t_flo), t_cei)
    X = o + d * t_hit[:, None]

    R_wc2 = Rwb[frame_b] @ R_ic
    o2 = p[frame_b] + Rwb[frame_b] @ tic
    pc = (X - o2) @ R_wc2
    z = np.maximum(pc[:, 2], 1e-6)
    return np.stack([pc[:, 0] / z * fx + cx, pc[:, 1] / z * fy + cy], -1)


def make_ba_problem(n_poses: int = 16, n_landmarks: int = 512, seed: int = 0,
                    noise_px: float = 0.0, pose_noise: float = 0.0,
                    point_noise: float = 0.0, focal: float = 460.0,
                    device=None):
    """A global BA instance: (ground truth, perturbed initial guess,
    problem) as parallel.dist_ba types. Camera poses walk the circle
    looking outward, landmarks fill the annulus; landmarks seen fewer
    than twice are masked out; poses 0 and 1 are frozen at ground truth
    (gauge and scale). The same numpy draws as the JAX generator for the
    same seed. device=None means the first CUDA card."""
    from ..parallel.dist_ba import BAProblem, BAState

    device = device_mod.resolve(device)
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 2.2, n_poses)
    p_f, _, _, yaw_f, _ = _traj(t)
    R_wc = lie.np_quat_to_rotmat(lie.np_yaw_quat(yaw_f)) @ _R_IC
    q_wc = lie.np_rotmat_to_quat(R_wc)

    ang = rng.uniform(0, 2 * np.pi, n_landmarks)
    rad = rng.uniform(5.0, 9.0, n_landmarks)
    height = rng.uniform(-1.5, 1.5, n_landmarks)
    lms = np.stack([rad * np.cos(ang), rad * np.sin(ang), height],
                   -1).astype(np.float32)

    obs = np.zeros((n_landmarks, n_poses, 2), np.float32)
    mask = np.zeros((n_landmarks, n_poses), np.float32)
    for k in range(n_poses):
        pc = (lms - p_f[k]) @ R_wc[k]          # R_wcᵀ (X - p)
        z = pc[:, 2]
        ok = z > 0.5
        xy = pc[:, :2] / np.maximum(z[:, None], 1e-6)
        ok &= (np.abs(xy[:, 0]) < 0.8) & (np.abs(xy[:, 1]) < 0.8)
        if noise_px > 0:
            xy = xy + rng.normal(size=xy.shape) * (noise_px / focal)
        obs[:, k] = xy
        mask[:, k] = ok
    mask[(mask.sum(1) < 2)] = 0.0

    p0 = p_f + rng.normal(size=p_f.shape) * pose_noise
    p0[:2] = p_f[:2]
    dth = rng.normal(size=(n_poses, 3)) * pose_noise * 0.2
    dth[:2] = 0.0
    q0 = lie.np_quat_mul(q_wc, lie.np_so3_exp_quat(dth))
    x0 = lms + rng.normal(size=lms.shape) * point_noise
    pose_free = np.ones(n_poses, np.float32)
    pose_free[:2] = 0.0

    T = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                  device=device)
    gt = BAState(p=T(p_f), q=T(q_wc), pts=T(lms))
    init = BAState(p=T(p0), q=T(q0), pts=T(x0))
    prob = BAProblem(obs=T(obs), mask=T(mask), pose_free=T(pose_free))
    return gt, init, prob


def build_backend_inputs(cfg: VinsConfig, n_frames: int, seed: int = 0,
                         frame_dt: float = 0.1, device=None):
    """bench.py's backend sequence (build_backend_inputs) in the port:
    make_synthetic_sequence over F + n_frames frames (300 landmarks,
    0.5 px noise), the first F frames ingested and triangulated at their
    ground-truth poses and bootstrapped, the rest stacked as FrameInput
    [n_frames]. Returns (BackendState, FrameInput, ext, gravity).
    device=None means the first CUDA card."""
    from ..core.estimator import BackendState, FrameInput

    F = cfg.window.num_frames
    seq = make_synthetic_sequence(cfg, n_frames=F + n_frames,
                                  n_landmarks=300, seed=seed, noise_px=0.5,
                                  frame_dt=frame_dt, device=device)
    dev = seq.p.device
    feats = FeatureTable.empty(F, cfg.window.max_landmarks, device=dev)
    for f in range(F):
        feats = fm.ingest_frame(feats, f, seq.ids[f], seq.obs[f],
                                seq.obs_valid[f])
    chunks = ImuChunk(*[x[1:F] for x in seq.chunks])
    win = BackendState.fresh(cfg, dev).window._replace(
        p=seq.p[:F], q=seq.q[:F], v=seq.v[:F])
    win = fm.triangulate(win, feats, seq.ext, cfg)
    est = BackendState.bootstrap(cfg, win, feats, chunks, seq.ext,
                                 seq.gravity)
    inputs = FrameInput(chunk=ImuChunk(*[x[F:] for x in seq.chunks]),
                        ids=seq.ids[F:], obs=seq.obs[F:],
                        obs_valid=seq.obs_valid[F:])
    return est, inputs, seq.ext, seq.gravity


def ground_truth_initializer(seq: SyntheticSequence, cfg: VinsConfig):
    """An initializer for pipeline.VinsSystem that bootstraps the window
    from ground truth: p, q, v of the boot frames, zero biases, landmark
    depths triangulated from the boot observations (the ground-truth
    bootstrap of bench.py:122-142, with every depth triangulated instead
    of left at the identity window's 0.2)."""

    def init(feats: FeatureTable, chunks: ImuChunk,
             frames: List[int]) -> WindowState:
        dev = feats.obs.device
        idx = torch.as_tensor(frames, device=seq.p.device)
        F, M = feats.mask.shape
        z = torch.zeros((F, 3), device=dev)
        win = WindowState(p=seq.p[idx].to(dev), q=seq.q[idx].to(dev),
                          v=seq.v[idx].to(dev), ba=z, bg=z.clone(),
                          inv_depth=torch.zeros(M, device=dev))
        ext = Extrinsics(seq.ext.tic.to(dev), seq.ext.qic.to(dev))
        return fm.triangulate(win, feats, ext, cfg)

    return init
