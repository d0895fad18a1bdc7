"""ASL-layout (EuRoC-format) fixture generator (port of
vins_tpu/io/asl_fixture.py).

Writes a sequence in the exact on-disk layout EuRoC ships
(`mav0/cam0/data.csv` + `data/<t>.png`, `mav0/imu0/data.csv`,
`mav0/state_groundtruth_estimate0/data.csv`), so the dataset path (the
ASL reader, measurement alignment, radtan undistortion, the euroc camera)
runs unchanged on generated data:
  * 752x480 frames ray-cast through the calibrated radial-tangential
    distortion of EuRoC cam0, rendered on the caller's device;
  * 200 Hz IMU with white noise and bias random walk in a body frame
    related to the camera by EuRoC's calibrated R_BS;
  * 20 Hz camera stamps interleaved with the IMU stamps, integer
    nanosecond stamps, EuRoC csv headers;
  * ground truth at IMU rate with pose, velocity and biases.
The trajectory, IMU, csv and PNG writing are the JAX module's numpy code,
so with image_noise=0 the csvs are byte for byte the same and the PNGs
differ only where float32 rendering rounds a pixel to the neighbouring
8-bit level; the image noise comes from a torch.Generator.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

from .. import device as device_mod
from ..config import VinsConfig, euroc_config
from . import synthetic


def _encode_png_gray8(img_u8: np.ndarray) -> bytes:
    """Minimal 8-bit grayscale PNG encoder (filter 0 rows), the inverse of
    io/euroc._decode_png_gray8."""
    H, W = img_u8.shape

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0)
    raw = b"".join(b"\x00" + row.tobytes() for row in img_u8)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


class FixtureTruth(NamedTuple):
    cam_ts: np.ndarray   # [N] seconds
    p: np.ndarray        # [N, 3] body positions at camera stamps
    q: np.ndarray        # [N, 4] wxyz body attitudes


def generate_asl_fixture(root: str,
                         cfg: Optional[VinsConfig] = None,
                         n_frames: int = 80,
                         cam_hz: float = 20.0,
                         imu_hz: float = 200.0,
                         seed: int = 0,
                         gyr_noise: float = 2e-3,
                         acc_noise: float = 1.5e-2,
                         gyr_walk: float = 2e-5,
                         acc_walk: float = 2e-4,
                         image_noise: float = 0.004,
                         gyr_scale: float = 1.0,
                         traj_kwargs: Optional[dict] = None,
                         device=None) -> FixtureTruth:
    """Write a full ASL-layout sequence under `root` and return the ground
    truth at camera stamps. Noise sigmas are per-sample (rad/s, m/s²);
    walk sigmas are per-√s random-walk densities.

    gyr_scale: gyroscope scale-factor error (1.015 = reads 1.5% high —
    a realistic MEMS systematic that is NOT in the estimator's model, so
    unlike bias walk it cannot be absorbed by online bias estimation:
    yaw drift accrues proportionally to total rotation, exactly the
    failure mode the 4-DoF pose graph exists to correct,
    keyfame_database.cpp:140-356). 1.0 = calibrated. Frames render on
    `device` (None: the first CUDA card)."""
    device = device_mod.resolve(device)
    cfg = cfg or euroc_config()
    cam = cfg.camera
    rng = np.random.default_rng(seed)
    # Slow yaw: image motion from rotation adds no parallax but degrades
    # KLT survival; the vertical bob supplies the IMU excitation.
    tk = dict(w=0.3, bob=0.22, bob_w=1.9)
    tk.update(traj_kwargs or {})
    g = np.array([0.0, 0.0, cfg.imu.gravity])

    # ---- analytic body trajectory ----------------------------------------
    # The camera must look outward at the cylinder walls. With EuRoC's
    # calibrated R_bc that means the BODY attitude carries a constant
    # pre-rotation Q0: R_wb(t) = Rz(yaw(t)) @ Q0 with Q0 = R_cam_out @
    # R_bcᵀ, where R_cam_out is the outward-looking camera convention of
    # the synthetic world (z forward along the circle tangent).
    R_cam_out = np.array([[0.0, 0.0, 1.0],
                          [-1.0, 0.0, 0.0],
                          [0.0, -1.0, 0.0]])
    R_bc = cam.ric_matrix().astype(np.float64)
    t_bc = np.asarray(cam.tic, np.float64)
    Q0 = R_cam_out @ R_bc.T

    def rz(yaw):
        c, s = np.cos(yaw), np.sin(yaw)
        z = np.zeros_like(yaw)
        o = np.ones_like(yaw)
        return np.stack([np.stack([c, -s, z], -1),
                         np.stack([s, c, z], -1),
                         np.stack([z, z, o], -1)], -2)

    def body_pose(t):
        p, v, a, yaw, yaw_rate = synthetic._traj(t, **tk)
        # R_wc = R_wb·R_bc = Rz(yaw)·R_cam_out: same tangent-looking
        # camera as the pinhole synthetic world.
        R_wb = rz(yaw) @ Q0
        return p, v, a, R_wb, yaw_rate

    # ---- IMU stream -------------------------------------------------------
    t0 = 100.0  # nonzero epoch: catches ns/seconds mixups in readers
    dur = n_frames / cam_hz
    imu_ts = t0 + np.arange(0.0, dur + 2.0 / imu_hz, 1.0 / imu_hz)
    p_i, v_i, a_i, R_i, ydot_i = body_pose(imu_ts - t0)
    # Body angular rate: R_wb = Rz(yaw)·Q0 ⇒ ω_world = (0,0,ẏaw);
    # ω_body = R_wbᵀ ω_world = Q0ᵀ (0,0,ẏaw).
    w_body = np.einsum("ji,nj->ni", Q0,
                       np.stack([np.zeros_like(ydot_i),
                                 np.zeros_like(ydot_i), ydot_i], -1))
    # Specific force: f = R_wbᵀ (a_w + g).
    f_body = np.einsum("nji,nj->ni", R_i, a_i + g)

    dt = 1.0 / imu_hz
    bg = np.cumsum(rng.normal(size=w_body.shape) * gyr_walk * np.sqrt(dt), 0)
    ba = np.cumsum(rng.normal(size=f_body.shape) * acc_walk * np.sqrt(dt), 0)
    gyr_meas = (gyr_scale * w_body + bg
                + rng.normal(size=w_body.shape) * gyr_noise)
    acc_meas = f_body + ba + rng.normal(size=f_body.shape) * acc_noise

    # ---- camera stream ----------------------------------------------------
    # Offset camera stamps by a quarter IMU period (real rigs are not
    # sample-aligned).
    cam_ts = t0 + np.arange(n_frames) / cam_hz + 0.25 / imu_hz
    p_c, v_c, _, R_c, _ = body_pose(cam_ts - t0)
    cam_centers = p_c + np.einsum("nij,j->ni", R_c, t_bc)
    R_wc = R_c @ R_bc

    imgs = synthetic.render_camera_frames(
        cam_centers.astype(np.float32), R_wc.astype(np.float32), cfg,
        seed=seed, noise_sigma=image_noise,
        distorted=(cam.k1 != 0 or cam.k2 != 0 or cam.p1 != 0
                   or cam.p2 != 0),
        tex_gain=2.2, tex_freq_max=45.0, device=device).cpu().numpy()

    # ---- write the ASL tree -----------------------------------------------
    mav = os.path.join(root, "mav0")
    cam_dir = os.path.join(mav, "cam0", "data")
    os.makedirs(cam_dir, exist_ok=True)
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
    gt_dir = os.path.join(mav, "state_groundtruth_estimate0")
    os.makedirs(gt_dir, exist_ok=True)

    cam_ns = (cam_ts * 1e9).round().astype(np.int64)
    with open(os.path.join(mav, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for k, ns in enumerate(cam_ns):
            name = f"{ns:d}.png"
            f.write(f"{ns:d},{name}\n")
            img_u8 = np.clip(imgs[k] * 255.0, 0, 255).astype(np.uint8)
            with open(os.path.join(cam_dir, name), "wb") as pf:
                pf.write(_encode_png_gray8(img_u8))

    imu_ns = (imu_ts * 1e9).round().astype(np.int64)
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
                "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
                "a_RS_S_z [m s^-2]\n")
        for k, ns in enumerate(imu_ns):
            f.write(f"{ns:d}," + ",".join(
                f"{x:.9f}" for x in (*gyr_meas[k], *acc_meas[k])) + "\n")

    q_i = _rotmats_to_quats(R_i)
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp,p_RS_R_x [m],p_RS_R_y [m],p_RS_R_z [m],"
                "q_RS_w [],q_RS_x [],q_RS_y [],q_RS_z [],"
                "v_RS_R_x [m s^-1],v_RS_R_y [m s^-1],v_RS_R_z [m s^-1],"
                "b_w_RS_S_x [rad s^-1],b_w_RS_S_y [rad s^-1],"
                "b_w_RS_S_z [rad s^-1],b_a_RS_S_x [m s^-2],"
                "b_a_RS_S_y [m s^-2],b_a_RS_S_z [m s^-2]\n")
        for k, ns in enumerate(imu_ns):
            row = (*p_i[k], *q_i[k], *v_i[k], *bg[k], *ba[k])
            f.write(f"{ns:d}," + ",".join(f"{x:.9f}" for x in row) + "\n")

    return FixtureTruth(cam_ts=cam_ts, p=p_c.astype(np.float32),
                        q=_rotmats_to_quats(R_c).astype(np.float32))


def _rotmats_to_quats(R: np.ndarray) -> np.ndarray:
    """Batch rotation matrices → wxyz quaternions (numpy, Shepperd)."""
    R = np.asarray(R, np.float64)
    out = np.zeros((len(R), 4))
    for i, M in enumerate(R):
        t = np.trace(M)
        if t > 0:
            s = np.sqrt(t + 1.0) * 2
            out[i] = [0.25 * s, (M[2, 1] - M[1, 2]) / s,
                      (M[0, 2] - M[2, 0]) / s, (M[1, 0] - M[0, 1]) / s]
        else:
            j = int(np.argmax(np.diag(M)))
            k, l = (j + 1) % 3, (j + 2) % 3
            s = np.sqrt(max(M[j, j] - M[k, k] - M[l, l] + 1.0, 1e-12)) * 2
            q = np.zeros(4)
            q[1 + j] = 0.25 * s
            q[1 + k] = (M[k, j] + M[j, k]) / s
            q[1 + l] = (M[l, j] + M[j, l]) / s
            q[0] = (M[l, k] - M[k, l]) / s
            out[i] = q
        out[i] /= np.linalg.norm(out[i])
    return out
