"""SO(3)/quaternion primitives (port of vins_tpu/utils/lie.py).

Same conventions as the JAX module: quaternions are wxyz, Hamilton, body-
to-world (``w_v = R(q) @ b_v``); tangents right-multiply
(``q ⊞ δθ = q ⊗ exp(δθ)``). Every function broadcasts over leading batch
dimensions and is branch-free, so torch.func.vmap/jacfwd can trace it.
The numpy twins used by host-side generators live at the bottom.
"""
from __future__ import annotations

import numpy as np
import torch


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    # Filled on the device by fill_ kernels: `q[0] = 1.0` would copy the
    # scalar from the host and synchronize the stream.
    q = torch.zeros(4, dtype=dtype, device=device)
    q[:1].fill_(1.0)
    return q


def _norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(x²)) over the last axis, keepdim (jnp.linalg.norm)."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / _norm(q)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b (batch-broadcasting)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) @ v without forming R."""
    qw = q[..., :1]
    qv = q[..., 1:]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = torch.stack([
        ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz,
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Branch-free Shepperd selection (argmax of the four candidates)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                      m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 - m00 - m11 + m22], dim=-1)
    scores = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
                         dim=-1)
    best = torch.argmax(scores, dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)     # [..., 4 cand, 4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cand, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


def delta_q(theta: torch.Tensor) -> torch.Tensor:
    """First-order quaternion [1, θ/2], normalized."""
    half = 0.5 * theta
    w = torch.ones_like(half[..., :1])
    return quat_normalize(torch.cat([w, half], dim=-1))


def so3_exp_quat(theta: torch.Tensor) -> torch.Tensor:
    angle_sq = torch.sum(theta * theta, dim=-1, keepdim=True)
    angle = torch.sqrt(angle_sq + 1e-24)
    half = 0.5 * angle
    small = angle_sq < 1e-12
    k = torch.where(small, 0.5 - angle_sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle_sq / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([w, k * theta], dim=-1))


def so3_log(q: torch.Tensor) -> torch.Tensor:
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = _norm(v)
    angle = 2.0 * torch.atan2(vnorm, w)
    small = vnorm < 1e-9
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-6),
                        angle / torch.clamp(vnorm, min=1e-24))
    return scale * v


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def _quat_mul_matrix(q: torch.Tensor, sign: float) -> torch.Tensor:
    w, v = q[..., 0], q[..., 1:]
    top = torch.cat([w[..., None, None], -v[..., None, :]], -1)
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(
        q.shape[:-1] + (3, 3))
    bottom = torch.cat([v[..., :, None],
                        w[..., None, None] * eye + sign * skew(v)], -1)
    return torch.cat([top, bottom], -2)


def quat_left(q: torch.Tensor) -> torch.Tensor:
    """4x4 matrix with quat_mul(q, p) == quat_left(q) @ p."""
    return _quat_mul_matrix(q, 1.0)


def quat_right(q: torch.Tensor) -> torch.Tensor:
    """4x4 matrix with quat_mul(p, q) == quat_right(q) @ p."""
    return _quat_mul_matrix(q, -1.0)


def rotmat_to_ypr(R: torch.Tensor) -> torch.Tensor:
    """(yaw, pitch, roll) radians, ZYX convention."""
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.atan2(
        -R[..., 2, 0],
        R[..., 0, 0] * torch.cos(yaw) + R[..., 1, 0] * torch.sin(yaw))
    roll = torch.atan2(
        R[..., 0, 2] * torch.sin(yaw) - R[..., 1, 2] * torch.cos(yaw),
        -R[..., 0, 1] * torch.sin(yaw) + R[..., 1, 1] * torch.cos(yaw))
    return torch.stack([yaw, pitch, roll], dim=-1)


def ypr_to_rotmat(ypr: torch.Tensor) -> torch.Tensor:
    y, p, r = ypr.unbind(-1)
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    m = torch.stack([
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    ], dim=-1)
    return m.reshape(ypr.shape[:-1] + (3, 3))


def gravity_to_rotmat(g: torch.Tensor) -> torch.Tensor:
    """R0 with R0 @ ĝ = +z and zero yaw (Utility::g2R, used by
    visualInitialAlign to level the world frame)."""
    ng1 = g / _norm(g)
    ng2 = torch.zeros_like(ng1)
    ng2[..., 2:].fill_(1.0)
    axis = cross(ng1, ng2)
    sin_a = _norm(axis)
    cos_a = torch.sum(ng1 * ng2, -1, keepdim=True)
    angle = torch.atan2(sin_a, cos_a)
    # g antiparallel to +z: the cross product vanishes while the angle is
    # π; the x axis is perpendicular to both.
    x_axis = torch.zeros_like(ng1)
    x_axis[..., :1].fill_(1.0)
    axis = torch.where(sin_a < 1e-6, x_axis,
                       axis / torch.clamp(sin_a, min=1e-12))
    R0 = quat_to_rotmat(so3_exp_quat(axis * angle))
    yaw = rotmat_to_ypr(R0)[..., 0]
    zero = torch.zeros_like(yaw)
    return ypr_to_rotmat(torch.stack([-yaw, zero, zero], -1)) @ R0


def pose_retract(p: torch.Tensor, q: torch.Tensor, delta: torch.Tensor):
    """Retract [δp, δθ]: position adds, rotation right-multiplies."""
    p_new = p + delta[..., 0:3]
    q_new = quat_normalize(quat_mul(q, delta_q(delta[..., 3:6])))
    return p_new, q_new


def quat_boxminus(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """2·vec(q2⁻¹ ⊗ q1), sign-canonicalized."""
    dq = quat_mul(quat_conj(q2), q1)
    dq = torch.where(dq[..., :1] < 0, -dq, dq)
    return 2.0 * dq[..., 1:]


# ---------------------------------------------------------------------------
# Numpy twins for host-side generators (synthetic worlds, boot bookkeeping).
# ---------------------------------------------------------------------------


def np_yaw_quat(yaw) -> np.ndarray:
    half = 0.5 * np.asarray(yaw, np.float64)
    z = np.zeros_like(half)
    return np.stack([np.cos(half), z, z, np.sin(half)], -1).astype(np.float32)


def np_quat_to_rotmat(q) -> np.ndarray:
    q = np.asarray(q, np.float64)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = np.stack([
        ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz,
    ], -1)
    return r.reshape(q.shape[:-1] + (3, 3)).astype(np.float32)


def np_rotmat_to_quat(R) -> np.ndarray:
    R = np.asarray(R, np.float64)
    m = R.reshape(R.shape[:-2] + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = (
        m[..., 0], m[..., 1], m[..., 2], m[..., 3], m[..., 4],
        m[..., 5], m[..., 6], m[..., 7], m[..., 8])
    tr = m00 + m11 + m22
    qw = np.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = np.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                   m02 + m20], -1)
    qy = np.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                   m12 + m21], -1)
    qz = np.stack([m10 - m01, m02 + m20, m12 + m21,
                   1.0 - m00 - m11 + m22], -1)
    scores = np.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                       1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    best = np.argmax(scores, -1)
    cands = np.stack([qw, qx, qy, qz], -2)
    q = np.take_along_axis(cands, best[..., None, None].repeat(4, -1),
                           -2)[..., 0, :]
    q = np.where(q[..., :1] < 0, -q, q)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def np_yaw(q) -> float:
    """Yaw (ZYX) of one wxyz quaternion, on the host."""
    R = np_quat_to_rotmat(q)
    return float(np.arctan2(R[1, 0], R[0, 0]))


def np_quat_mul(a, b) -> np.ndarray:
    """Hamilton product (wxyz), batched."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1).astype(np.float32)


def np_so3_exp_quat(theta) -> np.ndarray:
    """Rotation vector -> wxyz quaternion (so3_exp_quat on the host)."""
    theta = np.asarray(theta, np.float64)
    angle_sq = np.sum(theta * theta, -1, keepdims=True)
    angle = np.sqrt(angle_sq + 1e-24)
    half = 0.5 * angle
    small = angle_sq < 1e-12
    k = np.where(small, 0.5 - angle_sq / 48.0, np.sin(half) / angle)
    w = np.where(small, 1.0 - angle_sq / 8.0, np.cos(half))
    q = np.concatenate([w, k * theta], -1)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
