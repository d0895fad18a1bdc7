"""IMU preintegration over fixed-size, dt=0-padded sample buffers (port of
vins_tpu/core/preintegration.py).

Every function broadcasts over leading batch dimensions (window edges).
`propagate` keeps the JAX module's parallel form: rotation prefixes and
the (Jacobian, covariance) pair composition are inclusive prefix scans —
here log-depth Hillis–Steele scans of batched small matmuls, a few
launches instead of one per sample — and Δv/Δp are cumulative sums.
Padding rows (dt = 0) are exact no-ops.

Error-state ordering: [δp 0:3 | δθ 3:6 | δv 6:9 | δba 9:12 | δbg 12:15].
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import ImuConfig
from ..utils import lie

O_P, O_R, O_V, O_BA, O_BG = 0, 3, 6, 9, 12


class ImuChunk(NamedTuple):
    """Raw IMU samples between two frames: row 0 seeds acc0/gyr0 (dt=0),
    rows 1..k integrate, the rest is dt=0 padding."""

    dt: torch.Tensor    # [..., N]
    acc: torch.Tensor   # [..., N, 3]
    gyr: torch.Tensor   # [..., N, 3]

    @staticmethod
    def empty(max_samples: int, dtype=torch.float32,
              device="cpu") -> "ImuChunk":
        return ImuChunk(
            dt=torch.zeros((max_samples,), dtype=dtype, device=device),
            acc=torch.zeros((max_samples, 3), dtype=dtype, device=device),
            gyr=torch.zeros((max_samples, 3), dtype=dtype, device=device))


class Preintegration(NamedTuple):
    dp: torch.Tensor             # [..., 3]
    dq: torch.Tensor             # [..., 4] wxyz
    dv: torch.Tensor             # [..., 3]
    jacobian: torch.Tensor       # [..., 15, 15]
    covariance: torch.Tensor     # [..., 15, 15]
    sum_dt: torch.Tensor         # [...]
    linearized_ba: torch.Tensor  # [..., 3]
    linearized_bg: torch.Tensor  # [..., 3]


def noise_covariance(imu: ImuConfig, dtype=torch.float32,
                     device="cpu") -> torch.Tensor:
    """18×18 diagonal: [na0, ng0, na1, ng1, nba, nbg] ⊗ I₃."""
    vals = [imu.acc_n ** 2, imu.gyr_n ** 2, imu.acc_n ** 2, imu.gyr_n ** 2,
            imu.acc_w ** 2, imu.gyr_w ** 2]
    diag = torch.empty(18, dtype=dtype, device=device)
    for i, v in enumerate(vals):
        diag[3 * i:3 * i + 3] = v
    return torch.diag(diag)


def _inclusive_scan(x, combine: Callable, axis: int):
    """Inclusive prefix scan along `axis` of a tensor or tuple of tensors;
    combine(earlier, later) must be associative."""
    is_tuple = isinstance(x, tuple)
    xs = x if is_tuple else (x,)
    n = xs[0].shape[axis]
    d = 1
    while d < n:
        earlier = tuple(t.narrow(axis, 0, n - d) for t in xs)
        later = tuple(t.narrow(axis, d, n - d) for t in xs)
        comb = combine(earlier if is_tuple else earlier[0],
                       later if is_tuple else later[0])
        comb = comb if is_tuple else (comb,)
        xs = tuple(torch.cat([t.narrow(axis, 0, d), c], axis)
                   for t, c in zip(xs, comb))
        d *= 2
    return xs if is_tuple else xs[0]


def _delta_prefixes(chunk: ImuChunk, ba: torch.Tensor, bg: torch.Tensor):
    """Body-frame deltas via prefix scans. Returns (dt [...,S],
    R0, R1 [...,S,3,3], a0, a1, un_gyr [...,S,3], dp, dq, dv, sum_dt)."""
    dtype = chunk.acc.dtype
    dt = chunk.dt[..., 1:]
    acc0, acc1 = chunk.acc[..., :-1, :], chunk.acc[..., 1:, :]
    gyr0, gyr1 = chunk.gyr[..., :-1, :], chunk.gyr[..., 1:, :]

    un_gyr = 0.5 * (gyr0 + gyr1) - bg[..., None, :]
    dq_inc = lie.delta_q(un_gyr * dt[..., None])
    dq_pref = _inclusive_scan(dq_inc, lie.quat_mul, dq_inc.dim() - 2)
    dq_pref = dq_pref / torch.sqrt(torch.sum(dq_pref * dq_pref, -1,
                                             keepdim=True))
    ident = lie.quat_identity(dtype, chunk.dt.device).expand(
        dq_pref.shape[:-2] + (1, 4))
    dq0 = torch.cat([ident, dq_pref[..., :-1, :]], -2)
    R0 = lie.quat_to_rotmat(dq0)
    R1 = lie.quat_to_rotmat(dq_pref)

    a0 = acc0 - ba[..., None, :]
    a1 = acc1 - ba[..., None, :]
    un_acc = 0.5 * (torch.einsum("...sij,...sj->...si", R0, a0)
                    + torch.einsum("...sij,...sj->...si", R1, a1))
    dv_steps = un_acc * dt[..., None]
    dv_pref = torch.cumsum(dv_steps, -2)
    dv_excl = torch.cat([torch.zeros_like(dv_pref[..., :1, :]),
                         dv_pref[..., :-1, :]], -2)
    dp = torch.sum(dv_excl * dt[..., None]
                   + 0.5 * un_acc * (dt * dt)[..., None], -2)
    dv = dv_pref[..., -1, :]
    dq = dq_pref[..., -1, :]
    sum_dt = torch.sum(dt, -1)
    return dt, R0, R1, a0, a1, un_gyr, dp, dq, dv, sum_dt


def _transition(R0, R1, a0, a1, w, dt):
    """Batched error-state transition F [...,15,15] and noise map V
    [...,15,18] of one midpoint step (integration_base.h:63-139)."""
    shape = dt.shape
    dtype, dev = dt.dtype, dt.device
    dtk = dt[..., None, None]
    dt2k = dtk * dtk
    I3 = torch.eye(3, dtype=dtype, device=dev).expand(shape + (3, 3))
    R_w_x = lie.skew(w)
    R_a_0_x = lie.skew(a0)
    R_a_1_x = lie.skew(a1)
    Rw = I3 - R_w_x * dtk
    R1a1 = R1 @ R_a_1_x
    # Buffers from a tensor of the computation (R1a1 depends on every
    # input), so that they are batched under vmap whenever an input is.
    F = R1a1.new_zeros(shape + (15, 15))
    F[..., O_P:O_P + 3, O_P:O_P + 3] = I3
    F[..., O_P:O_P + 3, O_R:O_R + 3] = (-0.25 * R0 @ R_a_0_x * dt2k
                                        + (-0.25) * R1a1 @ Rw * dt2k)
    F[..., O_P:O_P + 3, O_V:O_V + 3] = I3 * dtk
    F[..., O_P:O_P + 3, O_BA:O_BA + 3] = -0.25 * (R0 + R1) * dt2k
    F[..., O_P:O_P + 3, O_BG:O_BG + 3] = 0.25 * R1a1 * dt2k * dtk
    F[..., O_R:O_R + 3, O_R:O_R + 3] = Rw
    F[..., O_R:O_R + 3, O_BG:O_BG + 3] = -I3 * dtk
    F[..., O_V:O_V + 3, O_R:O_R + 3] = (-0.5 * R0 @ R_a_0_x * dtk
                                        + (-0.5) * R1a1 @ Rw * dtk)
    F[..., O_V:O_V + 3, O_V:O_V + 3] = I3
    F[..., O_V:O_V + 3, O_BA:O_BA + 3] = -0.5 * (R0 + R1) * dtk
    F[..., O_V:O_V + 3, O_BG:O_BG + 3] = 0.5 * R1a1 * dt2k
    F[..., O_BA:O_BA + 3, O_BA:O_BA + 3] = I3
    F[..., O_BG:O_BG + 3, O_BG:O_BG + 3] = I3

    V = R1a1.new_zeros(shape + (15, 18))
    v_01 = -0.125 * R1a1 * dt2k * dtk
    V[..., O_P:O_P + 3, 0:3] = 0.25 * R0 * dt2k
    V[..., O_P:O_P + 3, 3:6] = v_01
    V[..., O_P:O_P + 3, 6:9] = 0.25 * R1 * dt2k
    V[..., O_P:O_P + 3, 9:12] = v_01
    V[..., O_R:O_R + 3, 3:6] = 0.5 * I3 * dtk
    V[..., O_R:O_R + 3, 9:12] = 0.5 * I3 * dtk
    V[..., O_V:O_V + 3, 0:3] = 0.5 * R0 * dtk
    v_21 = -0.25 * R1a1 * dt2k
    V[..., O_V:O_V + 3, 3:6] = v_21
    V[..., O_V:O_V + 3, 6:9] = 0.5 * R1 * dtk
    V[..., O_V:O_V + 3, 9:12] = v_21
    V[..., O_BA:O_BA + 3, 12:15] = I3 * dtk
    V[..., O_BG:O_BG + 3, 15:18] = I3 * dtk
    return F, V


def propagate(chunk: ImuChunk, linearized_ba: torch.Tensor,
              linearized_bg: torch.Tensor, imu: ImuConfig) -> Preintegration:
    """Integrate chunk(s) into a Preintegration at the given biases (the
    reference's propagate, and repropagate with updated biases)."""
    ba, bg = linearized_ba, linearized_bg
    (dt, R0, R1, a0, a1, un_gyr, dp, dq, dv, sum_dt) = \
        _delta_prefixes(chunk, ba, bg)
    F_all, V_all = _transition(R0, R1, a0, a1, un_gyr, dt)
    Qn = noise_covariance(imu, dt.dtype, dt.device)
    Q_all = V_all @ Qn @ V_all.transpose(-1, -2)

    def compose(x, y):
        A1, B1 = x
        A2, B2 = y
        return A2 @ A1, A2 @ B1 @ A2.transpose(-1, -2) + B2

    ax = F_all.dim() - 3
    J_pref, P_pref = _inclusive_scan((F_all, Q_all), compose, ax)
    return Preintegration(dp, dq, dv, J_pref[..., -1, :, :],
                          P_pref[..., -1, :, :], sum_dt, ba, bg)


def propagate_sequential(chunk: ImuChunk, linearized_ba: torch.Tensor,
                         linearized_bg: torch.Tensor,
                         imu: ImuConfig) -> Preintegration:
    """The reference-order sequential integration (integration_base.h:
    141-169): one midpoint step per sample, in a Python loop over the
    sample axis. Kept as the numeric reference for `propagate`, as in the
    JAX module."""
    ba, bg = linearized_ba, linearized_bg
    dtype, dev = chunk.acc.dtype, chunk.acc.device
    batch = chunk.dt.shape[:-1]
    Qn = noise_covariance(imu, dtype, dev)
    dp = torch.zeros(batch + (3,), dtype=dtype, device=dev)
    dv = torch.zeros_like(dp)
    dq = lie.quat_identity(dtype, dev).expand(batch + (4,))
    J = torch.eye(15, dtype=dtype, device=dev).expand(batch + (15, 15))
    P = torch.zeros(batch + (15, 15), dtype=dtype, device=dev)
    sum_dt = torch.zeros(batch, dtype=dtype, device=dev)
    acc0, gyr0 = chunk.acc[..., 0, :], chunk.gyr[..., 0, :]
    # Row 0 only seeds acc0/gyr0; rows 1..N-1 integrate.
    for s in range(1, chunk.dt.shape[-1]):
        dt, acc1, gyr1 = chunk.dt[..., s], chunk.acc[..., s, :], \
            chunk.gyr[..., s, :]
        dtk = dt[..., None]
        un_acc_0 = lie.quat_rotate(dq, acc0 - ba)
        un_gyr = 0.5 * (gyr0 + gyr1) - bg
        dq_new = lie.quat_normalize(lie.quat_mul(
            dq, lie.delta_q(un_gyr * dtk)))
        un_acc = 0.5 * (un_acc_0 + lie.quat_rotate(dq_new, acc1 - ba))
        dp = dp + dv * dtk + 0.5 * un_acc * dtk * dtk
        dv = dv + un_acc * dtk
        F, V = _transition(lie.quat_to_rotmat(dq),
                           lie.quat_to_rotmat(dq_new), acc0 - ba, acc1 - ba,
                           un_gyr, dt)
        J = F @ J
        P = F @ P @ F.transpose(-1, -2) + V @ Qn @ V.transpose(-1, -2)
        sum_dt = sum_dt + dt
        dq, acc0, gyr0 = dq_new, acc1, gyr1
    return Preintegration(dp, dq, dv, J, P, sum_dt, ba, bg)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", M, v)


def evaluate(pre: Preintegration, p_i, q_i, v_i, ba_i, bg_i,
             p_j, q_j, v_j, ba_j, bg_j,
             gravity: torch.Tensor) -> torch.Tensor:
    """15-dim residual with first-order bias correction
    (integration_base.h:171-198)."""
    J = pre.jacobian
    dp_dba = J[..., O_P:O_P + 3, O_BA:O_BA + 3]
    dp_dbg = J[..., O_P:O_P + 3, O_BG:O_BG + 3]
    dq_dbg = J[..., O_R:O_R + 3, O_BG:O_BG + 3]
    dv_dba = J[..., O_V:O_V + 3, O_BA:O_BA + 3]
    dv_dbg = J[..., O_V:O_V + 3, O_BG:O_BG + 3]
    dba = ba_i - pre.linearized_ba
    dbg = bg_i - pre.linearized_bg

    corrected_dq = lie.quat_mul(pre.dq, lie.delta_q(_mv(dq_dbg, dbg)))
    corrected_dv = pre.dv + _mv(dv_dba, dba) + _mv(dv_dbg, dbg)
    corrected_dp = pre.dp + _mv(dp_dba, dba) + _mv(dp_dbg, dbg)

    dt = pre.sum_dt[..., None]
    q_i_inv = lie.quat_conj(q_i)
    r_p = lie.quat_rotate(
        q_i_inv, 0.5 * gravity * dt * dt + p_j - p_i - v_i * dt
    ) - corrected_dp
    r_q = 2.0 * lie.quat_mul(lie.quat_conj(corrected_dq),
                             lie.quat_mul(q_i_inv, q_j))[..., 1:]
    r_v = lie.quat_rotate(q_i_inv, gravity * dt + v_j - v_i) - corrected_dv
    return torch.cat([r_p, r_q, r_v, ba_j - ba_i, bg_j - bg_i], -1)


def sqrt_information(pre: Preintegration, eps: float = 1e-8) -> torch.Tensor:
    """Upper-triangular whitening chol(P⁻¹)ᵀ of the (regularized)
    covariance (imu_factor.h:72)."""
    P = pre.covariance + eps * torch.eye(15, dtype=pre.covariance.dtype,
                                         device=pre.covariance.device)
    # The _ex forms do not sync the device to check errors; a failed
    # factorization is NaN, as jnp.linalg.cholesky returns.
    info = torch.linalg.inv_ex(P)[0]
    info = 0.5 * (info + info.transpose(-1, -2))
    L, err = torch.linalg.cholesky_ex(info)
    L = torch.where((err == 0)[..., None, None], L, float("nan"))
    return L.transpose(-1, -2)


def propagate_state(p, q, v, ba, bg, chunk: ImuChunk,
                    gravity: torch.Tensor):
    """World-frame dead reckoning over a chunk, from the body-frame deltas
    composed with constant gravity. Returns (p, q, v)."""
    _, _, _, _, _, _, dp, dq, dv, sdt = _delta_prefixes(chunk, ba, bg)
    R_i = lie.quat_to_rotmat(q)
    sdt = sdt[..., None]
    p_j = p + v * sdt - 0.5 * gravity * sdt * sdt + _mv(R_i, dp)
    v_j = v - gravity * sdt + _mv(R_i, dv)
    q_j = lie.quat_normalize(lie.quat_mul(q, dq))
    return p_j, q_j, v_j
