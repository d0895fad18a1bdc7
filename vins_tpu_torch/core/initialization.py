"""Visual-inertial initialization (port of vins_tpu/core/initialization.py).

The bootstrap chain of VINS::solveInitial + visualInitialAlign: relative
pose seeding by essential RANSAC and cheirality, global SfM (two-view
seed, PnP chaining, DLT triangulation sweeps, a full LM bundle
adjustment with frame l fixed), gyro-bias least squares and
repropagation, the linear velocity/gravity/scale solve and the tangent
gravity refinement, then the gravity-aligned, scaled window. It runs
once per (re)bootstrap as a host-orchestrated sequence of small tensor
programs; the host decisions (`bool(...)`, `float(...)`) stay where the
reference makes them, one device sync each.
"""
from __future__ import annotations

import enum
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import VinsConfig
from ..ops import ransac as ransac_mod
from ..utils import lie
from . import feature_manager as fm
from . import preintegration as pre_mod
from .factors import Extrinsics
from .solver import WindowProblem, solve_window
from .state import FeatureTable, PriorFactor, WindowState


class InitStatus(enum.Enum):
    SUCCESS = 0
    FAIL_IMU = 1        # insufficient IMU excitation
    FAIL_PARALLAX = 2   # no frame pair with enough parallax
    FAIL_RELATIVE = 3   # relative pose recovery failed
    FAIL_SFM = 4        # SfM BA diverged
    FAIL_PNP = 5        # PnP chaining failed
    FAIL_ALIGN = 6      # gravity/scale alignment failed
    FAIL_CHECK = 7      # final cost above acceptance threshold


def find_reference_frame(feats: FeatureTable, focal: float,
                         min_corres: int = 20,
                         min_parallax_px: float = 30.0) -> Tuple[int, bool]:
    """The earliest frame l with enough correspondences and mean parallax
    to the newest frame (VINS.cpp:1104-1145). Returns (l, ok) on the
    host."""
    F = feats.mask.shape[0]
    newest = F - 1
    both = feats.mask & feats.mask[newest][None, :]
    n_corr = torch.sum(both, 1)
    d = feats.obs - feats.obs[newest][None]
    par = torch.sqrt(torch.sum(d * d, -1)) * both
    mean_par = torch.sum(par, 1) / torch.clamp(n_corr, min=1)
    ok = (n_corr >= min_corres) & (mean_par * focal >= min_parallax_px)
    ok = ok.cpu().numpy()
    ok[newest] = False
    l = int(ok.argmax())          # the first True, as jnp.argmax picks it
    return l, bool(ok[l])


class SfmResult(NamedTuple):
    # World (= camera l) from camera f: x_w = R x_c + t.
    R_wc: torch.Tensor     # [F, 3, 3]
    t_wc: torch.Tensor     # [F, 3]
    pts_w: torch.Tensor    # [M, 3] SfM-scale points
    pts_ok: torch.Tensor   # [M]


def _triangulate_pair_grid(obs_a, obs_b, R_a, t_a, R_b, t_b):
    """DLT triangulation of [M] points from two world-from-camera poses;
    slots the caller masks out get whatever the SVD gives."""
    rows = []
    for R, t, o in ((R_a, t_a, obs_a), (R_b, t_b, obs_b)):
        P = torch.cat([R.T, (-R.T @ t)[:, None]], 1)         # [3, 4]
        rows.append(o[:, 0:1] * P[2] - P[0])
        rows.append(o[:, 1:2] * P[2] - P[1])
    X = torch.linalg.svd(torch.stack(rows, 1))[2][:, -1]     # [M, 4]
    w = X[:, 3:]
    return X[:, :3] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)


def _depth_in(R, t, X):
    return ((X - t[None]) @ R)[:, 2]


def global_sfm(feats: FeatureTable, l: int, R_rel: torch.Tensor,
               t_rel: torch.Tensor, cfg: VinsConfig
               ) -> Tuple[Optional[SfmResult], InitStatus]:
    """Vision-only structure from motion over the init window
    (GlobalSFM::construct, inital_sfm.cpp:117-316). Frame l is the world;
    the newest frame's pose comes from the essential decomposition
    (x_new = R_rel x_l + t_rel). PnP chains forward l -> newest and
    backward l -> 0 with triangulation sweeps, then an LM bundle
    adjustment over every pose but frame l's and every point, with the
    dense forward-mode Jacobian the reference takes."""
    F, M = feats.mask.shape
    newest = F - 1
    obs = feats.obs
    dtype, dev = obs.dtype, obs.device

    R_all = torch.eye(3, dtype=dtype, device=dev).repeat(F, 1, 1)
    t_all = torch.zeros((F, 3), dtype=dtype, device=dev)
    R_all[newest] = R_rel.T
    t_all[newest] = -R_rel.T @ t_rel
    pts_w = torch.zeros((M, 3), dtype=dtype, device=dev)
    pts_ok = torch.zeros((M,), dtype=torch.bool, device=dev)

    def tri(a, b):
        nonlocal pts_w, pts_ok
        pair = feats.mask[a] & feats.mask[b] & feats.valid & ~pts_ok
        X = _triangulate_pair_grid(obs[a], obs[b], R_all[a], t_all[a],
                                   R_all[b], t_all[b])
        good = (pair & (_depth_in(R_all[a], t_all[a], X) > 0.1)
                & (_depth_in(R_all[b], t_all[b], X) > 0.1))
        pts_w = torch.where(good[:, None], X, pts_w)
        pts_ok = pts_ok | good

    def pnp(f, init_from):
        nonlocal R_all, t_all
        usable = feats.mask[f] & pts_ok
        p, q, msr = ransac_mod.pnp_gn(
            pts_w, obs[f], usable, t_all[init_from],
            lie.rotmat_to_quat(R_all[init_from]), iters=12)
        ok = ((torch.sum(usable) >= 6) & torch.isfinite(msr)
              & (msr <= cfg.init_pnp_max_msr))
        R_all = R_all.clone()
        t_all = t_all.clone()
        R_all[f] = torch.where(ok, lie.quat_to_rotmat(q), R_all[f])
        t_all[f] = torch.where(ok, p, t_all[f])
        return bool(ok)

    tri(l, newest)
    for f in range(l + 1, newest):
        if not pnp(f, f - 1):
            return None, InitStatus.FAIL_PNP
        tri(f, newest)
    for f in range(l + 1, newest):
        tri(l, f)
    for f in range(l - 1, -1, -1):
        if not pnp(f, f + 1):
            return None, InitStatus.FAIL_PNP
        tri(f, l)
    for f in range(F - 1):
        tri(f, f + 1)

    if int(torch.sum(pts_ok)) < 15:
        return None, InitStatus.FAIL_SFM

    # Full bundle adjustment (inital_sfm.cpp:234-293).
    q0 = lie.rotmat_to_quat(R_all)
    t0 = t_all
    w = (feats.mask & feats.valid[None, :] & pts_ok[None, :]).to(dtype)
    free = torch.ones((F, 1), dtype=dtype, device=dev)
    free[l].zero_()

    def pack_residual(delta):
        tw, qw = lie.pose_retract(t0, q0, delta[:F * 6].reshape(F, 6) * free)
        X = pts_w + delta[F * 6:].reshape(M, 3)
        Xc = lie.quat_rotate(lie.quat_conj(qw)[:, None], X[None] - tw[:, None])
        z = Xc[..., 2:3]
        z = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
        return ((Xc[..., :2] / z - obs) * w[..., None]).reshape(-1)

    n = F * 6 + M * 3
    eye = torch.eye(n, dtype=dtype, device=dev)
    delta = torch.zeros(n, dtype=dtype, device=dev)
    lam = 1e-3
    cost = float(torch.sum(pack_residual(delta) ** 2))
    for _ in range(10):
        r = pack_residual(delta)
        J = torch.func.jacfwd(pack_residual)(delta)
        H = J.T @ J
        g = J.T @ r
        dn = torch.linalg.solve_ex(
            H + lam * (torch.diag(torch.diagonal(H)) + 1e-6 * eye), -g)[0]
        cand = delta + dn
        c2 = float(torch.sum(pack_residual(cand) ** 2))
        if math.isfinite(c2) and c2 < cost:
            delta, cost, lam = cand, c2, max(lam * 0.3, 1e-7)
        else:
            lam = min(lam * 10.0, 1e3)
    mean_sq = cost / max(float(torch.sum(w)), 1.0)
    if not math.isfinite(mean_sq) or mean_sq > 1e-3:
        return None, InitStatus.FAIL_SFM

    t_fin, q_fin = lie.pose_retract(t0, q0,
                                    delta[:F * 6].reshape(F, 6) * free)
    return SfmResult(R_wc=lie.quat_to_rotmat(q_fin), t_wc=t_fin,
                     pts_w=pts_w + delta[F * 6:].reshape(M, 3),
                     pts_ok=pts_ok), InitStatus.SUCCESS


def solve_gyro_bias(q_bodies: torch.Tensor,
                    preints: pre_mod.Preintegration) -> torch.Tensor:
    """Least-squares gyro bias from rotation consistency over the edges
    (solveGyroscopeBias, initial_aligment.cpp:10-44)."""
    O_R, O_BG = pre_mod.O_R, pre_mod.O_BG
    J = preints.jacobian[:, O_R:O_R + 3, O_BG:O_BG + 3]          # [W,3,3]
    q_ij = lie.quat_mul(lie.quat_conj(q_bodies[:-1]), q_bodies[1:])
    dq = lie.quat_mul(lie.quat_conj(preints.dq), q_ij)
    r = 2.0 * dq[:, 1:]
    Jt = J.transpose(-1, -2)
    A = torch.sum(Jt @ J, 0) + 1e-8 * torch.eye(3, dtype=J.dtype,
                                                 device=J.device)
    b = torch.sum((Jt @ r[..., None])[..., 0], 0)
    return torch.linalg.solve_ex(A, b)[0]


def _edge_rows(p_cam, R_body, preints, tic_body, basis=None, g=None):
    """Per-edge row blocks H [W, 6, 3+3+k+1] and z [W, 6] of the
    alignment systems over (v_e, v_e+1, gravity or its tangent, scale),
    each term evaluated in the reference's order; with basis (the
    refinement), gravity enters through its 2-dof tangent around g."""
    W = p_cam.shape[0] - 1
    dt = preints.sum_dt[:, None, None]
    Ri = R_body[:W].transpose(-1, -2)
    Rij = Ri @ R_body[1:]
    eye = torch.eye(3, dtype=p_cam.dtype, device=p_cam.device)
    k = 3 if basis is None else 2
    H = torch.zeros((W, 6, 7 + k), dtype=p_cam.dtype, device=p_cam.device)
    H[:, 0:3, 0:3] = -dt * eye
    H[:, 3:6, 0:3] = -eye
    H[:, 3:6, 3:6] = Rij
    H[:, 0:3, 6 + k] = (Ri @ (p_cam[1:] - p_cam[:-1])[..., None])[..., 0] \
        / 100.0
    z_p = preints.dp + (Rij @ tic_body) - tic_body
    z_v = preints.dv
    if basis is None:
        H[:, 0:3, 6:9] = 0.5 * Ri * dt * dt
        H[:, 3:6, 6:9] = Ri * dt
    else:
        H[:, 0:3, 6:8] = 0.5 * Ri @ basis * dt * dt
        H[:, 3:6, 6:8] = Ri @ basis * dt
        Rig = Ri @ g
        z_p = z_p - 0.5 * Rig * dt[:, 0] * dt[:, 0]
        z_v = z_v - Rig * dt[:, 0]
    return H, torch.cat([z_p, z_v], 1)


def _normal_equations(H, z, n):
    """Σ 1000·HᵀH and Σ 1000·Hᵀz over the edges, scattered into an
    n-unknown system at (v_e, v_e+1, the shared tail) by one batched
    accumulate."""
    W, _, m = H.shape
    dev = H.device
    e = torch.arange(W, device=dev)
    a3 = torch.arange(3, device=dev)
    tail = n - (m - 6)
    idx = torch.cat([3 * e[:, None] + a3, 3 * (e[:, None] + 1) + a3,
                     (tail + torch.arange(m - 6, device=dev)).expand(W, -1)],
                    1)                                          # [W, m]
    Ht = H.transpose(-1, -2)
    A = torch.zeros((n, n), dtype=H.dtype, device=dev).index_put_(
        (idx[:, :, None].expand(W, m, m), idx[:, None, :].expand(W, m, m)),
        Ht @ H * 1000.0, accumulate=True)
    b = torch.zeros((n,), dtype=H.dtype, device=dev).index_put_(
        (idx,), (Ht @ z[..., None])[..., 0] * 1000.0, accumulate=True)
    # The 1e-8 ridge is below fp32 resolution at these weights; kept as
    # the reference has it.
    return A + 1e-8 * torch.eye(n, dtype=H.dtype, device=dev), b


def linear_alignment(p_cam: torch.Tensor, R_body: torch.Tensor,
                     preints: pre_mod.Preintegration,
                     tic_body: torch.Tensor, g_mag: float):
    """Linear solve for the body-frame velocities, gravity in the SfM
    world and the metric scale (SolveScale, initial_aligment.cpp:135-219;
    the scale column conditioned by /100 as :162). p_cam: [F, 3] SfM
    camera positions; R_body: [F, 3, 3] body orientations in the SfM
    world. Returns (v_body [F, 3], g_c0 [3], scale, ok)."""
    F = p_cam.shape[0]
    n = 3 * F + 4
    H, z = _edge_rows(p_cam, R_body, preints, tic_body)
    A, b = _normal_equations(H, z, n)
    x = torch.linalg.solve_ex(A, b)[0]
    g_c0 = x[3 * F:3 * F + 3]
    scale = x[3 * F + 3] / 100.0
    ok = ((torch.abs(torch.sqrt(torch.sum(g_c0 * g_c0)) - g_mag) < 1.0)
          & (scale > 0))
    return x[:3 * F].reshape(F, 3), g_c0, scale, ok


def refine_gravity(p_cam, R_body, preints, tic_body, g_mag, g0,
                   iters: int = 4):
    """Gravity refined on its 2-dof tangent (RefineGravity,
    initial_aligment.cpp:62-133). Returns (v, g, scale)."""
    F = p_cam.shape[0]
    n = 3 * F + 3
    norm = lambda x: torch.sqrt(torch.sum(x * x))
    g = g0 / norm(g0) * g_mag
    v = torch.zeros((F, 3), dtype=p_cam.dtype, device=p_cam.device)
    scale = torch.ones((), dtype=p_cam.dtype, device=p_cam.device)
    ex = torch.zeros(3, dtype=g.dtype, device=g.device)
    ez = torch.zeros(3, dtype=g.dtype, device=g.device)
    ex[:1].fill_(1.0)
    ez[2:].fill_(1.0)
    for _ in range(iters):
        a = g / norm(g)
        b1 = lie.cross(a, torch.where(torch.abs(a[2]) > 0.9, ex, ez))
        b1 = b1 / norm(b1)
        basis = torch.stack([b1, lie.cross(a, b1)], 1)           # [3, 2]
        H, z = _edge_rows(p_cam, R_body, preints, tic_body, basis, g)
        A, bb = _normal_equations(H, z, n)
        x = torch.linalg.solve_ex(A, bb)[0]
        dg = basis @ x[3 * F:3 * F + 2]
        g = (g + dg) / norm(g + dg) * g_mag
        v = x[:3 * F].reshape(F, 3)
        scale = x[3 * F + 2] / 100.0
    return v, g, scale


def refine_init_window(window: WindowState, feats: FeatureTable,
                       chunks: pre_mod.ImuChunk, ext: Extrinsics,
                       cfg: VinsConfig, rounds: int = 3):
    """Joint visual-inertial refinement of the freshly aligned window, the
    reference's accepting solve after visualInitialAlign
    (VINS.cpp:415-443): solve/re-triangulate rounds pull the alignment's
    scale along its LM valley; the caller gates on the final cost.
    Returns (window, final_cost)."""
    F = cfg.window.num_frames
    W = F - 1
    dev = window.p.device
    gravity = torch.zeros(3, dtype=window.p.dtype, device=dev)
    gravity[2:].fill_(cfg.imu.gravity)
    cost = torch.zeros((), dtype=window.p.dtype, device=dev)
    for _ in range(rounds):
        preints = pre_mod.propagate(chunks, window.ba[:W], window.bg[:W],
                                    cfg.imu)
        prob = WindowProblem(
            feats=feats, preints=preints,
            prior=PriorFactor.empty(F, device=dev), ext=ext, gravity=gravity,
            sqrt_info_proj=torch.full((), cfg.camera.focal / 1.5,
                                      device=dev),
            frame_free=torch.ones(F, dtype=window.p.dtype, device=dev))
        window, stats = solve_window(window, prob, cfg)
        window = fm.triangulate(window, feats, ext, cfg)
        cost = stats.final_cost
    return window, cost


def _camera_relative_rotation(dq_edges: torch.Tensor, l: int, newest: int,
                              ext: Extrinsics) -> torch.Tensor:
    """Gyro-preintegrated camera rotation from frame l to `newest`: the
    body increments of edges l .. newest-1 composed, conjugated by the
    extrinsic rotation (x_newest ≈ R x_l, as recover_pose returns it)."""
    q = lie.quat_identity(dq_edges.dtype, dq_edges.device)
    for e in range(l, newest):
        q = lie.quat_mul(q, dq_edges[e])
    R_b = lie.quat_to_rotmat(q)
    R_ic = lie.quat_to_rotmat(ext.qic)
    return R_ic.T @ R_b.T @ R_ic


def _imu_excitation(dv: torch.Tensor, sum_dt: torch.Tensor) -> torch.Tensor:
    """Stddev of the per-edge mean specific force Δv/Δt over edges with a
    nonzero span (the reference's aver_g/var check, VINS.cpp:839-858)."""
    ok = sum_dt > 1e-6
    g_edge = dv / torch.clamp(sum_dt[:, None], min=1e-6)
    n = torch.clamp(torch.sum(ok), min=1)
    mean_g = torch.sum(torch.where(ok[:, None], g_edge, 0.0), 0) / n
    d2 = torch.sum((g_edge - mean_g) ** 2, -1)
    return torch.sqrt(torch.sum(torch.where(ok, d2, 0.0)) / n)


def _propagate_zero_bias(chunks: pre_mod.ImuChunk, cfg: VinsConfig):
    W = chunks.dt.shape[0]
    z = torch.zeros((W, 3), dtype=chunks.acc.dtype, device=chunks.acc.device)
    return pre_mod.propagate(chunks, z, z, cfg.imu)


def imu_excitation(chunks: pre_mod.ImuChunk, cfg: VinsConfig) -> float:
    """The excitation statistic of a stacked [W]-edge chunk set."""
    pre = _propagate_zero_bias(chunks, cfg)
    return float(_imu_excitation(pre.dv, pre.sum_dt))


class InitResult(NamedTuple):
    window: WindowState
    status: InitStatus


def initialize(feats: FeatureTable, chunks: pre_mod.ImuChunk,
               ext: Extrinsics, cfg: VinsConfig, seed: int = 0,
               gumbel: Optional[torch.Tensor] = None) -> InitResult:
    """Bootstrap the metric window from observations and raw IMU
    (VINS::solveInitial + visualInitialAlign, VINS.cpp:833-1102): the
    excitation gate, SfM in the camera-l frame, gyro bias and
    repropagation, alignment, then the world rotated so gravity is +z
    with zero yaw at frame 0, the scale applied and the depths
    triangulated. The essential RANSAC's Gumbel noise [n_hyps, M] is
    `gumbel`, or drawn from a generator seeded with `seed` (the same draw
    on every attempt, as the reference reuses its seed-0 key)."""
    F, M = feats.mask.shape
    W = F - 1
    newest = F - 1
    dtype, dev = feats.obs.dtype, feats.obs.device
    fail = lambda s: InitResult(WindowState.identity(F, M, dtype, dev), s)

    # 0. IMU excitation gate: a static or constant-velocity window leaves
    #    the scale unobservable.
    pre0 = _propagate_zero_bias(chunks, cfg)
    if cfg.init_min_acc_var > 0:
        acc_var = float(_imu_excitation(pre0.dv, pre0.sum_dt))
        if not math.isfinite(acc_var) or acc_var < cfg.init_min_acc_var:
            return fail(InitStatus.FAIL_IMU)

    # 1. Reference frame and relative pose.
    l, ok = find_reference_frame(feats, cfg.camera.focal)
    if not ok:
        return fail(InitStatus.FAIL_PARALLAX)
    pair = feats.mask[l] & feats.mask[newest] & feats.valid
    gen = None
    if gumbel is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    res = ransac_mod.ransac_essential(
        feats.obs[l], feats.obs[newest], pair, cfg.frontend.f_ransac_hyps,
        (1.0 / cfg.camera.focal) ** 2 * 9.0, gumbel=gumbel, generator=gen)
    R_rel, t_rel, n_good = ransac_mod.recover_pose(
        res.model, feats.obs[l], feats.obs[newest], res.inliers)

    # Planar-degeneracy guard: where the visual rotation disagrees with
    # the gyro's (the 8-point essential has a solution family on coplanar
    # scenes), re-seed with the gyro rotation and the known-rotation
    # translation solve.
    R_gyro = _camera_relative_rotation(pre0.dq, l, newest, ext)
    ang = torch.sqrt(torch.sum(lie.so3_log(lie.rotmat_to_quat(
        R_rel @ R_gyro.T)) ** 2))
    if float(ang) > math.radians(cfg.init_max_gyro_visual_deg):
        t_g, n_good_g = ransac_mod.translation_known_rotation(
            R_gyro, feats.obs[l], feats.obs[newest], res.inliers)
        R_rel, t_rel, n_good = R_gyro, t_g, n_good_g
    if int(n_good) < 12:
        return fail(InitStatus.FAIL_RELATIVE)

    # 2. Global SfM (camera poses in the frame-l camera world).
    sfm, status = global_sfm(feats, l, R_rel, t_rel, cfg)
    if sfm is None:
        return fail(status)

    # 3. Body poses in the SfM world: T_wb = T_wc · T_cb.
    R_ic = lie.quat_to_rotmat(ext.qic)
    R_body = sfm.R_wc @ R_ic.T
    p_cam = sfm.t_wc

    # 4. Gyro bias and repropagation.
    bg = solve_gyro_bias(lie.rotmat_to_quat(R_body), pre0)
    if float(torch.sqrt(torch.sum(bg * bg))) > 1.0:
        return fail(InitStatus.FAIL_ALIGN)
    pre1 = pre_mod.propagate(chunks, torch.zeros_like(pre0.linearized_ba),
                             bg[None].expand(W, 3), cfg.imu)

    # 5. Linear alignment: velocities, gravity (SfM frame), scale.
    v_b, g_c0, scale, align_ok = linear_alignment(
        p_cam, R_body, pre1, ext.tic, cfg.imu.gravity)
    if not bool(align_ok):
        return fail(InitStatus.FAIL_ALIGN)
    v_b, g_c0, scale = refine_gravity(p_cam, R_body, pre1, ext.tic,
                                      cfg.imu.gravity, g_c0)
    if float(scale) <= 0:
        return fail(InitStatus.FAIL_ALIGN)

    # 6. World rotated so gravity is +z, zero yaw at frame 0, scale
    #    applied (VINS.cpp:1046-1099).
    R0 = lie.gravity_to_rotmat(g_c0)
    yaw0 = lie.rotmat_to_ypr(R0 @ R_body[0])[0]
    zero = torch.zeros_like(yaw0)
    Rw = lie.ypr_to_rotmat(torch.stack([-yaw0, zero, zero])) @ R0
    # Metric body positions s·p_cam − R_wb·tic in the levelled world,
    # zeroed at frame 0; velocities from the body frames to the world.
    p_b = scale * p_cam - torch.einsum("fij,j->fi", R_body, ext.tic)
    p_w = torch.einsum("ij,fj->fi", Rw, p_b)
    p_w = p_w - p_w[0:1]
    R_w = torch.einsum("ij,fjk->fik", Rw, R_body)
    v_w = torch.einsum("fij,fj->fi", R_w, v_b)
    window = WindowState(
        p=p_w, q=lie.rotmat_to_quat(R_w), v=v_w,
        ba=torch.zeros((F, 3), dtype=dtype, device=dev),
        bg=bg[None].repeat(F, 1),
        inv_depth=torch.zeros((M,), dtype=dtype, device=dev))
    return InitResult(fm.triangulate(window, feats, ext, cfg),
                      InitStatus.SUCCESS)
