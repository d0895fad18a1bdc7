"""4-DoF (x, y, z, yaw) pose-graph optimization (port of
vins_tpu/loop/pose_graph.py).

Per node the unknowns are a translation and a yaw; pitch and roll stay at
their VIO values. Sequential edges join each node to its n_back
predecessors, measured from the ORIGIN (raw odometry) poses; loop edges
are weighted relative-pose constraints (weight 0 = inactive, x5 in the
residual).

The JAX module differentiates the whole residual vector with jax.jacfwd
over all 4K unknowns (a dense ~10.5k x 2048 Jacobian at K = 512). Each
residual touches two nodes, so here every edge's 4 x 8 block is written
in closed form and the normal equations H = JᵀJ, g = Jᵀr are assembled
by scattering the 8 x 8 blocks, then solved by Cholesky as in the JAX LM
loop (fixed iteration count, accept-if-lower, λ x0.3 / x10).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils import lie


class PoseGraph(NamedTuple):
    """Fixed-capacity 4-DoF pose graph."""

    t: torch.Tensor          # [K, 3] node translations (optimized)
    yaw: torch.Tensor        # [K] node yaw (optimized)
    pitch: torch.Tensor      # [K] frozen pitch
    roll: torch.Tensor       # [K] frozen roll
    node_ok: torch.Tensor    # [K] bool
    t_origin: torch.Tensor   # [K, 3] raw odometry (sequential measurements)
    yaw_origin: torch.Tensor  # [K]
    loop_i: torch.Tensor     # [E] int32 earlier (old) node
    loop_j: torch.Tensor     # [E] int32 later (new) node
    loop_t: torch.Tensor     # [E, 3] measured t_ij in node i's frame
    loop_yaw: torch.Tensor   # [E] measured relative yaw
    loop_w: torch.Tensor     # [E] weight (0 = inactive)

    @staticmethod
    def empty(K: int, E: int, dtype=torch.float32,
              device="cpu") -> "PoseGraph":
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
        return PoseGraph(
            t=z(K, 3), yaw=z(K), pitch=z(K), roll=z(K),
            node_ok=torch.zeros(K, dtype=torch.bool, device=device),
            t_origin=z(K, 3), yaw_origin=z(K), loop_i=zi(E), loop_j=zi(E),
            loop_t=z(E, 3), loop_yaw=z(E), loop_w=z(E))


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def _node_rot(yaw, pitch, roll):
    return lie.ypr_to_rotmat(torch.stack([yaw, pitch, roll], -1))


def _node_rot_dyaw(yaw, pitch, roll):
    """d ypr_to_rotmat / d yaw, [..., 3, 3]."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    z = torch.zeros_like(yaw)
    m = torch.stack([
        -sy * cp, -sy * sp * sr - cy * cr, -sy * sp * cr + cy * sr,
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        z, z, z], -1)
    return m.reshape(yaw.shape + (3, 3))


def sequential_measurements(g: PoseGraph, n_back: int = 5):
    """(j, i, t_ij in frame i, yaw_ij, weight) of every node j to each of
    its n_back predecessors i = j - d, from the ORIGIN poses; weight 0
    where i < 0 or a node is empty."""
    K = g.t.shape[0]
    dev = g.t.device
    js = torch.arange(K, device=dev).repeat_interleave(n_back)
    ds = torch.arange(1, n_back + 1, device=dev).repeat(K)
    i_raw = js - ds
    i = torch.clamp(i_raw, min=0)
    ok = (i_raw >= 0) & g.node_ok[js] & g.node_ok[i]
    Ri = _node_rot(g.yaw_origin[i], g.pitch[i], g.roll[i])
    t_ij = torch.einsum("eji,ej->ei", Ri, g.t_origin[js] - g.t_origin[i])
    yaw_ij = g.yaw_origin[js] - g.yaw_origin[i]
    return (js.to(torch.int32), i.to(torch.int32), t_ij, yaw_ij,
            ok.to(g.t.dtype))


def optimize_pose_graph(g: PoseGraph, first_loop_node: int,
                        iters: int = 12, n_back: int = 5
                        ) -> Tuple[PoseGraph, torch.Tensor]:
    """LM over (t, yaw) with the nodes <= first_loop_node and the empty
    slots held fixed. Returns (optimized graph, final cost)."""
    K = g.t.shape[0]
    dtype, dev = g.t.dtype, g.t.device
    seq_j, seq_i, seq_t, seq_yaw, seq_w = sequential_measurements(g, n_back)
    ei = torch.cat([seq_i, g.loop_i]).long()
    ej = torch.cat([seq_j, g.loop_j]).long()
    e_t = torch.cat([seq_t, g.loop_t])
    e_yaw = torch.cat([seq_yaw, g.loop_yaw])
    e_w = torch.cat([seq_w, g.loop_w * 5.0])
    free = ((torch.arange(K, device=dev) > first_loop_node)
            & g.node_ok).to(dtype)
    t0, yaw0 = g.t, g.yaw
    pitch_i, roll_i = g.pitch[ei], g.roll[ei]
    # Columns of each edge's 8 unknowns: node i's (t, yaw), node j's.
    cols = torch.cat([4 * ei[:, None] + torch.arange(4, device=dev),
                      4 * ej[:, None] + torch.arange(4, device=dev)], 1)
    rows_h = cols[:, :, None].expand(-1, 8, 8).reshape(-1)
    cols_h = cols[:, None, :].expand(-1, 8, 8).reshape(-1)

    def unpack(x):
        d = x.reshape(K, 4) * free[:, None]
        return t0 + d[:, :3], yaw0 + d[:, 3]

    def residuals(x):
        t, yaw = unpack(x)
        Ri = _node_rot(yaw[ei], pitch_i, roll_i)
        dt = t[ej] - t[ei]
        r_t = torch.einsum("eji,ej->ei", Ri, dt) - e_t
        r_y = _wrap(yaw[ej] - yaw[ei] - e_yaw)
        return torch.cat([r_t, r_y[:, None]], 1) * e_w[:, None], (yaw, dt)

    def cost_of(x):
        r, _ = residuals(x)
        return 0.5 * torch.sum(r * r)

    def normal_equations(x):
        r, (yaw, dt) = residuals(x)
        E = ei.shape[0]
        RiT = _node_rot(yaw[ei], pitch_i, roll_i).transpose(-1, -2)
        dRiT = _node_rot_dyaw(yaw[ei], pitch_i, roll_i).transpose(-1, -2)
        B = torch.zeros((E, 4, 8), dtype=dtype, device=dev)
        B[:, :3, 0:3] = -RiT
        B[:, :3, 3] = torch.einsum("eij,ej->ei", dRiT, dt)
        B[:, :3, 4:7] = RiT
        B[:, 3, 3] = -1.0
        B[:, 3, 7] = 1.0
        fi, fj = free[ei], free[ej]
        colw = torch.cat([fi[:, None].expand(-1, 4),
                          fj[:, None].expand(-1, 4)], 1)
        B = B * e_w[:, None, None] * colw[:, None, :]
        Hb = torch.einsum("eki,ekj->eij", B, B)
        gb = torch.einsum("eki,ek->ei", B, r)
        H = torch.zeros(4 * K * 4 * K, dtype=dtype, device=dev)
        H.index_add_(0, rows_h * (4 * K) + cols_h, Hb.reshape(-1))
        gvec = torch.zeros(4 * K, dtype=dtype, device=dev)
        gvec.index_add_(0, cols.reshape(-1), gb.reshape(-1))
        return H.reshape(4 * K, 4 * K), gvec

    x = torch.zeros(4 * K, dtype=dtype, device=dev)
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)
    cost = cost_of(x)
    for _ in range(iters):
        H, gvec = normal_equations(x)
        H = H + torch.diag(lam * torch.diagonal(H) + 1e-6 + lam)
        L, _ = torch.linalg.cholesky_ex(H)
        dx = -torch.cholesky_solve(gvec[:, None], L)[:, 0]
        cand = x + dx
        c2 = cost_of(cand)
        good = torch.isfinite(c2) & (c2 < cost)
        x = torch.where(good, cand, x)
        cost = torch.where(good, c2, cost)
        lam = torch.clamp(torch.where(good, lam * 0.3, lam * 10.0), 1e-9,
                          1e3)
    t_f, yaw_f = unpack(x)
    return g._replace(t=t_f, yaw=yaw_f), cost


def drift_from_solution(g_after: PoseGraph, node: int):
    """Cumulative drift correction at `node`, optimized vs ORIGIN pose:
    later raw poses map through p' = R_drift p + t_drift."""
    dyaw = _wrap(g_after.yaw[node] - g_after.yaw_origin[node])
    zero = torch.zeros_like(dyaw)
    R_drift = lie.ypr_to_rotmat(torch.stack([dyaw, zero, zero]))
    t_drift = g_after.t[node] - R_drift @ g_after.t_origin[node]
    return R_drift, t_drift
