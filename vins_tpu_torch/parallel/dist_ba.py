"""Schur-complement bundle adjustment, on one device or with the
landmarks sharded over a torch.distributed mesh (port of
vins_tpu/parallel/dist_ba.py).

Per LM iteration: per landmark-keyframe residuals and their Jacobians
(forward mode over the 9-dim pose-and-point tangent), the block-diagonal
pose-pose normal equations, the landmark blocks eliminated by batched 3x3
inverses (S = Σ_l B_l Hpp_l⁻¹ B_lᵀ), the reduced camera system (6K x 6K)
solved by Cholesky, and the landmark back-substitution. The accept/reject
of each step is a torch.where on the state: a solve runs its fixed
iteration count without a host decision. Poses are gauge-fixed through
per-pose freeze flags; an optional position prior keeps the IMU-metric
scale (BAProblem).

solve_ba_sharded splits the landmarks, their observations and masks over
the mesh's `block` axis and replicates the poses and the prior. Each rank
builds its shard's part of the reduced camera system; one all_reduce of a
packed [6K·6K + 6K + 1] buffer (H_s, g_s, cost) sums it, where the JAX
module psums the three, and a second all_reduce sums the candidate's
cost: two collectives per LM iteration. The prior is added after the
reduction, every rank solves the same 6K x 6K system, and the landmark
back-substitution stays local. global_ba_follower is how the ranks that
do not own the keyframe DB join LoopCloser.global_ba(mesh=...).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.func import jvp, vmap

from ..utils import lie
from .mesh import BLOCK_AXIS, axis_index, axis_size, shard_leading


class BAProblem(NamedTuple):
    """Dense observation grid of L landmarks over K keyframes.

    obs[l, k]: normalized camera-plane observation of landmark l in
    keyframe k; mask[l, k] ∈ {0, 1}; pose_free[k]: 1 free, 0 fixed (gauge
    anchors). prior_p, prior_w: an optional position prior pulling every
    free pose toward prior_p (residual rows w·(p − p⁰)); in a mono BA the
    metric scale is otherwise observable only through the anchors."""

    obs: torch.Tensor        # [L, K, 2]
    mask: torch.Tensor       # [L, K] float
    pose_free: torch.Tensor  # [K]
    prior_p: Optional[torch.Tensor] = None   # [K, 3]
    prior_w: Optional[torch.Tensor] = None   # [] weight per meter


class BAState(NamedTuple):
    p: torch.Tensor      # [K, 3] camera positions (world)
    q: torch.Tensor      # [K, 4] wxyz world-from-camera
    pts: torch.Tensor    # [L, 3] landmark world points


def _residual_lk(X, obs, p, q):
    """Reprojection residual of landmarks X in cameras (p, q), batched."""
    Xc = lie.quat_rotate(lie.quat_conj(q), X - p)
    z = Xc[..., 2:3]
    z_safe = torch.where(torch.abs(z) < 1e-4,
                         torch.where(z < 0, -1e-4, 1e-4), z)
    return Xc[..., :2] / z_safe - obs


def _landmark_blocks(state: BAState, prob: BAProblem):
    """Masked residuals r [L, K, 2] and Jacobians Jc [L, K, 2, 6] (pose
    tangent, frozen poses zeroed) and Jp [L, K, 2, 3] (point)."""
    L, K = prob.mask.shape
    X = state.pts[:, None, :].expand(L, K, 3)
    p = state.p[None].expand(L, K, 3)
    q = state.q[None].expand(L, K, 4)

    def local(d):
        pp, qq = lie.pose_retract(p, q, d[..., :6])
        return _residual_lk(X + d[..., 6:9], prob.obs, pp, qq)

    zero = torch.zeros((L, K, 9), dtype=state.p.dtype, device=state.p.device)
    basis = torch.eye(9, dtype=zero.dtype, device=zero.device)[
        :, None, None, :].expand(9, L, K, 9)
    r = local(zero)
    J = vmap(lambda t: jvp(local, (zero,), (t,))[1])(basis)  # [9, L, K, 2]
    J = J.permute(1, 2, 3, 0)                                 # [L, K, 2, 9]
    m = prob.mask[..., None, None]
    Jc = J[..., :6] * m * prob.pose_free[None, :, None, None]
    return r * prob.mask[..., None], Jc, J[..., 6:9] * m


def _block_diag(blocks: torch.Tensor) -> torch.Tensor:
    """[K, 6, 6] -> [6K, 6K] block-diagonal."""
    K = blocks.shape[0]
    eye = torch.eye(K, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("kij,kl->kilj", blocks, eye).reshape(K * 6, K * 6)


def _local_normal_eqs(state: BAState, prob: BAProblem):
    """(H_cc [6K, 6K], g_c [6K], S [6K, 6K], gs_corr [6K], Hpp_inv
    [L, 3, 3], B [L, 6K, 3], g_p [L, 3], cost [])."""
    L, K = prob.mask.shape
    r, Jc, Jp = _landmark_blocks(state, prob)
    # Within a landmark, different k rows never share a pose column, so
    # H_cc is block-diagonal per pose.
    Hcc_k = torch.einsum("lkri,lkrj->kij", Jc, Jc)
    g_c = torch.einsum("lkri,lkr->ki", Jc, r).reshape(K * 6)
    Hpp = torch.einsum("lkri,lkrj->lij", Jp, Jp) + 1e-8 * torch.eye(
        3, dtype=Jp.dtype, device=Jp.device)
    g_p = torch.einsum("lkri,lkr->li", Jp, r)
    B = torch.einsum("lkri,lkrj->lkij", Jc, Jp).reshape(L, K * 6, 3)
    Hpp_inv = torch.linalg.inv_ex(Hpp)[0]
    BH = B @ Hpp_inv                                          # [L, 6K, 3]
    S = torch.einsum("lia,lja->ij", BH, B)
    gs_corr = torch.einsum("lia,la->i", BH, g_p)
    cost = 0.5 * torch.sum(r * r)
    return _block_diag(Hcc_k), g_c, S, gs_corr, Hpp_inv, B, g_p, cost


def _lm_iteration(state: BAState, prob: BAProblem, lam: torch.Tensor,
                  group=None):
    """One damped LM step: the candidate state and the current cost. A
    failed Cholesky gives a NaN step (rejected by the caller). The prior
    fields are set (_materialize_prior). With a process group, H_s, g_s
    and the cost are summed over its landmark shards in one all_reduce."""
    K = prob.mask.shape[1]
    Hcc, g_c, S, gs_corr, Hpp_inv, B, g_p, cost = _local_normal_eqs(
        state, prob)
    H_s = Hcc - S
    g_s = g_c - gs_corr
    if group is not None:
        n = H_s.numel()
        buf = torch.cat([H_s.reshape(-1), g_s, cost.reshape(1)])
        dist.all_reduce(buf, group=group)
        H_s, g_s, cost = buf[:n].reshape(H_s.shape), buf[n:-1], buf[-1]
    # The prior is replicated: added after the reduction so that the
    # shards do not multiply it.
    w2 = prob.prior_w * prob.prior_w
    diag = torch.zeros((K, 6), dtype=H_s.dtype, device=H_s.device)
    diag[:, :3] = (w2 * prob.pose_free)[:, None]
    H_s = H_s + torch.diag(diag.reshape(-1))
    dp = (state.p - prob.prior_p) * prob.pose_free[:, None]
    g_add = torch.zeros_like(diag)
    g_add[:, :3] = w2 * dp
    g_s = g_s + g_add.reshape(-1)
    # Damping plus a floor: frozen poses have zeroed columns, and the
    # absolute term keeps their rows positive definite.
    d = torch.diagonal(H_s)
    H_d = H_s + torch.diag(lam * d + 1e-6 + lam)
    L_chol, info = torch.linalg.cholesky_ex(H_d)
    dx_c = -torch.cholesky_solve(g_s[:, None], L_chol)[:, 0]
    dx_c = torch.where(info == 0, dx_c, torch.full_like(dx_c, float("nan")))
    rhs = g_p + torch.einsum("lia,i->la", B, dx_c)
    dx_p = -torch.einsum("lab,lb->la", Hpp_inv, rhs)
    d_pose = dx_c.reshape(K, 6) * prob.pose_free[:, None]
    p_new, q_new = lie.pose_retract(state.p, state.q, d_pose)
    return BAState(p=p_new, q=q_new, pts=state.pts + dx_p), cost


def _ba_cost(state: BAState, prob: BAProblem, group=None) -> torch.Tensor:
    # The residuals of _landmark_blocks at a zero step: through
    # pose_retract, which renormalizes q.
    p, q = lie.pose_retract(state.p, state.q, torch.zeros_like(state.p)
                            .repeat(1, 2))
    r = _residual_lk(state.pts[:, None, :], prob.obs, p[None],
                     q[None]) * prob.mask[..., None]
    c = 0.5 * torch.sum(r * r)
    if group is not None:
        c = c.reshape(1)
        dist.all_reduce(c, group=group)
        c = c[0]
    dp = (state.p - prob.prior_p) * prob.pose_free[:, None]
    return c + 0.5 * (prob.prior_w ** 2) * torch.sum(dp * dp)


def _solve_ba_core(state: BAState, prob: BAProblem, iters: int,
                   group=None):
    lam = torch.tensor(1e-4, dtype=state.p.dtype, device=state.p.device)
    cost = _ba_cost(state, prob, group)
    hist = []
    for _ in range(iters):
        cand, _ = _lm_iteration(state, prob, lam, group)
        new_cost = _ba_cost(cand, prob, group)
        good = torch.isfinite(new_cost) & (new_cost < cost)
        state = BAState(*(torch.where(good, b, a)
                          for a, b in zip(state, cand)))
        cost = torch.where(good, new_cost, cost)
        lam = torch.clamp(torch.where(good, lam * 0.3, lam * 10.0),
                          1e-9, 1e3)
        hist.append(cost)
    return state, cost, torch.stack(hist)


def _materialize_prior(state: BAState, prob: BAProblem) -> BAProblem:
    """Absent prior fields as an inert (zero-weight) prior."""
    if prob.prior_p is not None:
        return prob
    return prob._replace(prior_p=torch.zeros_like(state.p),
                         prior_w=torch.zeros((), dtype=state.p.dtype,
                                             device=state.p.device))


def solve_ba(state: BAState, prob: BAProblem, iters: int = 10):
    """LM Schur BA on one device. Returns (state, final cost, per-iteration
    costs [iters]), all on the state's device."""
    return _solve_ba_core(state, _materialize_prior(state, prob), iters)


def solve_ba_sharded(state: BAState, prob: BAProblem, mesh, iters: int = 10):
    """The landmark-sharded BA over the mesh's `block` axis, called by every
    rank of the block group with the same full problem. L must divide by
    the block size (harvest.pad_landmarks_to pads it). Returns (state,
    final cost, per-iteration costs [iters]): the poses, the costs and
    all the points, in landmark order, the same on every rank."""
    prob = _materialize_prior(state, prob)
    group = mesh.get_group(BLOCK_AXIS)
    n = axis_size(mesh, BLOCK_AXIS)
    st, cost, hist = _solve_ba_core(
        state._replace(pts=shard_leading(state.pts, mesh, BLOCK_AXIS)),
        prob._replace(obs=shard_leading(prob.obs, mesh, BLOCK_AXIS),
                      mask=shard_leading(prob.mask, mesh, BLOCK_AXIS)),
        iters, group)
    # The shards gathered in landmark order: an all_reduce of the
    # zero-padded shards (exact; gloo reduces CUDA tensors but does not
    # gather them).
    c = st.pts.shape[0]
    i = axis_index(mesh, BLOCK_AXIS)
    pts = st.pts.new_zeros((n * c, 3))
    pts[i * c:(i + 1) * c] = st.pts
    dist.all_reduce(pts, group=group)
    return st._replace(pts=pts), cost, hist


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on for the mesh's backend."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def share_ba_problem(mesh, state: Optional[BAState] = None,
                     prob: Optional[BAProblem] = None, iters: int = 0):
    """Broadcast a BA problem and its LM iteration count from the first
    rank of this rank's block group (which passes them; no state for "no
    problem") to the others (which pass nothing and allocate on
    mesh_device). One broadcast of the sizes and the count, one of the
    packed values. Returns (state, prob, iters) with the prior
    materialized, or None on every rank."""
    group = mesh.get_group(BLOCK_AXIS)
    src = dist.get_global_rank(group, 0)
    owner = dist.get_rank() == src
    dev = (state.p.device if owner and state is not None
           else mesh_device(mesh))
    if owner and state is not None:
        prob = _materialize_prior(state, prob)
        L, K = prob.mask.shape
    else:
        L = K = iters = 0
    sizes = torch.tensor([L, K, iters], dtype=torch.int64, device=dev)
    dist.broadcast(sizes, src, group=group)
    L, K, iters = (int(v) for v in sizes.tolist())
    if K == 0:
        return None
    shapes = [(K, 3), (K, 4), (L, 3), (L, K, 2), (L, K), (K,), (K, 3), ()]
    if owner:
        buf = torch.cat([t.reshape(-1).to(torch.float32) for t in (
            *state, prob.obs, prob.mask, prob.pose_free, prob.prior_p,
            prob.prior_w)])
    else:
        n = sum(torch.Size(s).numel() for s in shapes)
        buf = torch.empty(n, dtype=torch.float32, device=dev)
    dist.broadcast(buf, src, group=group)
    vals, o = [], 0
    for s in shapes:
        c = torch.Size(s).numel()
        vals.append(buf[o:o + c].reshape(s))
        o += c
    return (BAState(*vals[:3]),
            BAProblem(obs=vals[3], mask=vals[4], pose_free=vals[5],
                      prior_p=vals[6], prior_w=vals[7]), iters)


def global_ba_follower(mesh):
    """The part of LoopCloser.global_ba(mesh=...) that a rank without the
    keyframe DB runs: receive the padded problem and the iteration count
    from its block group's first rank and solve its landmark shard.
    Returns the final cost, or None when the map had no problem to
    solve."""
    shared = share_ba_problem(mesh)
    if shared is None:
        return None
    state, prob, iters = shared
    _, cost, _ = solve_ba_sharded(state, prob, mesh, iters=iters)
    return float(cost)
