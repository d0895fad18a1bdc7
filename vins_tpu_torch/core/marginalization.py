"""Schur-complement marginalization into the dense linearized prior
(port of vins_tpu/core/marginalization.py), the window shifts, and the
IMU chunk merge of a non-keyframe slide."""
from __future__ import annotations

import torch

from ..config import VinsConfig
from . import preintegration as pre_mod
from .factors import cauchy_weight, imu_factor_local, projection_factor_local
from .solver import WindowProblem, _edge_slices, _place_blocks
from .state import PriorFactor, WindowState, state_boxminus


def _eigh(A: torch.Tensor):
    """torch.linalg.eigh that propagates NaN like jnp.linalg.eigh: a
    non-finite input (e.g. after a failed factorization upstream) yields
    NaN eigenpairs instead of raising."""
    finite = torch.all(torch.isfinite(A))
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    w, V = torch.linalg.eigh(torch.where(finite, A, eye))
    return (torch.where(finite, w, float("nan")),
            torch.where(finite, V, float("nan")))


def _chol_ok(L: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    return (info == 0) & torch.all(torch.isfinite(L))


# The ridges _schur adds in turn to the dropped block scaled to a unit
# diagonal, and the hold of the bootstrap prior in every kept direction,
# as a fraction of the largest diagonal entry of its information (the
# 100x ridge of _info_to_sqrt's "chol"): port departures (ROADMAP item
# 31).
SCHUR_RIDGES = (1e-6, 1e-4, 1.0)
BOOT_HOLD = 1e-4


def _schur(Arr: torch.Tensor, Arm: torch.Tensor, Amm: torch.Tensor,
           g_r: torch.Tensor, g_m: torch.Tensor):
    """(Arr − Arm Amm⁻¹ Armᵀ, g_r − Arm Amm⁻¹ g_m) through the Cholesky
    factor of the dropped block scaled to a unit diagonal: S = diag(Amm)^-½
    (1 on a row without information), L Lᵀ = S Amm S + 1e-6·I,
    B = L⁻¹ S Armᵀ, b = L⁻¹ S g_m, the complement Arr − BᵀB and g_r − Bᵀb.

    The reference eliminates the block with an eigen pseudo-inverse that
    inverts every eigenvalue above 1e-8 (marginalization_factor.cpp:
    270-284): its eigenvalues carry float32 round-off of the block's
    largest entry, which a weakly observed direction of the dropped frame
    (a bias) passes into the kept block, and that round-off sets the kept
    block's weakest directions and which factorization _info_to_sqrt takes
    (ROADMAP item 31). Scaled to a unit diagonal, each variable's round-off
    is relative to its own information; the ridge there is a prior of a
    millionth of each dropped variable's information, and Arr − BᵀB is
    symmetric and semidefinite to the round-off of Arr's entries.

    Where round-off leaves S Amm S indefinite by more than that ridge, the
    Cholesky fails, and L is the factor of the next ridge of SCHUR_RIDGES
    that succeeds (counted as "schur_retry"); the last, 1, is each
    dropped variable's own information, which a block semidefinite to
    within round-off never fails; past it (a non-finite block) the
    complement is NaN. The partial factor torch leaves would otherwise
    become the complement. Every ridge is factored on every call, so the
    choice reads nothing back to the host."""
    Ams = 0.5 * (Amm + Amm.T)
    d = torch.diagonal(Ams)
    s = torch.where(d > 0, torch.rsqrt(torch.clamp(d, min=1e-30)), 1.0)
    As = Ams * s[:, None] * s[None, :]
    I = torch.eye(As.shape[0], dtype=As.dtype, device=As.device)
    rhs = torch.cat([Arm.T, g_m[:, None]], 1) * s[:, None]
    L = torch.full_like(As, float("nan"))
    for ridge in reversed(SCHUR_RIDGES):
        L_r, info = torch.linalg.cholesky_ex(As + ridge * I)
        ok = _chol_ok(L_r, info)
        L = torch.where(ok, L_r, L)
    _count((~ok)[None], at=3)          # ok: the first ridge's factor
    B = torch.linalg.solve_triangular(L, rhs, upper=False)
    B, b = B[:, :-1], B[:, -1]
    return Arr - B.T @ B, g_r - B.T @ b


# Per-device int64 counts, one per BRANCHES entry: the priors
# _info_to_sqrt factorized with the ridge, with the 100x ridge and through
# the eigen fallback, and the Schur complements _schur formed past its
# first ridge; None (the default) counts nothing. count_prior_branches()
# switches it on.
BRANCHES = ("ridge", "ridge_100x", "fallback", "schur_retry")
_BRANCH_COUNTS = None


def count_prior_branches(on: bool = True) -> None:
    """Start (or stop) counting the branches of _info_to_sqrt and _schur,
    on the device of each prior and without a host read; prior_branches()
    reads them. Priors formed under torch.func.vmap are not counted."""
    global _BRANCH_COUNTS
    _BRANCH_COUNTS = {} if on else None


def prior_branches() -> dict:
    """{"ridge": n, "ridge_100x": n, "fallback": n, "schur_retry": n}
    summed over devices since count_prior_branches() (one host read per
    device)."""
    tot = [0] * len(BRANCHES)
    for c in (_BRANCH_COUNTS or {}).values():
        tot = [a + int(b) for a, b in zip(tot, c.tolist())]
    return dict(zip(BRANCHES, tot))


def _count(flags: torch.Tensor, at: int = 0) -> None:
    """Add the bool flags to the counts of BRANCHES[at:]."""
    if _BRANCH_COUNTS is None or torch._C._functorch.is_batchedtensor(flags):
        return
    c = _BRANCH_COUNTS.get(flags.device)
    if c is None:
        c = _BRANCH_COUNTS[flags.device] = torch.zeros(
            len(BRANCHES), dtype=torch.int64, device=flags.device)
    c[at:at + flags.shape[0]] += flags.to(torch.int64)


def _info_to_sqrt(H: torch.Tensor, g: torch.Tensor, eps: float,
                  method: str = "chol"):
    """(H, g) -> (J0, r0) with J0ᵀJ0 ≈ H and J0ᵀ r0 = g: eigen-sqrt with
    clamping ("eigh"), or a ridge Cholesky ("chol", retried with a 100x
    ridge c where the first factorization fails).

    Where both Cholesky factorizations fail (the float32 H indefinite by
    more than c), "chol" takes the eigen-sqrt of Hs + cI with its
    eigenvalues floored at the float32 round-off of Hs's entries (1e-7
    of the largest diagonal entry): the square root of the nearest matrix
    that the 100x ridge makes positive definite. It keeps the ridge in
    every direction, as the 100x-ridge factor does, and a round-off
    change of H across the point where that factorization stops
    succeeding moves the prior's solve no more than the same change does
    on the Cholesky side, where the solve grows as 1/λ_min(Hs + cI)
    towards that point. The reference returns NaN there
    (jnp.linalg.cholesky's failure value), and the partial factor torch
    leaves would otherwise become the prior."""
    Hs = 0.5 * (H + H.T)
    w, V = _eigh(Hs) if method == "eigh" else (None, None)

    def eig_sqrt(w, V, floor):
        keep = w > floor
        s = torch.sqrt(torch.where(keep, w, 1.0))
        s_inv = torch.where(keep, 1.0 / s, 0.0)
        s = torch.where(keep, s, 0.0)
        return s[:, None] * V.T, (s_inv[:, None] * V.T) @ g

    if method == "eigh":
        return eig_sqrt(w, V, eps)
    n = Hs.shape[0]
    I = torch.eye(n, dtype=Hs.dtype, device=Hs.device)
    d_max = torch.max(torch.abs(torch.diagonal(Hs)))
    ridge = eps + 1e-6 * d_max
    L1, info1 = torch.linalg.cholesky_ex(Hs + ridge * I)
    L2, info2 = torch.linalg.cholesky_ex(Hs + (100.0 * ridge) * I)
    ok1, ok2 = _chol_ok(L1, info1), _chol_ok(L2, info2)
    _count(torch.stack([ok1, ~ok1 & ok2, ~(ok1 | ok2)]))
    L = torch.where(ok1, L1, L2)
    r0 = torch.linalg.solve_triangular(L, g[:, None], upper=False)[:, 0]
    w, V = _eigh(Hs)
    J_e, r_e = eig_sqrt(torch.clamp(w + 100.0 * ridge,
                                    min=eps + 1e-7 * d_max), V, 0.0)
    ok = ok1 | ok2
    return torch.where(ok, L.T, J_e), torch.where(ok, r0, r_e)


def _shift(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[1:], x[-1:]], 0)


def marginalize_old(state: WindowState, prob: WindowProblem,
                    cfg: VinsConfig, bootstrap: bool = False) -> PriorFactor:
    """Marginalize frame 0 and the landmarks anchored there; the prior
    comes back in the shifted frame indexing (VINS.cpp:690-776).

    bootstrap (BackendState.bootstrap: an empty prior and an unsolved
    window) holds every kept direction at BOOT_HOLD times the largest
    diagonal entry. Nothing else holds the position and yaw,
    which VIO cannot observe, or the velocities and biases that no factor
    of frame 0 reaches; the reference holds them with whichever ridge its
    float32 round-off lets _info_to_sqrt take (the 100x ridge, or none:
    a NaN prior), the port at that 100x ridge on every host."""
    F, M = prob.feats.mask.shape
    D = 15 * F
    dtype, dev = state.p.dtype, state.p.device
    feats = prob.feats
    ar = lambda n: torch.arange(n, device=dev)

    dx = state_boxminus(state, prob.prior)
    r_p = (prob.prior.r + prob.prior.J @ dx) * prob.prior.weight
    J_p = torch.nn.functional.pad(prob.prior.J * prob.prior.weight, (0, M))

    # IMU edge 0, whitened at its own preintegration.
    pre0 = pre_mod.Preintegration(*[x[:1] for x in prob.preints])
    S0 = pre_mod.sqrt_information(pre0)
    r_i, J_i = imu_factor_local(pre0, *[x[:1] for x in _edge_slices(state)],
                                prob.gravity, S0)
    J_i_full = torch.nn.functional.pad(J_i[0], (0, D + M - 30))

    # Projection factors anchored at frame 0, compacted valid-first.
    fj_g = ar(F).repeat_interleave(M)
    mm_g = ar(M).repeat(F)
    anchor = feats.anchor.long()
    w_grid = (feats.valid[mm_g] & (anchor[mm_g] == 0)
              & feats.mask[fj_g, mm_g] & feats.mask[0, mm_g] & (fj_g != 0))
    K = min(cfg.solver.max_proj_factors, F * M)
    n = fj_g.shape[0]
    score = w_grid.to(dtype) * (2.0 * n) - torch.arange(n, dtype=dtype,
                                                        device=dev)
    order = torch.topk(score, K).indices
    fj, mm = fj_g[order], mm_g[order]
    w_valid = w_grid[order].to(dtype)
    zK = torch.zeros_like(fj)
    r_pr, J_pr = projection_factor_local(
        feats.obs[zK, mm], feats.obs[fj, mm], state.p[zK], state.q[zK],
        state.p[fj], state.q[fj], state.inv_depth[mm], prob.ext,
        prob.sqrt_info_proj)
    okm = w_valid[:, None] > 0
    r_pr = torch.where(okm, r_pr, 0.0)
    J_pr = torch.where(okm[:, :, None], J_pr, 0.0)
    w_rob = cauchy_weight(r_pr, cfg.solver.cauchy_c) * w_valid[:, None]
    r_pr = r_pr * w_rob
    J_pr = J_pr * w_rob[:, :, None]
    cols = torch.cat([ar(6)[None, :].expand(K, 6),
                      15 * fj[:, None] + ar(6)[None, :],
                      D + mm[:, None]], 1)
    J_pr_full = _place_blocks(J_pr, cols, D + M).reshape(2 * K, D + M)

    J_all = torch.cat([J_p, J_i_full, J_pr_full], 0)
    r_all = torch.cat([r_p, r_i[0], r_pr.reshape(-1)])
    H = J_all.T @ J_all
    g = J_all.T @ r_all

    lm_dropped = (feats.valid & (anchor == 0)).to(dtype)
    h_ll = torch.diagonal(H[D:, D:])
    inv_hll = torch.where((lm_dropped > 0) & (h_ll > 1e-10), 1.0 / h_ll, 0.0)
    H_dl = H[:D, D:]
    H_pose = H[:D, :D] - (H_dl * inv_hll[None, :]) @ H_dl.T
    g_pose = g[:D] - H_dl @ (inv_hll * g[D:])

    H_keep, g_keep = _schur(H_pose[15:, 15:], H_pose[15:, :15],
                            H_pose[:15, :15], g_pose[15:], g_pose[:15])
    if bootstrap:
        d_max = torch.max(torch.abs(torch.diagonal(H_keep)))
        H_keep = H_keep + (BOOT_HOLD * d_max) * torch.eye(
            D - 15, dtype=dtype, device=dev)

    J0s, r0s = _info_to_sqrt(H_keep, g_keep, cfg.solver.eig_eps,
                             cfg.solver.marg_sqrt)
    J0 = J0s.new_zeros((D, D))
    J0[:D - 15, :D - 15] = J0s
    r0 = r0s.new_zeros((D,))
    r0[:D - 15] = r0s
    return PriorFactor(J=J0, r=r0, lin_p=_shift(state.p),
                       lin_q=_shift(state.q), lin_v=_shift(state.v),
                       lin_ba=_shift(state.ba), lin_bg=_shift(state.bg),
                       weight=torch.ones((), dtype=dtype, device=dev))


def marginalize_second_new(state: WindowState, prior: PriorFactor,
                           cfg: VinsConfig) -> PriorFactor:
    """Drop the second-newest pose (6 dims) from the prior
    (VINS.cpp:778-830); the linearization point becomes the current
    state with slot F-2 taking the newest frame's values."""
    F = prior.lin_p.shape[0]
    D = 15 * F
    dev = prior.J.device
    H = prior.J.T @ prior.J * prior.weight
    dx = state_boxminus(state, prior)
    r_now = prior.r + prior.J @ dx
    g = prior.J.T @ r_now * prior.weight

    lo = 15 * (F - 2)
    drop = torch.arange(lo, lo + 6, device=dev)
    keep = torch.cat([torch.arange(lo, device=dev),
                      torch.arange(lo + 6, D, device=dev)])
    Amm = H[drop[:, None], drop[None, :]]
    Arm = H[keep[:, None], drop[None, :]]
    Arr = H[keep[:, None], keep[None, :]]
    H_keep, g_keep = _schur(Arr, Arm, Amm, g[keep], g[drop])
    J0k, r0k = _info_to_sqrt(H_keep, g_keep, cfg.solver.eig_eps,
                             cfg.solver.marg_sqrt)
    J0 = J0k.new_zeros((D, D))
    J0[keep[:, None], keep[None, :]] = J0k
    r0 = r0k.new_zeros((D,))
    r0[keep] = r0k

    def swap_last(x):
        x = x.clone()
        x[F - 2] = x[F - 1]
        return x

    return PriorFactor(J=J0, r=r0, lin_p=swap_last(state.p),
                       lin_q=swap_last(state.q), lin_v=swap_last(state.v),
                       lin_ba=swap_last(state.ba),
                       lin_bg=swap_last(state.bg), weight=prior.weight)


def slide_state_old(state: WindowState) -> WindowState:
    """Shift every frame down one; the newest slot duplicates the last."""
    return WindowState(p=_shift(state.p), q=_shift(state.q),
                       v=_shift(state.v), ba=_shift(state.ba),
                       bg=_shift(state.bg), inv_depth=state.inv_depth)


def slide_state_new(state: WindowState) -> WindowState:
    """Drop the second-newest frame: slot F-2 <- slot F-1."""
    def sw(x):
        x = x.clone()
        x[-2] = x[-1]
        return x
    return WindowState(p=sw(state.p), q=sw(state.q), v=sw(state.v),
                       ba=sw(state.ba), bg=sw(state.bg),
                       inv_depth=state.inv_depth)


def merge_chunks(a: pre_mod.ImuChunk,
                 b: pre_mod.ImuChunk) -> pre_mod.ImuChunk:
    """Append b's valid rows (its seed row dropped) after a's into the same
    fixed buffer; on overflow, pairwise-average a's rows first
    (slideWindowNew's preintegration merge, VINS.cpp:1269-1293)."""
    N = a.dt.shape[0]
    dev = a.dt.device
    b_valid = b.dt[1:] > 0

    def write(dst, src_rows, idx, valid):
        idx_c = torch.where(valid & (idx < N), idx, N)
        w = valid.to(src_rows.dtype).reshape((-1,) + (1,) * (src_rows.dim()
                                                             - 1))
        ext = torch.cat([dst, torch.zeros_like(dst[:1])], 0)
        ext.index_add_(0, idx_c, src_rows * w)
        return ext[:-1]

    def append(base):
        n = torch.sum(base.dt > 0) + 1
        idx = n + torch.arange(N - 1, device=dev)
        return pre_mod.ImuChunk(write(base.dt, b.dt[1:], idx, b_valid),
                                write(base.acc, b.acc[1:], idx, b_valid),
                                write(base.gyr, b.gyr[1:], idx, b_valid))

    total = torch.sum(a.dt > 0) + 1 + torch.sum(b_valid)
    no_compact = append(a)

    dt_a, acc_a, gyr_a = a.dt[1:], a.acc[1:], a.gyr[1:]
    h = (N - 1) // 2
    dt_m = dt_a[0:2 * h:2] + dt_a[1:2 * h:2]
    w0 = torch.where(dt_m > 0, dt_a[0:2 * h:2] / torch.clamp(dt_m,
                                                             min=1e-12), 0.5)
    w1 = 1.0 - w0
    acc_m = acc_a[0:2 * h:2] * w0[:, None] + acc_a[1:2 * h:2] * w1[:, None]
    gyr_m = gyr_a[0:2 * h:2] * w0[:, None] + gyr_a[1:2 * h:2] * w1[:, None]
    dt2 = torch.zeros_like(a.dt)
    dt2[1:1 + h] = dt_m
    acc2 = torch.zeros_like(a.acc)
    acc2[0] = a.acc[0]
    acc2[1:1 + h] = acc_m
    gyr2 = torch.zeros_like(a.gyr)
    gyr2[0] = a.gyr[0]
    gyr2[1:1 + h] = gyr_m
    compact = append(pre_mod.ImuChunk(dt2, acc2, gyr2))

    overflow = total > N
    return pre_mod.ImuChunk(*[torch.where(overflow, y, x)
                              for x, y in zip(no_compact, compact)])
