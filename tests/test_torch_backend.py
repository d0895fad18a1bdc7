"""vins_tpu_torch's backend layers against the JAX package, on the CPU:
preintegration, the feature manager, the window solve (the loop variant
with an inactive loop, as the stream calls it), marginalization, the
backend step and the dead-reckoned 30 Hz window.

Every problem is the JAX package's synthetic window
(io.synthetic.make_synthetic_window) at a small size, carried into the
port as numpy through vins_tpu_torch.interop, and bootstrapped as
__graft_entry__._example_problem does. JAX's functions are jitted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.config import VinsConfig, WindowConfig
from vins_tpu.core import estimator as j_est
from vins_tpu.core import feature_manager as j_fm
from vins_tpu.core import marginalization as j_marg
from vins_tpu.core import pnp as j_pnp
from vins_tpu.core import preintegration as j_pre
from vins_tpu.core import solver as j_solver
from vins_tpu.core.state import PriorFactor as JPrior
from vins_tpu.io import synthetic as j_syn

import vins_tpu_torch.config as tc
from vins_tpu_torch import interop
from vins_tpu_torch.core import estimator as t_est
from vins_tpu_torch.core import feature_manager as t_fm
from vins_tpu_torch.core import marginalization as t_marg
from vins_tpu_torch.core import pnp as t_pnp
from vins_tpu_torch.core import preintegration as t_pre
from vins_tpu_torch.core import solver as t_solver
from vins_tpu_torch.core.factors import Extrinsics
from vins_tpu_torch.core.state import FeatureTable, PriorFactor, WindowState

torch.set_num_threads(1)

_WIN = dict(window_size=4, max_landmarks=64, max_imu_per_edge=8)
CFG = VinsConfig(window=WindowConfig(**_WIN))
TCFG = tc.VinsConfig(window=tc.WindowConfig(**_WIN))
F = CFG.window.num_frames
M = CFG.window.max_landmarks
_LWIN = dict(_WIN, max_landmarks=192)
LCFG = VinsConfig(window=WindowConfig(**_LWIN))
LTCFG = tc.VinsConfig(window=tc.WindowConfig(**_LWIN))


def _np(x):
    return np.array(jax.device_get(x))   # a writable copy for torch


def _close(a, b, atol, rtol=0.0, msg=""):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(a, _np(b), atol=atol, rtol=rtol, err_msg=msg)


def _normal_eqs(prior):
    """(H, g) = (JᵀJ, Jᵀr) of a prior: the square-root factor of a nearly
    singular H is not unique to float32 round-off, its information is."""
    J = np.asarray(prior.J, np.float64)
    r = np.asarray(prior.r, np.float64)
    return J.T @ J, J.T @ r


def _same_information(t_prior, j_prior, rtol):
    Ht, gt = _normal_eqs(interop.to_numpy(t_prior))
    Hj, gj = _normal_eqs(jax.device_get(j_prior))
    scale = np.abs(Hj).max()
    assert np.abs(Ht - Hj).max() <= rtol * scale
    assert np.abs(gt - gj).max() <= rtol * max(np.abs(gj).max(), 1e-3) * 10
    np.testing.assert_array_equal(np.asarray(t_prior.weight),
                                  _np(j_prior.weight))


def _window_pair(cfg, tcfg, n_landmarks):
    """The JAX synthetic window and its port counterparts."""
    Mc = cfg.window.max_landmarks
    w = j_syn.make_synthetic_window(cfg, n_landmarks=n_landmarks, seed=0,
                                    noise_px=0.3)
    t = dict(
        state=interop.to_torch(jax.device_get(w.state),
                               WindowState.identity(F, Mc)),
        feats=interop.to_torch(jax.device_get(w.feats),
                               FeatureTable.empty(F, Mc)),
        chunks=interop.to_torch(
            jax.device_get(w.chunks),
            t_pre.ImuChunk(*[x[None].repeat((F - 1,) + (1,) * x.dim())
                             for x in t_pre.ImuChunk.empty(
                                 cfg.window.max_imu_per_edge)])),
        ext=Extrinsics(torch.as_tensor(_np(w.ext.tic)),
                       torch.as_tensor(_np(w.ext.qic))),
        gravity=torch.as_tensor(_np(w.gravity)))
    return w, t


@pytest.fixture(scope="module")
def win():
    return _window_pair(CFG, TCFG, 60)


@pytest.fixture(scope="module")
def loop_win():
    """A window whose table holds enough landmarks for an active loop
    block (>= 20 valid old observations)."""
    return _window_pair(LCFG, LTCFG, LCFG.window.max_landmarks)


@pytest.fixture(scope="module")
def booted(win):
    """BackendState.bootstrap on both sides (JAX jitted)."""
    w, t = win
    boot = jax.jit(lambda s, f, c: j_est.BackendState.bootstrap(
        CFG, s, f, c, w.ext, w.gravity))
    est_j = jax.block_until_ready(boot(w.state, w.feats, w.chunks))
    est_t = t_est.BackendState.bootstrap(TCFG, t["state"], t["feats"],
                                         t["chunks"], t["ext"], t["gravity"])
    return est_j, est_t


def test_preintegration_matches_jax(win):
    """propagate (batched over edges, prefix scans over samples), evaluate,
    sqrt_information and propagate_state at non-zero biases. Deltas and
    Jacobians agree to float32 round-off of reordered sums (1e-6 on
    values of order 1); the covariance to 1e-4 relative."""
    w, t = win
    rng = np.random.default_rng(0)
    ba = rng.normal(size=(F - 1, 3)).astype(np.float32) * 0.02
    bg = rng.normal(size=(F - 1, 3)).astype(np.float32) * 0.005
    pj = jax.jit(jax.vmap(lambda c, a, g: j_pre.propagate(c, a, g, CFG.imu)))(
        w.chunks, jnp.asarray(ba), jnp.asarray(bg))
    pt = t_pre.propagate(t["chunks"], torch.as_tensor(ba),
                         torch.as_tensor(bg), TCFG.imu)
    for name in ("dp", "dq", "dv", "jacobian", "sum_dt", "linearized_ba",
                 "linearized_bg"):
        _close(getattr(pt, name), getattr(pj, name), 1e-6, msg=name)
    _close(pt.covariance, pj.covariance, 1e-10, 1e-4, "covariance")
    _close(t_pre.sqrt_information(pt),
           jax.vmap(j_pre.sqrt_information)(pj), 1e-2, 1e-4, "sqrt_info")

    s, st = w.state, t["state"]
    r_j = jax.vmap(lambda pre, *a: j_pre.evaluate(pre, *a, w.gravity))(
        pj, s.p[:-1], s.q[:-1], s.v[:-1], s.ba[:-1], s.bg[:-1], s.p[1:],
        s.q[1:], s.v[1:], s.ba[1:], s.bg[1:])
    r_t = t_pre.evaluate(pt, st.p[:-1], st.q[:-1], st.v[:-1], st.ba[:-1],
                         st.bg[:-1], st.p[1:], st.q[1:], st.v[1:],
                         st.ba[1:], st.bg[1:], t["gravity"])
    _close(r_t, r_j, 1e-5, msg="evaluate")

    c0 = jax.tree.map(lambda x: x[0], w.chunks)
    out_j = j_pre.propagate_state(s.p[0], s.q[0], s.v[0], s.ba[0], s.bg[0],
                                  c0, w.gravity)
    out_t = t_pre.propagate_state(st.p[0], st.q[0], st.v[0], st.ba[0],
                                  st.bg[0],
                                  t_pre.ImuChunk(*[x[0] for x in t["chunks"]]),
                                  t["gravity"])
    for a, b in zip(out_t, out_j):
        _close(a, b, 1e-5, msg="propagate_state")


def test_feature_manager_matches_jax(win):
    """Triangulation of every landmark, the compensated-parallax keyframe
    test, ingest of a frame and both slides (depths to 1e-3 relative: the
    null vector of a float32 SVD per landmark, from noisy observations)."""
    w, t = win
    zero_j = w.state._replace(inv_depth=jnp.zeros(M))
    zero_t = t["state"]._replace(inv_depth=torch.zeros(M))
    tri_j = jax.jit(lambda s, f: j_fm.triangulate(s, f, w.ext, CFG))(
        zero_j, w.feats)
    tri_t = t_fm.triangulate(zero_t, t["feats"], t["ext"], TCFG)
    assert _np(w.feats.valid).sum() >= 8
    _close(tri_t.inv_depth, tri_j.inv_depth, 1e-5, 1e-3, "inv_depth")

    kf_j, par_j = j_fm.keyframe_parallax(w.feats, CFG, CFG.camera.focal)
    kf_t, par_t = t_fm.keyframe_parallax(t["feats"], TCFG,
                                         TCFG.camera.focal)
    assert bool(kf_t) == bool(kf_j)
    _close(par_t, par_j, 1e-3, 1e-5, "parallax")

    # Ingest a permuted, partly new id set into the newest frame.
    rng = np.random.default_rng(1)
    ids = _np(w.feats.track_id).copy()
    ids = ids[rng.permutation(M)]
    ids[:8] = 1000 + np.arange(8)
    obs = rng.uniform(-0.5, 0.5, (M, 2)).astype(np.float32)
    valid = rng.uniform(0, 1, M) > 0.2
    ing_j = j_fm.ingest_frame(w.feats, F - 1, jnp.asarray(ids, jnp.int32),
                              jnp.asarray(obs), jnp.asarray(valid))
    ing_t = t_fm.ingest_frame(t["feats"], F - 1,
                              torch.as_tensor(ids, dtype=torch.int32),
                              torch.as_tensor(obs), torch.as_tensor(valid))
    for name in ing_j._fields:
        _close(getattr(ing_t, name), getattr(ing_j, name), 0.0, msg=name)

    so_j = j_fm.slide_old(w.state, w.feats, w.ext, CFG)
    so_t = t_fm.slide_old(t["state"], t["feats"], t["ext"], TCFG)
    for name in so_j[0]._fields:
        _close(getattr(so_t[0], name), getattr(so_j[0], name), 1e-6,
               msg="slide_old " + name)
    _close(so_t[1], so_j[1], 1e-6, 1e-5, "slide_old inv_depth")
    sn_j = j_fm.slide_new(w.feats)
    sn_t = t_fm.slide_new(t["feats"])
    for name in sn_j._fields:
        _close(getattr(sn_t, name), getattr(sn_j, name), 0.0,
               msg="slide_new " + name)


def _problems(w, t, frame_free=None, cfg=CFG, tcfg=TCFG):
    """The same WindowProblem on both sides, empty prior, inactive loop."""
    M = cfg.window.max_landmarks
    free = np.ones(F, np.float32) if frame_free is None else frame_free
    pre_j = jax.vmap(lambda c, a, g: j_pre.propagate(c, a, g, cfg.imu))(
        w.chunks, w.state.ba[:-1], w.state.bg[:-1])
    pre_t = t_pre.propagate(t["chunks"], t["state"].ba[:-1],
                            t["state"].bg[:-1], tcfg.imu)
    pj = j_solver.WindowProblem(
        feats=w.feats, preints=pre_j,
        prior=JPrior.empty(F),
        ext=w.ext, gravity=w.gravity,
        sqrt_info_proj=jnp.asarray(cfg.camera.focal / 1.5, jnp.float32),
        frame_free=jnp.asarray(free),
        loop=j_solver.LoopProblem(obs_old=jnp.zeros((M, 2)),
                                  ok=jnp.zeros(M, bool),
                                  frame=jnp.zeros((), jnp.int32),
                                  weight=jnp.zeros(())))
    pt = t_solver.WindowProblem(
        feats=t["feats"], preints=pre_t,
        prior=PriorFactor.empty(F),
        ext=t["ext"], gravity=t["gravity"],
        sqrt_info_proj=torch.full((), tcfg.camera.focal / 1.5),
        frame_free=torch.as_tensor(free),
        loop=t_solver.LoopProblem(obs_old=torch.zeros((M, 2)),
                                  ok=torch.zeros(M, dtype=torch.bool),
                                  frame=torch.zeros((), dtype=torch.int32),
                                  weight=torch.zeros(())))
    return pj, pt


def test_solve_window_with_loop_inactive_matches_jax(win):
    """One LM solve of a perturbed window through the loop variant with an
    inactive loop block (the stream's call). Frame 0 is held fixed, as a
    marginalization prior holds it in the stream, so the gauge is pinned.
    Poses within 1e-3 m / 1e-3, costs to 1e-3 relative (fp32 Cholesky of
    the reduced camera system, reordered Jacobian sums); the accepted
    iteration count within one (a last step whose gain is at fp32
    round-off may be taken on one side only)."""
    w, t = win
    rng = np.random.default_rng(2)
    dp = rng.normal(size=(F, 3)).astype(np.float32) * 0.02
    dp[0] = 0.0
    s_j = w.state._replace(p=w.state.p + dp)
    s_t = t["state"]._replace(p=t["state"].p + torch.as_tensor(dp))
    free = np.ones(F, np.float32)
    free[0] = 0.0
    pj, pt = _problems(w, t, free)
    lq = jnp.asarray([1.0, 0.0, 0.0, 0.0])
    solve = jax.jit(lambda s, p: j_solver.solve_window_with_loop(
        s, jnp.zeros(3), lq, p, CFG))
    out_j, _, stats_j = solve(s_j, pj)
    out_t, _, stats_t = t_solver.solve_window_with_loop(
        s_t, torch.zeros(3), torch.tensor([1.0, 0.0, 0.0, 0.0]), pt, TCFG)
    assert abs(int(stats_t.accepted_iters)
               - int(stats_j.accepted_iters)) <= 1
    assert float(stats_t.final_cost) < float(stats_t.initial_cost)
    _close(stats_t.final_cost, stats_j.final_cost, 0.0, 1e-3, "cost")
    _close(stats_t.initial_cost, stats_j.initial_cost, 0.0, 1e-4, "cost0")
    for name in ("p", "q", "v"):
        _close(getattr(out_t, name), getattr(out_j, name), 1e-3, msg=name)
    _close(out_t.inv_depth, out_j.inv_depth, 1e-3, 1e-2, "inv_depth")


def _active_loop(w, n_min=20):
    """An active loop block on the synthetic window: the window's landmarks
    observed (with 1e-3 noise) from an old pose offset from the newest
    frame, and that old pose perturbed as the loop pose's initial value.
    Returns (obs_old [M, 2], ok [M], p_init [3], q_init [4]) as numpy."""
    from vins_tpu.utils import lie as j_lie

    rng = np.random.default_rng(3)
    M = w.feats.mask.shape[1]
    s = w.state
    pts = _np(j_est.landmark_world_points(s, w.feats, w.ext))
    p_old = _np(s.p[F - 1]) + np.array([0.08, -0.05, 0.03], np.float32)
    q_old = _np(j_lie.quat_mul(s.q[F - 1], j_lie.so3_exp_quat(
        jnp.asarray([0.01, -0.02, 0.04], jnp.float32))))
    R_old = _np(j_lie.quat_to_rotmat(jnp.asarray(q_old)))
    R_ic = _np(j_lie.quat_to_rotmat(w.ext.qic))
    pc = ((pts - p_old) @ R_old - _np(w.ext.tic)) @ R_ic
    z = pc[:, 2]
    ok = (_np(w.feats.valid) & (_np(s.inv_depth) > 1e-3) & (z > 0.2)
          & (np.abs(pc[:, :2] / np.maximum(z, 1e-3)[:, None]) < 1.5).all(1))
    assert ok.sum() >= n_min
    obs = np.where(ok[:, None], pc[:, :2] / np.maximum(z, 1e-3)[:, None]
                   + rng.normal(size=(M, 2)) * 1e-3, 0.0).astype(np.float32)
    p_init = (p_old + np.array([0.02, 0.01, -0.02], np.float32))
    q_init = _np(j_lie.quat_mul(jnp.asarray(q_old), j_lie.so3_exp_quat(
        jnp.asarray([-0.01, 0.005, 0.01], jnp.float32))))
    return obs, ok, p_init.astype(np.float32), q_init


def test_solve_window_with_loop_active_matches_jax(loop_win):
    """The window solve with an ACTIVE loop block (weight 1, >= 20 valid
    old observations) and a free loop pose, against the JAX solve, with
    the tolerances of the inactive test: poses and the solved loop pose
    within 1e-3, costs to 1e-3 relative, accepted iterations within one.
    Then one backend_step with the same block as a LoopInput: the refined
    loop constraint (loop_rel_t, loop_rel_yaw) within 1e-3, loop_good and
    loop_support equal."""
    w, t = loop_win
    M = LCFG.window.max_landmarks
    obs, ok, p_init, q_init = _active_loop(w)
    rng = np.random.default_rng(4)
    dp = rng.normal(size=(F, 3)).astype(np.float32) * 0.02
    dp[0] = 0.0
    s_j = w.state._replace(p=w.state.p + dp)
    s_t = t["state"]._replace(p=t["state"].p + torch.as_tensor(dp))
    free = np.ones(F, np.float32)
    free[0] = 0.0
    pj, pt = _problems(w, t, free, LCFG, LTCFG)
    pj = pj._replace(loop=j_solver.LoopProblem(
        obs_old=jnp.asarray(obs), ok=jnp.asarray(ok),
        frame=jnp.zeros((), jnp.int32), weight=jnp.ones(())))
    pt = pt._replace(loop=t_solver.LoopProblem(
        obs_old=torch.as_tensor(obs), ok=torch.as_tensor(ok),
        frame=torch.zeros((), dtype=torch.int32), weight=torch.ones(())))
    # A budget of 4 LM iterations on both sides: the converged tail of
    # this solve takes steps whose gains are at fp32 round-off, and where
    # the stop test fires there depends on that round-off.
    solve = jax.jit(lambda s, p: j_solver.solve_window_with_loop(
        s, jnp.asarray(p_init), jnp.asarray(q_init), p, LCFG,
        iter_budget=4))
    out_j, (lp_j, lq_j), stats_j = solve(s_j, pj)
    out_t, (lp_t, lq_t), stats_t = t_solver.solve_window_with_loop(
        s_t, torch.as_tensor(p_init), torch.as_tensor(q_init), pt, LTCFG,
        iter_budget=4)
    assert abs(int(stats_t.accepted_iters)
               - int(stats_j.accepted_iters)) <= 1
    assert float(stats_t.final_cost) < float(stats_t.initial_cost)
    _close(stats_t.final_cost, stats_j.final_cost, 0.0, 1e-3, "cost")
    _close(stats_t.initial_cost, stats_j.initial_cost, 0.0, 1e-4, "cost0")
    for name in ("p", "q", "v"):
        _close(getattr(out_t, name), getattr(out_j, name), 1e-3, msg=name)
    _close(out_t.inv_depth, out_j.inv_depth, 1e-3, 1e-2, "inv_depth")
    _close(lp_t, lp_j, 1e-3, msg="loop_p")
    _close(lq_t, lq_j, 1e-3, msg="loop_q")

    # The same block through backend_step, from one bootstrapped state.
    est_j = jax.jit(lambda s, f, c: j_est.BackendState.bootstrap(
        LCFG, s, f, c, w.ext, w.gravity))(w.state, w.feats, w.chunks)
    est_t = interop.to_torch(jax.device_get(est_j),
                             t_est.BackendState.fresh(LTCFG))
    obs_frame = F - 1
    ids = _np(est_j.feats.track_id)
    # Slot-align the old observations with the slid landmark table.
    src = {int(i): k for k, i in enumerate(_np(w.feats.track_id))}
    idx = np.array([src.get(int(i), 0) for i in ids])
    ok2 = ok[idx] & (ids >= 0)
    obs2 = np.where(ok2[:, None], obs[idx], 0.0).astype(np.float32)
    assert ok2.sum() >= 20
    loop_j = j_est.LoopInput(
        obs_old=jnp.asarray(obs2), ok=jnp.asarray(ok2),
        ids=jnp.asarray(ids), p_init=jnp.asarray(p_init),
        q_init=jnp.asarray(q_init), ttl=jnp.asarray(F, jnp.int32),
        weight=jnp.ones(()))
    inp_j = j_est.FrameInput(
        chunk=jax.tree.map(lambda x: x[-1], w.chunks), ids=w.feats.track_id,
        obs=w.feats.obs[obs_frame],
        obs_valid=w.feats.mask[obs_frame] & w.feats.valid, loop=loop_j)
    e2_j, o_j = jax.jit(lambda e, i: j_est.backend_step(
        e, i, LCFG, w.ext, w.gravity))(est_j, inp_j)
    inp_t = t_est.FrameInput(
        chunk=interop.to_torch(jax.device_get(inp_j.chunk),
                               t_pre.ImuChunk.empty(
                                   LCFG.window.max_imu_per_edge)),
        ids=torch.as_tensor(_np(inp_j.ids)),
        obs=torch.as_tensor(_np(inp_j.obs)),
        obs_valid=torch.as_tensor(_np(inp_j.obs_valid)),
        loop=interop.to_torch(jax.device_get(loop_j),
                              t_est.LoopInput.inactive(M)))
    e2_t, o_t = t_est.backend_step(est_t, inp_t, LTCFG, est_t_ext(w),
                                   torch.as_tensor(_np(w.gravity)))
    assert bool(o_t.loop_good) == bool(o_j.loop_good) is True
    assert int(o_t.loop_support) == int(o_j.loop_support) >= 10
    assert bool(o_t.failure) == bool(o_j.failure)
    _close(o_t.pose_p, o_j.pose_p, 1e-3, msg="pose_p")
    _close(o_t.loop_rel_t, o_j.loop_rel_t, 1e-3, msg="loop_rel_t")
    _close(o_t.loop_rel_yaw, o_j.loop_rel_yaw, 1e-3, msg="loop_rel_yaw")
    for name in ("p", "q"):
        _close(getattr(e2_t.window, name), getattr(e2_j.window, name), 1e-3,
               msg=name)


def test_marginalization_matches_jax(win):
    """marginalize_old (Schur complement onto the kept frames) and
    marginalize_second_new of the resulting prior: the same information
    (JᵀJ, Jᵀr) to 1e-3 of its largest entry, and the same chunk merge."""
    w, t = win
    pj, pt = _problems(w, t)
    old_j = jax.jit(lambda s, p: j_marg.marginalize_old(s, p, CFG))(
        w.state, pj._replace(loop=None))
    old_t = t_marg.marginalize_old(t["state"], pt._replace(loop=None), TCFG)
    _same_information(old_t, old_j, 1e-3)
    for name in ("lin_p", "lin_q", "lin_v", "lin_ba", "lin_bg"):
        _close(getattr(old_t, name), getattr(old_j, name), 1e-6, msg=name)

    new_j = jax.jit(lambda s, p: j_marg.marginalize_second_new(s, p, CFG))(
        w.state, old_j)
    new_t = t_marg.marginalize_second_new(
        t["state"], interop.to_torch(jax.device_get(old_j), old_t), TCFG)
    _same_information(new_t, new_j, 1e-3)

    a = jax.tree.map(lambda x: x[0], w.chunks)
    b = jax.tree.map(lambda x: x[1], w.chunks)
    m_j = j_marg.merge_chunks(a, b)
    m_t = t_marg.merge_chunks(t_pre.ImuChunk(*[x[0] for x in t["chunks"]]),
                              t_pre.ImuChunk(*[x[1] for x in t["chunks"]]))
    for x, y in zip(m_t, m_j):
        _close(x, y, 0.0)


def test_bootstrap_matches_jax(booted):
    """BackendState.bootstrap: the slid window and table equal, the prior
    carries the same information."""
    est_j, est_t = booted
    for name in ("p", "q", "v", "ba", "bg"):
        _close(getattr(est_t.window, name), getattr(est_j.window, name),
               1e-6, msg=name)
    _close(est_t.window.inv_depth, est_j.window.inv_depth, 1e-6, 1e-5)
    for name in est_j.feats._fields:
        _close(getattr(est_t.feats, name), getattr(est_j.feats, name), 1e-6,
               msg=name)
    _same_information(est_t.prior, est_j.prior, 1e-3)


def test_backend_step_matches_jax(win, booted):
    """One backend_step from the same bootstrapped state (the JAX state
    carried over, so the step alone is compared), with an inactive loop
    as the stream passes it. The window holds fewer than 20 long tracks,
    so the frame is a keyframe and the oldest frame is marginalized (the
    second-newest branch is covered by test_marginalization_matches_jax
    and the streaming test). Decisions equal; poses within 1e-3 m (the
    fp32 solve of a prior-conditioned system); the accepted iteration
    count within one, as in the window solve."""
    w, _ = win
    est_j, est_t = booted
    est_t = interop.to_torch(jax.device_get(est_j), est_t)
    obs_frame = F - 1
    inp_j = j_est.FrameInput(
        chunk=jax.tree.map(lambda x: x[-1], w.chunks), ids=w.feats.track_id,
        obs=w.feats.obs[obs_frame],
        obs_valid=w.feats.mask[obs_frame] & w.feats.valid,
        loop=j_est.LoopInput.inactive(M))
    step = jax.jit(lambda e, i: j_est.backend_step(e, i, CFG, w.ext,
                                                   w.gravity))
    e2_j, out_j = step(est_j, inp_j)
    inp_t = t_est.FrameInput(
        chunk=interop.to_torch(jax.device_get(inp_j.chunk),
                               t_pre.ImuChunk.empty(
                                   CFG.window.max_imu_per_edge)),
        ids=torch.as_tensor(_np(inp_j.ids)),
        obs=torch.as_tensor(_np(inp_j.obs)),
        obs_valid=torch.as_tensor(_np(inp_j.obs_valid)),
        loop=t_est.LoopInput.inactive(M))
    e2_t, out_t = t_est.backend_step(est_t, inp_t, TCFG, est_t_ext(w),
                                     torch.as_tensor(_np(w.gravity)))
    assert bool(out_t.is_keyframe) == bool(out_j.is_keyframe) is True
    assert bool(out_t.failure) == bool(out_j.failure) is False
    assert abs(int(out_t.stats.accepted_iters)
               - int(out_j.stats.accepted_iters)) <= 1
    _close(out_t.pose_p, out_j.pose_p, 1e-3, msg="pose_p")
    _close(out_t.pose_q, out_j.pose_q, 1e-3, msg="pose_q")
    _close(out_t.stats.final_cost, out_j.stats.final_cost, 0.0, 1e-3)
    np.testing.assert_array_equal(out_t.point_valid.numpy(),
                                  _np(out_j.point_valid))
    for name in ("p", "q", "v"):
        _close(getattr(e2_t.window, name), getattr(e2_j.window, name), 1e-3,
               msg=name)
    for name in ("track_id", "mask", "valid", "anchor"):
        _close(getattr(e2_t.feats, name), getattr(e2_j.feats, name), 0.0,
               msg=name)
    _same_information(e2_t.prior, e2_j.prior, 2e-3)


def est_t_ext(w):
    return Extrinsics(torch.as_tensor(_np(w.ext.tic)),
                      torch.as_tensor(_np(w.ext.qic)))


def test_pnp_deadreckon_step_matches_jax(win, booted):
    """The streaming 30 Hz window: anchor at the backend's newest frame,
    refresh the landmark set, then dead-reckoned pnp_steps (no solve, as
    cfg.solver.pnp_stream_solve = "deadreckon")."""
    w, t = win
    est_j, est_t = booted
    S = CFG.window.pnp_size + 1
    Mp = M
    empty_c = jax.tree.map(lambda x: jnp.tile(x[None], (S - 1,) + (1,) *
                                              x.ndim),
                           j_pre.ImuChunk.empty(CFG.window.max_imu_per_edge))
    wj = j_pnp.PnpWindow(state=j_pnp.PnpState.identity(S),
                         feats=j_pnp.PnpFeatures.empty(S, Mp),
                         chunks=empty_c, anchored=jnp.zeros(S, bool))
    wj = wj._replace(preints=j_pnp.window_preints(wj, CFG))
    wt = interop.to_torch(jax.device_get(wj), t_pnp.PnpWindow(
        state=t_pnp.PnpState.identity(S),
        feats=t_pnp.PnpFeatures.empty(S, Mp),
        chunks=t_pre.ImuChunk(*[x[None].repeat((S - 1,) + (1,) * x.dim())
                                for x in t_pre.ImuChunk.empty(
                                    CFG.window.max_imu_per_edge)]),
        anchored=torch.zeros(S, dtype=torch.bool),
        preints=t_pnp.window_preints(t_pnp.PnpWindow(
            state=t_pnp.PnpState.identity(S),
            feats=t_pnp.PnpFeatures.empty(S, Mp),
            chunks=t_pre.ImuChunk(*[
                x[None].repeat((S - 1,) + (1,) * x.dim())
                for x in t_pre.ImuChunk.empty(CFG.window.max_imu_per_edge)]),
            anchored=torch.zeros(S, dtype=torch.bool)), TCFG)))
    wn = est_j.window
    wj = j_pnp.anchor_from_backend(wj, S - 1, wn.p[F - 1], wn.q[F - 1],
                                   wn.v[F - 1], wn.ba[F - 1], wn.bg[F - 1])
    wt = t_pnp.anchor_from_backend(wt, S - 1, *[
        torch.as_tensor(_np(x[F - 1]))
        for x in (wn.p, wn.q, wn.v, wn.ba, wn.bg)])
    pts_w = _np(j_est.landmark_world_points(wn, est_j.feats, w.ext))
    valid = _np(est_j.feats.valid & (wn.inv_depth > 1e-3))
    tl = _np(jnp.sum(est_j.feats.mask, 0))
    _close(t_est.landmark_world_points(est_t.window, est_t.feats,
                                       est_t_ext(w)), pts_w, 1e-4, 1e-5)
    wj = j_pnp.update_features(wj, jnp.asarray(pts_w), jnp.asarray(valid),
                               jnp.asarray(tl))
    wt = t_pnp.update_features(wt, torch.as_tensor(pts_w),
                               torch.as_tensor(valid), torch.as_tensor(tl))
    rng = np.random.default_rng(3)
    grav = torch.as_tensor(_np(w.gravity))
    for k in range(3):
        c_j = jax.tree.map(lambda x: x[k], w.chunks)
        c_t = t_pre.ImuChunk(*[x[k] for x in t["chunks"]])
        obs = rng.uniform(-0.5, 0.5, (Mp, 2)).astype(np.float32)
        msk = rng.uniform(0, 1, Mp) > 0.5
        wj, pose_j = j_pnp.pnp_step(wj, c_j, jnp.asarray(obs),
                                    jnp.asarray(msk), CFG, w.ext, w.gravity,
                                    do_solve=False, update_preints=False)
        wt, pose_t = t_pnp.pnp_step(wt, c_t, torch.as_tensor(obs),
                                    torch.as_tensor(msk), TCFG,
                                    est_t_ext(w), grav, do_solve=False,
                                    update_preints=False)
        for a, b in zip(pose_t, pose_j):
            _close(a, b, 1e-5, msg=f"frame {k}")
    back = interop.to_numpy(wt)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jax.device_get(wj))):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("definite", [True, False])
def test_info_to_sqrt_matches_jax_or_falls_back(definite):
    """The prior's square root: on a positive definite H the ridge
    Cholesky equals the reference's (1e-4 relative, float32 LAPACK). On
    an H indefinite beyond the 100x ridge c, as the float32 Schur
    complement of the window-10 bootstrap comes out, the reference
    returns NaN (jnp.linalg.cholesky's failure value) while the port
    takes the eigen-sqrt of H + cI with its eigenvalues floored at 1e-7
    of H's largest diagonal entry, the nearest matrix that the 100x ridge
    makes positive definite: finite, JᵀJ that matrix and Jᵀr = g."""
    rng = np.random.default_rng(9)
    n = 30
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    w = np.geomspace(1e4, 1.0, n)
    if not definite:
        w[-3:] = [-50.0, -20.0, -5.0]
    H = ((Q * w) @ Q.T).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    eps = 1e-8
    J_j, r_j = j_marg._info_to_sqrt(jnp.asarray(H), jnp.asarray(g), eps)
    J_t, r_t = t_marg._info_to_sqrt(torch.as_tensor(H), torch.as_tensor(g),
                                    eps)
    J_t, r_t = J_t.numpy().astype(np.float64), r_t.numpy()
    if definite:
        _close(J_t, J_j, 1e-4 * np.abs(_np(J_j)).max())
        _close(r_t, r_j, 1e-4 * max(np.abs(_np(r_j)).max(), 1.0))
        return
    assert not np.all(np.isfinite(_np(J_j)))
    assert np.all(np.isfinite(J_t)) and np.all(np.isfinite(r_t))
    d_max = np.abs(np.diag(H)).max()
    c = 100.0 * (eps + 1e-6 * d_max)
    w_h, V_h = np.linalg.eigh(H.astype(np.float64))
    assert w_h[0] + c < 0
    H_c = (V_h * np.maximum(w_h + c, eps + 1e-7 * d_max)) @ V_h.T
    assert np.abs(J_t.T @ J_t - H_c).max() <= 1e-3 * np.abs(H_c).max()
    np.testing.assert_allclose(J_t.T @ r_t, g, atol=1e-3)


def _sqrt_branch(H: torch.Tensor, eps: float) -> str:
    """Which factorization _info_to_sqrt takes for H."""
    Hs = 0.5 * (H + H.T)
    ridge = eps + 1e-6 * torch.max(torch.abs(torch.diagonal(Hs)))
    I = torch.eye(H.shape[0])
    if int(torch.linalg.cholesky_ex(Hs + ridge * I)[1]) == 0:
        return "ridge"
    if int(torch.linalg.cholesky_ex(Hs + 100.0 * ridge * I)[1]) == 0:
        return "ridge_100x"
    return "fallback"


def _edge_matrix(least: float, n: int = 30, seed: int = 9):
    """(H, g) with eigenvalues geomspace(1e4, 1) but the least, `least`."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    w = np.geomspace(1e4, 1.0, n)
    w[-1] = least
    H = ((Q * w) @ Q.T).astype(np.float32)
    return torch.as_tensor(H), torch.as_tensor(
        rng.normal(size=n).astype(np.float32))


@pytest.mark.parametrize("branch", ["ridge", "ridge_100x"])
def test_info_to_sqrt_bit_for_bit_where_a_cholesky_succeeds(branch):
    """Wherever either ridge Cholesky succeeds, the prior is that
    factor's, bit for bit: J = Lᵀ and r = L⁻¹g of H + ridge·I, or of
    H + 100·ridge·I where the first fails (an H with its least
    eigenvalue at -0.3 of the 100x ridge)."""
    eps = 1e-8
    H, _ = _edge_matrix(1.0)
    d_max = float(torch.max(torch.abs(torch.diagonal(H))))
    least = 1.0 if branch == "ridge" else -0.3 * 100.0 * 1e-6 * d_max
    H, g = _edge_matrix(least)
    assert _sqrt_branch(H, eps) == branch
    Hs = 0.5 * (H + H.T)
    ridge = eps + 1e-6 * torch.max(torch.abs(torch.diagonal(Hs)))
    k = 1.0 if branch == "ridge" else 100.0
    L = torch.linalg.cholesky(Hs + (k * ridge) * torch.eye(H.shape[0]))
    J, r = t_marg._info_to_sqrt(H, g, eps)
    assert torch.equal(J, L.T)
    assert torch.equal(r, torch.linalg.solve_triangular(
        L, g[:, None], upper=False)[:, 0])


def test_info_to_sqrt_continuous_across_the_ridge_edge():
    """Constraint (c) of the fallback: H's least eigenvalue at -c + t·s,
    c the 100x ridge and s = 1e-7 of the largest diagonal entry (the
    float32 round-off of H's entries), for t = -1 (both factorizations
    fail), +1 and +3 (the 100x-ridge Cholesky succeeds). Crossing the
    edge (t from +1 to -1) moves the prior's solve (JᵀJ)⁻¹Jᵀr no more
    than the same step of 2s moves it on the Cholesky side (+1 to +3),
    where the solve grows as 1/λ_min(H + cI); every solve is finite."""
    eps = 1e-8
    H0, _ = _edge_matrix(0.0)
    d_max = float(torch.max(torch.abs(torch.diagonal(H0))))
    c, s = 100.0 * (eps + 1e-6 * d_max), 1e-7 * d_max

    def solve(t):
        H, g = _edge_matrix(-c + t * s)
        J, r = (x.double().numpy() for x in t_marg._info_to_sqrt(H, g, eps))
        assert np.all(np.isfinite(J)) and np.all(np.isfinite(r))
        return _sqrt_branch(H, eps), np.linalg.solve(J.T @ J, J.T @ r)

    (b_fall, x_fall), (b_a, x_a), (b_a2, x_a2) = map(solve, (-1, 1, 3))
    assert (b_fall, b_a, b_a2) == ("fallback", "ridge_100x", "ridge_100x")
    jump = np.abs(x_fall - x_a).max()
    assert jump <= np.abs(x_a2 - x_a).max(), jump


def test_prior_branch_counts():
    """count_prior_branches() counts the branch each _info_to_sqrt call
    takes (ridge, 100x ridge, eigen fallback) on the tensors' device, not
    under torch.func.vmap; prior_branches() reads the counts; with
    counting off they read 0."""
    eps = 1e-8
    H0, _ = _edge_matrix(1.0)
    c = 100.0 * 1e-6 * float(torch.max(torch.abs(torch.diagonal(H0))))
    pairs = [_edge_matrix(least) for least in (1.0, -0.3 * c, -2.0 * c)]
    assert [_sqrt_branch(H, eps) for H, _ in pairs] == [
        "ridge", "ridge_100x", "fallback"]
    t_marg.count_prior_branches()
    try:
        for H, g in pairs:
            t_marg._info_to_sqrt(H, g, eps)
        torch.func.vmap(lambda H, g: t_marg._info_to_sqrt(H, g, eps))(
            torch.stack([H for H, _ in pairs]),
            torch.stack([g for _, g in pairs]))
        assert t_marg.prior_branches() == dict(ridge=1, ridge_100x=1,
                                               fallback=1)
    finally:
        t_marg.count_prior_branches(False)
    assert t_marg.prior_branches() == dict(ridge=0, ridge_100x=0,
                                           fallback=0)
