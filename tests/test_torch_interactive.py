"""The interactive path: vins_tpu_torch against vins_tpu.

The motion-only solve (`solve_pnp_window`, `pnp_step` with the solve) on
one window built from `make_synthetic_window`, the streaming scan's
solve policy (`pnp_stream_solve`), and `VinsSystem(initializer=None)` in
lockstep with the JAX `VinsSystem` through `process_frame`, loop closure
off: bootstrap by the visual-inertial initialization on both sides (the
same attempts, statuses, init frame and window), then NON_LINEAR frames
with the 30 Hz solve and the backend, from the reference's state carried
into the port at the init frame (the init's metric scale is only
determined to a few percent in float32, see INIT_SCALE_TOL). RANSAC
noise of the tracker and of the initializer's essential RANSAC is
replayed from the JAX key chains.
"""
import functools
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_watchdog
from conftest import render_cached
from test_torch_stream import _rot_err, jax_ransac_noise
from vins_tpu.config import (CameraConfig, FrontendConfig, SolverConfig,
                             VinsConfig, WindowConfig)
from vins_tpu.core import pnp as j_pnp
from vins_tpu.io.synthetic import make_synthetic_window

import vins_tpu_torch.config as tc
from vins_tpu_torch import interop
from vins_tpu_torch import pipeline as t_pipe
from vins_tpu_torch import stream as t_stream
from vins_tpu_torch.core import pnp as t_pnp
from vins_tpu_torch.core import preintegration as t_pre
from vins_tpu_torch.core.factors import Extrinsics
from vins_tpu_torch.io import synthetic as t_syn

pytest_plugins = ["torch_watchdog"]

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _tree(cls, tree):
    return cls(*[_t(x) for x in tree])


# --- the motion-only solve ---------------------------------------------------

_PWIN = dict(window_size=6, pnp_size=6, max_landmarks=64,
             max_imu_per_edge=8)


def _pnp_cfgs(max_factors):
    return (VinsConfig(window=WindowConfig(**_PWIN),
                       solver=SolverConfig(pnp_max_factors=max_factors)),
            tc.VinsConfig(window=tc.WindowConfig(**_PWIN),
                          solver=tc.SolverConfig(
                              pnp_max_factors=max_factors)))


def _pnp_window(cfg, nan_obs=False):
    """A 7-frame motion-only window on the synthetic circle: the true
    landmarks as the fixed map, their observations with 0.5 px noise,
    the true states perturbed (5 cm, 0.03 rad, 5 cm/s), frame 2 anchored
    as a backend solve freezes it. Returns the JAX window and (ext,
    gravity)."""
    syn = make_synthetic_window(cfg, n_landmarks=64, seed=3)
    rng = np.random.default_rng(4)
    S, Mp = np.asarray(syn.feats.mask).shape
    obs = np.asarray(syn.feats.obs) + rng.normal(
        size=(S, Mp, 2)).astype(np.float32) * (0.5 / cfg.camera.focal)
    if nan_obs:
        obs[S - 1, np.argmax(np.asarray(syn.feats.mask[S - 1]))] = np.nan
    mask = np.asarray(syn.feats.mask)
    track = np.minimum(mask.sum(0) / 10.0, 1.0).astype(np.float32)
    weight = np.where(np.asarray(syn.feats.valid), track, 0.0)
    dth = rng.normal(size=(S, 3)).astype(np.float32) * 0.03
    from vins_tpu.utils import lie as j_lie
    state = j_pnp.PnpState(
        p=syn.state.p + rng.normal(size=(S, 3)).astype(np.float32) * 0.05,
        q=j_lie.quat_mul(syn.state.q, j_lie.so3_exp_quat(jnp.asarray(dth))),
        v=syn.state.v + rng.normal(size=(S, 3)).astype(np.float32) * 0.05,
        ba=jnp.zeros((S, 3)), bg=jnp.zeros((S, 3)))
    win = j_pnp.PnpWindow(
        state=state,
        feats=j_pnp.PnpFeatures(pts_w=syn.landmarks[:Mp],
                                obs=jnp.asarray(obs), mask=syn.feats.mask,
                                weight=jnp.asarray(weight, jnp.float32)),
        chunks=syn.chunks, anchored=jnp.asarray(np.arange(S) == 2))
    win = win._replace(preints=j_pnp.window_preints(win, cfg))
    return win, syn


def _port_window(win):
    return t_pnp.PnpWindow(
        state=_tree(t_pnp.PnpState, win.state),
        feats=_tree(t_pnp.PnpFeatures, win.feats),
        chunks=_tree(t_pre.ImuChunk, win.chunks), anchored=_t(win.anchored),
        preints=_tree(t_pre.Preintegration, win.preints))


def _ext_gravity(syn):
    return (_tree(Extrinsics, syn.ext), _t(syn.gravity),
            syn.ext, syn.gravity)


@pytest.mark.parametrize("max_factors", [448, 96])
def test_solve_pnp_window_matches_jax(max_factors):
    """solve_pnp_window on the reference's window and preintegrations, all
    448 factor slots or 96 (the compaction then drops the oldest frames'
    factors): the cost to 1e-4 relative and the state to 1e-4 m, 1e-5,
    1e-4 m/s, 1e-5 (three LM steps through float32 Cholesky solves of a
    105-unknown system; measured under a tenth of that). The solve must
    lower the cost, and the anchored frame stays where it was."""
    cfg, tcfg = _pnp_cfgs(max_factors)
    win, syn = _pnp_window(cfg)
    ext_t, g_t, ext_j, g_j = _ext_gravity(syn)
    st_j, cost_j = j_pnp.solve_pnp_window(win, cfg, ext_j, g_j)
    st_t, cost_t = t_pnp.solve_pnp_window(_port_window(win), tcfg, ext_t,
                                          g_t)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-4)
    for name, tol in (("p", 1e-4), ("q", 1e-5), ("v", 1e-4), ("ba", 1e-5),
                      ("bg", 1e-5)):
        np.testing.assert_allclose(getattr(st_t, name).numpy(),
                                   np.asarray(getattr(st_j, name)),
                                   atol=tol, err_msg=name)
    _, cost0 = t_pnp.solve_pnp_window(_port_window(win), tcfg, ext_t, g_t,
                                      iters=0)
    assert float(cost_t) < 0.5 * float(cost0)
    np.testing.assert_array_equal(st_t.p[2].numpy(),
                                  np.asarray(win.state.p[2]))


def test_solve_pnp_window_rejects_non_finite_steps():
    """A NaN observation makes every candidate cost non-finite: no step is
    accepted on either side and the state comes back unchanged, the
    port's without an exception from a failed factorization."""
    cfg, tcfg = _pnp_cfgs(448)
    win, syn = _pnp_window(cfg, nan_obs=True)
    ext_t, g_t, ext_j, g_j = _ext_gravity(syn)
    st_j, _ = j_pnp.solve_pnp_window(win, cfg, ext_j, g_j)
    st_t, _ = t_pnp.solve_pnp_window(_port_window(win), tcfg, ext_t, g_t)
    for a, b, c in zip(st_t, st_j, win.state):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(c))
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_pnp_step_with_solve_matches_jax():
    """pnp_step(do_solve=True, update_preints=True) from the reference's
    window: the slide, the newest edge's preintegration (1e-5), the
    dead-reckoned and solved newest pose (1e-4 m, 1e-5) and the whole
    solved state, as in the solve test."""
    cfg, tcfg = _pnp_cfgs(448)
    win, syn = _pnp_window(cfg)
    ext_t, g_t, ext_j, g_j = _ext_gravity(syn)
    chunk = jax.tree.map(lambda x: x[0], syn.chunks)
    obs, mask = win.feats.obs[-1] * 1.001, win.feats.mask[-1]
    win_j, out_j = j_pnp.pnp_step(win, chunk, obs, mask, cfg, ext_j, g_j)
    win_t, out_t = t_pnp.pnp_step(
        _port_window(win), _tree(t_pre.ImuChunk, chunk), _t(obs), _t(mask),
        tcfg, ext_t, g_t, do_solve=True, update_preints=True)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    for a, b in zip(win_t.preints, win_j.preints):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    for name in ("p", "q", "v"):
        np.testing.assert_allclose(getattr(win_t.state, name).numpy(),
                                   np.asarray(getattr(win_j.state, name)),
                                   atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(win_t.anchored.numpy(),
                                  np.asarray(win_j.anchored))
    np.testing.assert_array_equal(win_t.feats.mask.numpy(),
                                  np.asarray(win_j.feats.mask))


# --- the streaming scan's solve policy --------------------------------------


class _Stop(Exception):
    pass


def _scan_do_solve(stream_mod, state, cfg, ext, gravity, img):
    """What vio_scan_step passes to pnp_step as do_solve: the tracker is
    replaced by its carried state and the pnp step stops the frame."""
    seen = []

    def track(tracker, *args, **kwargs):
        M = cfg.frontend.max_features
        like = state.est.feats.obs
        z = (jnp.zeros if isinstance(like, jax.Array) else
             lambda s, dtype=None: torch.zeros(s))
        ids = (jnp.full((M,), -1, jnp.int32) if isinstance(like, jax.Array)
               else torch.full((M,), -1, dtype=torch.int32))
        valid = (jnp.zeros((M,), bool) if isinstance(like, jax.Array)
                 else torch.zeros(M, dtype=torch.bool))
        return tracker, types.SimpleNamespace(ids=ids, obs=z((M, 2)),
                                              obs_valid=valid)

    def pnp_step(*args, do_solve, **kwargs):
        seen.append(bool(do_solve))
        raise _Stop

    mp = pytest.MonkeyPatch()
    mp.setattr(stream_mod.tr_mod, "track_step_pre", track)
    mp.setattr(stream_mod.pnp_mod, "pnp_step", pnp_step)
    try:
        with pytest.raises(_Stop):
            chunk = state.pending
            stream_mod.vio_scan_step(state, None, None, img, chunk, cfg, ext,
                                     gravity)
    finally:
        mp.undo()
    return seen[0]


@pytest.mark.parametrize("mode,expect", [
    ("all", (True, True)), ("deadreckon", (False, False)),
    ("nonkf", (False, True)), ("nonbackend", (False, True))])
def test_stream_solve_policy_matches_jax(mode, expect):
    """pnp_stream_solve: "all" solves every frame, "deadreckon" none, and
    any other value the frames that are not backend frames — in both
    packages (vins_tpu/stream.py:235-238). expect = (backend frame,
    other frame)."""
    from vins_tpu import pipeline as j_pipe
    from vins_tpu import stream as j_stream

    solver = dict(pnp_stream_solve=mode)
    cfg = VinsConfig(solver=SolverConfig(**solver),
                     window=WindowConfig(**_PWIN))
    tcfg = tc.VinsConfig(solver=tc.SolverConfig(**solver),
                         window=tc.WindowConfig(**_PWIN))
    sys_j = j_pipe.VinsSystem(cfg, use_loop=False)
    sys_t = t_pipe.VinsSystem(tcfg, use_loop=False, device="cpu")
    img_j = jnp.zeros((cfg.camera.height, cfg.camera.width))
    got_j, got_t = [], []
    for phase in (0, 1):
        st_j = sys_j._scan_state()._replace(
            phase=jnp.asarray(phase, jnp.int32))
        got_j.append(_scan_do_solve(j_stream, st_j, cfg, sys_j.ext,
                                    sys_j.gravity, img_j))
        st_t = sys_t._scan_state()._replace(phase=phase)
        got_t.append(_scan_do_solve(t_stream, st_t, tcfg, sys_t.ext,
                                    sys_t.gravity, torch.as_tensor(
                                        np.asarray(img_j))))
    assert tuple(got_j) == expect
    assert tuple(got_t) == expect


# --- VinsSystem through process_frame, loop closure off ----------------------

_S = 0.4   # 480x640 default camera scaled to 192x256
_CAM = dict(width=192, height=256, fx=526.600 * _S, fy=526.678 * _S,
            cx=243.481 * _S, cy=315.280 * _S)
_FE = dict(max_features=48, target_features=40, min_distance=16,
           klt_eps=0.0)
# 96 landmark slots: at 64 the reference's bootstrap marginalization
# prior comes out NaN (ROADMAP Queue 3) and its backend never solves.
_WIN = dict(window_size=5, max_landmarks=96, max_imu_per_edge=8)
CFG = VinsConfig(camera=CameraConfig(**_CAM), frontend=FrontendConfig(**_FE),
                 window=WindowConfig(**_WIN))
TCFG = tc.VinsConfig(camera=tc.CameraConfig(**_CAM),
                     frontend=tc.FrontendConfig(**_FE),
                     window=tc.WindowConfig(**_WIN))
TRAJ = dict(w=0.35, bob=0.15)
SEED = 5
N_FRAMES = 31     # an attempt fails at frame 15, the init at 18, then
                  # four backend frames
# At the init frame: the metric scale comes out of refine_init_window's
# long LM valley (cost flat to 1e-3 relative along it), where float32
# round-off moves the solution: the reference's own jitted and eager
# runs of it on the same inputs end 8 mm apart at the newest frame (1.6%
# of its 0.53 m from frame 0), the port 19 mm from the jitted one
# (3.5%). Positions are compared to 5% of their distance from frame 0
# plus 5 mm; after init, with the reference's state carried over, to 5 mm.
INIT_SCALE_TOL = 0.05
ATOL = 5e-3


def carry_state(sys_j, sys_t):
    """The JAX system's state right after its init frame (a backend
    frame: no pending IMU), carried into the port system."""
    get = jax.device_get
    sys_t.tracker.state = interop.to_torch(get(sys_j.tracker.state),
                                           sys_t.tracker.state)
    sys_t.pnp = interop.to_torch(get(sys_j.pnp), sys_t.pnp)
    sys_t.est = interop.to_torch(get(sys_j.est), sys_t.est)
    assert sys_j._pending_chunk is None and sys_t._pending_chunk is None
    sys_t._last_good = (np.asarray(sys_j._last_good[0]),
                        sys_j._last_good[1])
    assert (sys_t.frame_idx, sys_t.kf_count) == (sys_j.frame_idx,
                                                 sys_j.kf_count)


def run_lockstep(cfg, tcfg, n_frames, use_loop, on_frame=None):
    """The JAX system and the port's VinsSystem(initializer=None) through
    process_frame over the same rendered frames, the tracker's and the
    initializer's RANSAC noise replayed from JAX. At the first initialized
    frame the JAX state is carried into the port; on_frame(k, sys_j,
    sys_t) runs after both have processed frame k. Returns (seq, outputs
    JAX, outputs port, JAX system, port system)."""
    from vins_tpu import pipeline as j_pipe

    seq, imgs = render_cached(cfg, n_frames=n_frames, seed=SEED,
                              frame_dt=1.0 / 30.0, traj_kwargs=TRAJ,
                              imu_per_frame=2)
    noise = jax_ransac_noise(0, n_frames, cfg.frontend.f_ransac_hyps,
                             cfg.frontend.max_features)
    keys = jax.random.split(jax.random.PRNGKey(0), cfg.frontend.f_ransac_hyps)
    init_noise = torch.as_tensor(np.array(jax.vmap(
        lambda k: jax.random.gumbel(k, (cfg.window.max_landmarks,)))(keys)))
    tseq = _port_sequence(tcfg, n_frames)
    sys_j = j_pipe.VinsSystem(cfg, use_loop=use_loop, ext=seq.ext)
    sys_t = t_pipe.VinsSystem(tcfg, ext=tseq.ext, device="cpu",
                              use_loop=use_loop)
    mp = pytest.MonkeyPatch()
    mp.setattr(t_pipe.init_mod, "initialize", functools.partial(
        t_pipe.init_mod.initialize, gumbel=init_noise))
    outs_j, outs_t = [], []
    try:
        for k in range(n_frames):
            t = float(seq.timestamps[k])
            outs_j.append(sys_j.process_frame(
                jnp.asarray(imgs[k]), jax.tree.map(lambda x: x[k],
                                                   seq.chunks), t=t))
            outs_t.append(sys_t.process_frame(
                torch.as_tensor(imgs[k]),
                t_pre.ImuChunk(*[x[k] for x in tseq.chunks]), t=t,
                gumbel=torch.as_tensor(noise[k])))
            if outs_j[-1].initialized and not outs_j[-2].initialized:
                carry_state(sys_j, sys_t)
            if on_frame is not None:
                on_frame(k, sys_j, sys_t)
    finally:
        mp.undo()
    return seq, outs_j, outs_t, sys_j, sys_t


def _port_sequence(tcfg, n_frames):
    return t_syn.make_synthetic_sequence(
        tcfg, n_frames=n_frames, n_landmarks=60, seed=SEED,
        frame_dt=1.0 / 30.0, traj_kwargs=TRAJ, imu_per_frame=2,
        device="cpu")


def compare_lockstep(outs_j, outs_t, atol=ATOL):
    """Per-frame parity: initialized flags, statuses, keyframe decisions
    and loop hits exactly, n_tracked within 2 (a sub-pixel KLT or
    Sampson threshold that flips under reordered fp32 sums), poses at the
    init frame to INIT_SCALE_TOL of their distance from the boot window's
    frame 0 (the origin) plus atol, after it to atol (m and rad), the
    solver cost to 1% + 1e-3 and the published point cloud to 10·atol +
    5% where both mark a point valid (a landmark moves along its ray with
    its inverse depth, which the window solve fixes only weakly for
    distant points). Returns the init frame."""
    init_at = None
    for k, (oj, ot) in enumerate(zip(outs_j, outs_t)):
        assert oj.initialized == ot.initialized, k
        assert oj.status == ot.status, (k, oj.status, ot.status)
        assert oj.is_keyframe == ot.is_keyframe, k
        assert oj.loop_hit == ot.loop_hit, k
        assert abs(oj.n_tracked - ot.n_tracked) <= 2, k
        if not oj.initialized:
            continue
        tol = atol
        if init_at is None:
            init_at = k
            tol = atol + INIT_SCALE_TOL * float(np.linalg.norm(oj.p_raw))
        np.testing.assert_allclose(ot.p, oj.p, atol=tol, err_msg=str(k))
        np.testing.assert_allclose(ot.p_raw, oj.p_raw, atol=tol,
                                   err_msg=str(k))
        assert _rot_err(np.asarray(oj.q), np.asarray(ot.q)) < atol, k
        assert np.isfinite(oj.solver_cost)
        assert ot.solver_cost == pytest.approx(oj.solver_cost, rel=1e-2,
                                               abs=1e-3), k
        assert (ot.point_cloud is None) == (oj.point_cloud is None), k
        if ot.point_cloud is not None:
            both = np.asarray(oj.point_valid) & np.asarray(ot.point_valid)
            assert both.sum() >= 0.9 * np.asarray(oj.point_valid).sum(), k
            np.testing.assert_allclose(ot.point_cloud[both],
                                       np.asarray(oj.point_cloud)[both],
                                       atol=10 * atol, rtol=0.05,
                                       err_msg=str(k))
    return init_at


def loop_record(sys_, fetch) -> dict:
    """What the loop-closure checks read of a system after its run, as
    numpy copies (fetch: the package's device-to-numpy copy): the loop
    closer's counters, drift and refined-weight list, its DB rows, BoW
    vectors and pose-graph loop columns, and the system's keyframe count,
    dispatch counter and staged hit."""
    lc = sys_.loop
    n = int(lc.count)
    db, graph = fetch(lc.db), fetch(lc.graph)
    return dict(
        count=n, n_inserts=getattr(lc, "n_inserts", None),
        n_optimizes=lc.n_optimizes, loop_w_host=list(lc._loop_w_host),
        W_REFINED=lc.W_REFINED,
        t_drift=np.array(lc.t_drift), r_drift=np.array(lc.r_drift),
        p=np.array(db.p[:n]), kp_ok=np.array(db.kp_ok[:n]),
        kp_px=np.array(db.kp_px[:n]),
        desc=np.array(db.desc[:n]).view(np.int32),
        bow=np.array(fetch(lc.bow)[:n]),
        **{name: np.array(getattr(graph, name)) for name in (
            "loop_i", "loop_j", "loop_w", "loop_t", "loop_yaw")},
        pending=sys_._pending_loop is not None, kf_count=sys_.kf_count,
        dispatch_seq=sys_._dispatch_seq)


@pytest.fixture(scope="module")
def lockstep(request):
    """run_lockstep's sequence and outputs, loop off, and whether each
    system ended initialized (JAX, port), built once per test run
    (torch_watchdog.once_per_run)."""
    def build():
        seq, outs_j, outs_t, sys_j, sys_t = run_lockstep(
            CFG, TCFG, N_FRAMES, use_loop=False)
        return (seq, outs_j, outs_t, bool(sys_j.initialized),
                bool(sys_t.initialized))
    return torch_watchdog.once_per_run(request, build)


def test_process_frame_bootstraps_and_runs_like_jax(lockstep):
    """Loop off: the same attempts with the same statuses (a failed one
    first), the same init frame and window, then NON_LINEAR frames (the
    30 Hz solve and the backend) from the reference's carried state with
    the same outputs (compare_lockstep's tolerances)."""
    _, outs_j, outs_t, init_j, init_t = lockstep
    init_at = compare_lockstep(outs_j, outs_t)
    statuses = [o.status for o in outs_j[:init_at] if o.status]
    assert statuses == ["FAIL_ALIGN"], statuses
    assert init_at is not None and init_at + 3 * CFG.freq < N_FRAMES
    assert all(o.initialized for o in outs_t[init_at:])
    assert sum(o.point_cloud is not None for o in outs_t[init_at + 1:]) >= 3
    assert init_t and init_j


def test_process_frame_self_initialized_tracks_ground_truth(lockstep):
    """The port alone, every default (its own RANSAC noise from its
    generators, no state carried): it initializes at the reference's init
    frame, and its poses from there on are finite and lie on the ground
    truth after alignment (the init fixes its own gauge): ATE under
    tests/test_stream_parity.py's 0.15 m."""
    from vins_tpu_torch.io.evaluate import ate_rmse

    seq, imgs = render_cached(CFG, n_frames=N_FRAMES, seed=SEED,
                              frame_dt=1.0 / 30.0, traj_kwargs=TRAJ,
                              imu_per_frame=2)
    tseq = _port_sequence(TCFG, N_FRAMES)
    sys_s = t_pipe.VinsSystem(TCFG, ext=tseq.ext, device="cpu",
                              use_loop=False)
    outs = [sys_s.process_frame(torch.as_tensor(imgs[k]),
                                t_pre.ImuChunk(*[x[k] for x in tseq.chunks]),
                                t=float(tseq.timestamps[k]))
            for k in range(N_FRAMES)]
    init_at = next(i for i, o in enumerate(outs) if o.initialized)
    assert init_at == next(i for i, o in enumerate(lockstep[1])
                           if o.initialized)
    est = np.stack([o.p for o in outs[init_at:]])
    assert np.all(np.isfinite(est))
    assert all(o.initialized for o in outs[init_at:])
    assert ate_rmse(est, tseq.p.numpy()[init_at:]).rmse < 0.15
