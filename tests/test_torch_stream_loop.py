"""The streaming slice with loop closure on: vins_tpu_torch against
vins_tpu, both at process_stream(depth=1) (one block in flight;
test_torch_stream_depth2.py runs the default depth 2).

Both systems bootstrap from ground truth and stream one block, inserting
every keyframe into their loop DBs; that phase is compared as
test_torch_stream.py compares the loop-off stream. Then the JAX state is
carried into the port (vins_tpu_torch.interop: estimator, tracker, pnp
window, loop DB and pose graph), so that the loop phase starts from one
state: left alone, the fp32 round-off of the two VIO solves drifts the
streams apart by more than the per-frame tolerance within about 40 frames
on this circle, loop closure or not (measured 0.012 m at frame 63 with it
off). The same verified hit (the first keyframe row, at its stored pose)
is staged on both sides through _stage_anchor_from_hit, and the next
blocks must attach it at ride time, ride it through the window solves,
refine its edge, retire it, run the 4-DoF pose graph and publish
drift-corrected poses, on the same frames. RANSAC noise of the tracker
is replayed from the JAX key chain into the port; the detection gate
never fires (dislocal exceeds the keyframe count), so no verify RANSAC
runs.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_watchdog
from conftest import render_cached
from test_torch_interactive import loop_record
from test_torch_stream import (_rot_err, carry_priors, check_carried_priors,
                               jax_ransac_noise)
from vins_tpu.config import (CameraConfig, FrontendConfig, LoopConfig,
                             VinsConfig, WindowConfig)

import vins_tpu_torch.config as tc
from vins_tpu_torch import interop
from vins_tpu_torch import pipeline as t_pipe
from vins_tpu_torch import stream as t_stream
from vins_tpu_torch.core.preintegration import ImuChunk
from vins_tpu_torch.io import synthetic as t_syn
from vins_tpu_torch.loop import keyframe_db as t_kdb

pytest_plugins = ["torch_watchdog"]

torch.set_num_threads(1)

_S = 0.4   # 480x640 default camera scaled to 192x256
_CAM = dict(width=192, height=256, fx=526.600 * _S, fy=526.678 * _S,
            cx=243.481 * _S, cy=315.280 * _S)
_FE = dict(max_features=48, target_features=40, min_distance=16,
           klt_eps=0.0)
_WIN = dict(window_size=5, max_landmarks=64, max_imu_per_edge=8)
_LOOP = dict(max_keyframes=32, max_kf_features=128, loop_freq=1,
             dislocal=40)
CFG = VinsConfig(camera=CameraConfig(**_CAM), frontend=FrontendConfig(**_FE),
                 window=WindowConfig(**_WIN), loop=LoopConfig(**_LOOP))
TCFG = tc.VinsConfig(camera=tc.CameraConfig(**_CAM),
                     frontend=tc.FrontendConfig(**_FE),
                     window=tc.WindowConfig(**_WIN),
                     loop=tc.LoopConfig(**_LOOP))
F = CFG.window.num_frames
BLOCK = 6
BOOT = CFG.freq * (F - 1) + 1
N_FIRST = BOOT + BLOCK              # bootstrap and one block
N_FRAMES = N_FIRST + 4 * BLOCK      # attach, ride, retire, publish
TRAJ = dict(w=0.7, bob=0.15)
SEED = 5
_PACK_COLS = (t_stream.PACK_LGOOD, t_stream.PACK_LRET)


def _instrument(sys_, flags, events):
    """Record each block's per-frame LGOOD/LRET flags, and the stream
    frame at which each pose-graph run and anchor staging happens."""
    dispatch = sys_.dispatch_block
    optimize = sys_.loop.optimize
    stage = sys_._stage_anchor_from_hit

    def dispatch_block(*a, **kw):
        handle = dispatch(*a, **kw)
        packed = handle[0].packed
        flags.append(np.asarray(packed.cpu() if isinstance(
            packed, torch.Tensor) else packed)[:, list(_PACK_COLS)])
        return handle

    def opt(*a, **kw):
        events.append(("optimize", sys_.frame_idx))
        return optimize(*a, **kw)

    def stg(hit):
        events.append(("stage", sys_.frame_idx, hit.old_idx))
        return stage(hit)

    sys_.dispatch_block = dispatch_block
    sys_.loop.optimize = opt
    sys_._stage_anchor_from_hit = stg


def _carry_state(sys_j, sys_t):
    """The JAX system's state after a depth-1 process_stream, carried into
    the port system through numpy."""
    get = jax.device_get
    sys_t.tracker.state = interop.to_torch(get(sys_j.tracker.state),
                                           sys_t.tracker.state)
    sys_t.pnp = interop.to_torch(get(sys_j.pnp), sys_t.pnp)
    sys_t.est = interop.to_torch(get(sys_j.est), sys_t.est)
    pending, has = sys_j._pending_chunk_dev
    sys_t._pending_chunk = (interop.to_torch(get(pending),
                                             sys_t._scan_state().pending)
                            if bool(has) else None)
    sys_t._loop_dev = interop.to_torch(get(sys_j._loop_dev),
                                       sys_t._loop_inactive)
    sys_t._anchor_dev = interop.to_torch(get(sys_j._anchor_dev),
                                         sys_t._anchor_inactive)
    sys_t._last_good = sys_j._last_good
    lj, lt = sys_j.loop, sys_t.loop
    lt.db = interop.to_torch(get(lj.db), lt.db)
    lt.graph = interop.to_torch(get(lj.graph), lt.graph)
    lt.bow = torch.as_tensor(np.array(get(lj.bow)))
    for name in ("_segments_np", "_kf_t_np", "_uid_np", "_kf_p_np",
                 "_kf_yaw_np"):
        setattr(lt, name, getattr(lj, name).copy())
    lt.r_drift, lt.t_drift = lj.r_drift.copy(), lj.t_drift.copy()
    lt._r_drift_dev = torch.as_tensor(np.array(get(lj._r_drift_dev)))
    lt._t_drift_dev = torch.as_tensor(np.array(get(lj._t_drift_dev)))
    assert (lt.count, lt.n_loops, sys_t.frame_idx, sys_t.kf_count) == (
        lj.count, lj.n_loops, sys_j.frame_idx, sys_j.kf_count)


@pytest.fixture(scope="module")
def streams(request):
    """run_streams' record with each system's loop closer after the
    stream as plain data (test_torch_interactive.loop_record), built once
    per test run (torch_watchdog.once_per_run)."""
    def build():
        s = run_streams()
        s["loop_j"] = loop_record(s.pop("sys_j"), jax.device_get)
        s["loop_t"] = loop_record(s.pop("sys_t"), interop.to_numpy)
        return s
    return torch_watchdog.once_per_run(request, build)


def run_streams():
    """Both systems streamed with the JAX state carried before the loop
    phase and the same hit queued on both sides (module docstring): their
    outputs, flags, loop events, carried priors and the live systems."""
    from vins_tpu.core import feature_manager as j_fm
    from vins_tpu.core.initialization import InitResult, InitStatus
    from vins_tpu.core.state import WindowState as JWindow
    from vins_tpu.loop.keyframe_db import LoopHit as JHit
    from vins_tpu import pipeline as j_pipe

    seq, imgs = render_cached(CFG, n_frames=N_FRAMES, seed=SEED,
                              frame_dt=1.0 / 30.0, traj_kwargs=TRAJ,
                              imu_per_frame=2)
    noise = jax_ransac_noise(0, N_FRAMES, CFG.frontend.f_ransac_hyps,
                             CFG.frontend.max_features)
    M = CFG.window.max_landmarks
    ts = np.asarray(seq.timestamps)

    # --- JAX, ground-truth bootstrap through a patched initializer -------
    sys_j = j_pipe.VinsSystem(CFG, use_loop=True, ext=seq.ext)

    def gt_initialize(feats, chunks, ext, cfg):
        cur = sys_j.frame_idx - 1
        idx = np.array([cur - CFG.freq * (F - 1 - f) for f in range(F)])
        win = JWindow(p=seq.p[idx], q=seq.q[idx], v=seq.v[idx],
                      ba=jnp.zeros((F, 3)), bg=jnp.zeros((F, 3)),
                      inv_depth=jnp.zeros(M))
        return InitResult(j_fm.triangulate(win, feats, ext, cfg),
                          InitStatus.SUCCESS)

    tseq = t_syn.make_synthetic_sequence(
        TCFG, n_frames=N_FRAMES, n_landmarks=60, seed=SEED,
        frame_dt=1.0 / 30.0, traj_kwargs=TRAJ, imu_per_frame=2,
        device="cpu")
    sys_t = t_pipe.VinsSystem(
        TCFG, ext=tseq.ext, device="cpu", use_loop=True,
        initializer=t_syn.ground_truth_initializer(tseq, TCFG))
    flags_j, flags_t, ev_j, ev_t = [], [], [], []
    _instrument(sys_j, flags_j, ev_j)
    _instrument(sys_t, flags_t, ev_t)

    mp = pytest.MonkeyPatch()
    mp.setattr(j_pipe.init_mod, "initialize", gt_initialize)
    carried = carry_priors(mp, j_pipe, TCFG)
    sys_j._refine_init = lambda w, fe, ch: (w, 0.0)
    imgs_t = torch.as_tensor(imgs)

    def run(s, e):
        oj = sys_j.process_stream(
            jnp.asarray(imgs[s:e]), jax.tree.map(lambda x: x[s:e],
                                                 seq.chunks),
            block=BLOCK, ts=ts[s:e], depth=1)
        ot = sys_t.process_stream(
            imgs_t[s:e], ImuChunk(*[x[s:e] for x in tseq.chunks]),
            block=BLOCK, ts=tseq.timestamps.numpy()[s:e], depth=1,
            gumbel=torch.as_tensor(noise[s:e]))
        return oj, ot

    try:
        first_j, first_t = run(0, N_FIRST)
        _carry_state(sys_j, sys_t)
        # The same verified hit on both sides: the first keyframe row,
        # at the pose the JAX DB stored for it.
        assert sys_j.loop.count >= 2
        hit = dict(old_idx=0, cur_idx=sys_t.loop.count - 1, n_inliers=40,
                   t_rel=np.zeros(3, np.float32), yaw_rel=0.0,
                   p_old=np.asarray(sys_j.loop.db.p_origin[0]),
                   q_old=np.asarray(sys_j.loop.db.q_origin[0]))
        hj, ht = JHit(**hit), t_kdb.LoopHit(**hit)
        sys_j._stage_anchor_from_hit(hj._replace(
            edge_abs=sys_j.loop._add_loop_edge(hj)))
        sys_t._stage_anchor_from_hit(ht._replace(
            edge_abs=sys_t.loop._add_loop_edge(ht)))
        outs_j, outs_t = run(N_FIRST, N_FRAMES)
    finally:
        mp.undo()
    return dict(seq=seq, first_j=first_j, first_t=first_t, outs_j=outs_j,
                carried=carried,
                outs_t=outs_t,
                sys_j=sys_j, sys_t=sys_t,
                flags_j=np.concatenate(flags_j),
                flags_t=np.concatenate(flags_t), ev_j=ev_j, ev_t=ev_t)


def test_torch_stream_loop_events_match_jax(streams):
    """The staged anchor attaches, rides, is refined, retires and runs the
    pose graph on the same frames on both sides, and the edge table and
    DB agree."""
    s = streams
    fj, ft = s["flags_j"], s["flags_t"]
    assert fj.shape == ft.shape
    good_j, ret_j = fj[:, 0] > 0.5, fj[:, 1] > 0.5
    good_t, ret_t = ft[:, 0] > 0.5, ft[:, 1] > 0.5
    np.testing.assert_array_equal(good_t, good_j)
    np.testing.assert_array_equal(ret_t, ret_j)
    assert good_j.any(), "the staged anchor never attached"
    assert ret_j.any(), "the loop constraint never retired"
    assert s["ev_t"] == s["ev_j"]
    assert any(e[0] == "optimize" for e in s["ev_j"])
    lj, lt = s["loop_j"], s["loop_t"]
    assert lt["n_optimizes"] == lj["n_optimizes"] >= 1
    assert lt["count"] == lj["count"]
    assert lt["loop_w_host"] == lj["loop_w_host"] == [lt["W_REFINED"]]
    assert not lt["pending"] and not lj["pending"]
    for name in ("loop_i", "loop_j", "loop_w"):
        np.testing.assert_array_equal(lt[name], lj[name])
    np.testing.assert_allclose(lt["loop_t"], lj["loop_t"], atol=5e-3)
    np.testing.assert_allclose(lt["loop_yaw"], lj["loop_yaw"], atol=5e-3)
    np.testing.assert_allclose(lt["t_drift"], lj["t_drift"], atol=5e-3)
    np.testing.assert_allclose(lt["r_drift"], lj["r_drift"], atol=5e-3)


def _compare_frames(outs_j, outs_t, offset):
    n_corr = 0
    for i, (oj, ot) in enumerate(zip(outs_j, outs_t)):
        k = offset + i
        assert oj.initialized == ot.initialized, k
        assert oj.is_keyframe == ot.is_keyframe, k
        assert oj.status == ot.status, k
        assert oj.loop_hit == ot.loop_hit, k
        assert abs(oj.n_tracked - ot.n_tracked) <= 2, k
        if not oj.initialized:
            continue
        np.testing.assert_allclose(ot.p, oj.p, atol=5e-3,
                                   err_msg=f"frame {k}")
        np.testing.assert_allclose(ot.p_raw, oj.p_raw, atol=5e-3,
                                   err_msg=f"frame {k}")
        assert _rot_err(np.asarray(oj.q), np.asarray(ot.q)) < 5e-3, k
        n_corr += int(np.linalg.norm(np.asarray(oj.p) - np.asarray(oj.p_raw))
                      > 1e-6)
        assert np.all(np.isfinite(ot.p)) and np.all(np.isfinite(ot.q)), k
    return n_corr


def test_torch_stream_loop_matches_jax_per_frame(streams):
    """Per-frame parity of the published (drift-corrected) and raw poses
    in both phases, with test_torch_stream.py's tolerances (5e-3 m /
    5e-3 rad): the attach rows here lie inside the border, where the
    port's BRIEF equals the JAX CPU branch, so nothing is widened.
    Discrete decisions match exactly; n_tracked within 2, as there."""
    s = streams
    assert len(s["first_j"]) == len(s["first_t"]) == N_FIRST
    assert len(s["outs_j"]) == len(s["outs_t"]) == N_FRAMES - N_FIRST
    _compare_frames(s["first_j"], s["first_t"], 0)
    n_corr = _compare_frames(s["outs_j"], s["outs_t"], N_FIRST)
    assert n_corr >= 1, "no published pose carries a drift correction"
    check_carried_priors(s["carried"])


@pytest.mark.parametrize("n_sel", [0, 1, 6, 7])
def test_attach_median_matches_jnp_nanmedian(n_sel):
    """The attach gate's median over the selected matches equals
    jnp.nanmedian over the same values with NaN elsewhere: the mean of
    the two middle values for an even count, NaN for none."""
    rng = np.random.default_rng(n_sel)
    x = rng.uniform(0, 1, 16).astype(np.float32)
    sel = np.zeros(16, bool)
    sel[rng.permutation(16)[:n_sel]] = True
    ref = float(jnp.nanmedian(jnp.where(jnp.asarray(sel), jnp.asarray(x),
                                        jnp.nan)))
    got = float(t_stream._nanmedian(torch.as_tensor(x),
                                    torch.as_tensor(sel)))
    if n_sel == 0:
        assert np.isnan(ref) and np.isnan(got)
    else:
        assert got == pytest.approx(ref, abs=1e-7)
