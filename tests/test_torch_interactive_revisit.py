"""The interactive path with loop closure on, over a scene that really
revisits: vins_tpu_torch against vins_tpu, in lockstep through
process_frame, with no hit staged by hand.

The scene and configuration are test_torch_interactive_revisit_card.py's
(SCENE, TCFG): a circle of radius 1.5 m at 0.9 rad/s with 0.05 m of
vertical bob, one lap in 209 frames at 30 Hz, the seed-3 room rendered
without pixel noise by the port's renderer (vins_tpu_torch.io.synthetic;
the same frames go to both packages), 4 IMU samples a frame, the
192x256 test camera, window 5, and every loop gate as LoopConfig ships
it (loop_freq 3, dislocal 20, temporal_k 1, min_loop_matches 22, the
shipped vocabulary) with the DB cut to 64 rows of 128 keypoints. Both
systems bootstrap from ground truth at frame 15: the visual-inertial
initialization does not bootstrap this circle (every attempt over the
first 90 frames ends FAIL_IMU, tools/torch_revisit_scan.py: the 0.05 m
bob leaves the accelerometer under init_min_acc_var). RANSAC noise of
the tracker and of the verify RANSAC is replayed from the JAX key
chains, and the reference goes on from the port's priors
(test_torch_stream.carry_priors).

The reference's state is carried into the port at the init frame
(test_torch_interactive.carry_state) and again after frame CARRY_AT,
the last query before the loop phase (carry_loop_state: the
estimator, tracker, motion-only window, loop DB, pose graph and the
gate's temporal state). Without the second carry the two float32
systems reach 3.7e-3 m apart by frame 230 and 5.0e-3 m while the
constraint rides, against the 5e-3 m per-frame tolerance, with every
decision and loop event still equal (measured on this scene).

Events, frame by frame, in both packages (rc.EVENTS, asserted): every
keyframe from frame 24 on is inserted and scored every third keyframe;
the detection gate first passes a candidate at frame 240 (DB row 24
against row 1), verify RANSAC runs there, the hit is verified (44
inliers) and staged at frame 240, rides and refines its edge on the
backend frames 243-255 (the first of them attaches it), and retires by
its TTL with the 4-DoF pose graph at frame 258; the gates at frames 249
and 258 pass candidates that verification rejects (too few inliers with
a world point for the relative-pose PnP). The published
drift-corrected trajectory's aligned ATE stays under
tests/test_stream_parity.py's 0.15 m in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_interactive as ti
import test_torch_interactive_revisit_card as rc
from test_torch_loop import jax_verify_noise
from test_torch_stream import (carry_priors, check_carried_priors,
                               jax_ransac_noise)
from vins_tpu.config import (CameraConfig, FrontendConfig, LoopConfig,
                             VinsConfig, WindowConfig)

from vins_tpu_torch import interop
from vins_tpu_torch import pipeline as t_pipe
from vins_tpu_torch.core.preintegration import ImuChunk
from vins_tpu_torch.io import synthetic as t_syn
from vins_tpu_torch.ops import brief as t_brief

pytest_plugins = ["torch_watchdog"]

torch.set_num_threads(1)

CFG = VinsConfig(camera=CameraConfig(**rc.CAM),
                 frontend=FrontendConfig(**rc.FE),
                 window=WindowConfig(**rc.WIN), loop=LoopConfig(**rc.LOOP))
TCFG = rc.TCFG
N_FRAMES = rc.N_FRAMES
CARRY_AT = rc.CARRY_AT


def _sequences(n_frames):
    """The scene's JAX and port sequences and its frames (numpy)."""
    from vins_tpu.io.synthetic import make_synthetic_sequence
    kw = rc.sequence_kwargs(n_frames)
    tseq = t_syn.make_synthetic_sequence(TCFG, device="cpu", **kw)
    return make_synthetic_sequence(CFG, **kw), rc.render(tseq).numpy(), tseq


def carry_loop_state(sys_j, sys_t):
    """The reference's whole state after a backend frame, carried into
    the port: test_torch_interactive.carry_state's (tracker, motion-only
    window, estimator, last good pose) and the loop closer's DB, pose
    graph, BoW rows, host mirrors, drift and the temporal-consistency
    state of its gate."""
    get = jax.device_get
    ti.carry_state(sys_j, sys_t)
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
    lt.last_match = lj.last_match
    assert sys_j._pending_loop is None and sys_t._pending_loop is None
    assert (lt.count, lt.n_loops, lt.n_inserts) == (
        lj.count, lj.n_loops, lj.count)


def run_revisit(carry_at=CARRY_AT, n_frames=N_FRAMES):
    """Both systems through process_frame over the scene (ground-truth
    bootstrap, the port's priors carried into the reference, the
    reference's state carried into the port at the init frame and at
    carry_at). Returns dict(seq, outs_j, outs_t, ev_j, ev_t, sys_j,
    sys_t, carried)."""
    from vins_tpu.core import feature_manager as j_fm
    from vins_tpu.core.initialization import InitResult, InitStatus
    from vins_tpu.core.state import WindowState as JWindow
    from vins_tpu import pipeline as j_pipe

    seq, imgs, tseq = _sequences(n_frames)
    F, M = CFG.window.num_frames, CFG.window.max_landmarks
    noise = jax_ransac_noise(0, n_frames, CFG.frontend.f_ransac_hyps,
                             CFG.frontend.max_features)
    sys_j = j_pipe.VinsSystem(CFG, use_loop=True, ext=seq.ext)
    sys_t = t_pipe.VinsSystem(
        TCFG, ext=tseq.ext, device="cpu", use_loop=True,
        initializer=t_syn.ground_truth_initializer(tseq, TCFG))
    sys_t.loop.ransac_noise = jax_verify_noise(
        0, CFG.loop.geo_ransac_hyps, CFG.loop.max_kf_features)

    def gt_initialize(feats, chunks, ext, cfg):
        cur = sys_j.frame_idx - 1
        idx = np.array([cur - CFG.freq * (F - 1 - f) for f in range(F)])
        win = JWindow(p=seq.p[idx], q=seq.q[idx], v=seq.v[idx],
                      ba=jnp.zeros((F, 3)), bg=jnp.zeros((F, 3)),
                      inv_depth=jnp.zeros(M))
        return InitResult(j_fm.triangulate(win, feats, ext, cfg),
                          InitStatus.SUCCESS)

    frame = [0]
    ev_j, ev_t = [], []
    rc.record_loop_events(sys_j, frame, ev_j, jax.device_get)
    rc.record_loop_events(sys_t, frame, ev_t, interop.to_numpy)
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pipe.init_mod, "initialize", gt_initialize)
    carried = carry_priors(mp, j_pipe, TCFG)
    sys_j._refine_init = lambda w, fe, ch: (w, 0.0)
    outs_j, outs_t = [], []
    try:
        for k in range(n_frames):
            frame[0] = k
            t = float(seq.timestamps[k])
            outs_j.append(sys_j.process_frame(
                jnp.asarray(imgs[k]), jax.tree.map(lambda x: x[k],
                                                   seq.chunks), t=t))
            outs_t.append(sys_t.process_frame(
                torch.as_tensor(imgs[k]),
                ImuChunk(*[x[k] for x in tseq.chunks]), t=t,
                gumbel=torch.as_tensor(noise[k])))
            if outs_j[-1].initialized and not outs_j[-2].initialized:
                ti.carry_state(sys_j, sys_t)
            if k == carry_at:
                carry_loop_state(sys_j, sys_t)
        jax.effects_barrier()
    finally:
        mp.undo()
    assert sys_j.loop._key_pool is None   # verify keys from its key chain
    return dict(seq=seq, outs_j=outs_j, outs_t=outs_t, ev_j=ev_j,
                ev_t=ev_t, sys_j=sys_j, sys_t=sys_t, carried=carried)


@pytest.fixture(scope="module")
def revisit():
    n_brief = []
    extract = t_brief.extract_brief

    def counted(*args, **kwargs):
        n_brief.append(1)
        return extract(*args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(t_brief, "extract_brief", counted)
    try:
        out = run_revisit()
    finally:
        mp.undo()
    return dict(out, n_brief=len(n_brief))


def _close(a, b, atol, what):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               err_msg=what)


def test_revisit_loop_events_match_jax(revisit):
    """Both packages' loop paths, event by event: the same queries with
    the same place scores (to 1e-5), the same gate results, verify RANSAC
    on the same pairs with the same inlier counts and PnP decisions (its
    yaw and translation to 5e-3), the same hit, the same staged
    constraint (the slots it joins, their old observations to 1e-5, the
    initial old pose to 5e-3), the same refined edges (5e-3) and the
    pose graph's drift (5e-3), all on rc.EVENTS's frames."""
    ej, et = revisit["ev_j"], revisit["ev_t"]
    assert rc.event_frames(ej) == rc.event_frames(et) == rc.EVENTS
    assert [e[:2] for e in ej] == [e[:2] for e in et]
    for a, b in zip(ej, et):
        kind, k = a[:2]
        what = f"{kind} at frame {k}"
        if kind == "scores":
            assert a[2] == b[2], what
            _close(b[3], a[3], 1e-5, what)
        elif kind in ("gate", "verify"):
            assert a == b, what
        elif kind == "verified":
            assert a[2:4] == b[2:4], what
            _close(b[5], a[5], 5e-3, what)
            _close(b[6], a[6], 5e-3, what)
        elif kind == "hit":
            assert a[2:5] == b[2:5], what
            _close(b[5], a[5], 5e-3, what)
            _close(b[6], a[6], 5e-3, what)
        elif kind == "stage":
            assert a[2] == b[2], what
            lj, lt = a[3], b[3]
            np.testing.assert_array_equal(lt.ok, lj.ok, err_msg=what)
            np.testing.assert_array_equal(lt.ids, lj.ids, err_msg=what)
            _close(lt.obs_old[lt.ok], lj.obs_old[lj.ok], 1e-5, what)
            _close(lt.p_init, lj.p_init, 5e-3, what)
            _close(lt.q_init, lj.q_init, 5e-3, what)
            assert int(lt.ttl) == int(lj.ttl) and lt.ok.sum() >= 10, what
        elif kind == "refine":
            assert a[2] == b[2], what
            _close(b[3], a[3], 5e-3, what)
            _close(b[4], a[4], 5e-3, what)
        elif kind == "optimize":
            _close(b[2], a[2], 5e-3, what)
            _close(b[3], a[3], 5e-3, what)


def test_revisit_process_frame_matches_jax(revisit):
    """Per frame, test_torch_interactive.compare_lockstep's checks (the
    same statuses, keyframe decisions and loop hits; n_tracked within 2;
    poses, raw and drift-corrected, to 5e-3 m and 5e-3 rad; the solver
    cost to 1%; the published point cloud), over the whole run: the
    ground-truth bootstrap at frame 15, the lap, the loop phase. The
    published poses after the pose graph carry its correction, and the
    priors carried into the reference hold its own
    (test_torch_stream.check_carried_priors)."""
    outs_j, outs_t = revisit["outs_j"], revisit["outs_t"]
    assert len(outs_j) == len(outs_t) == N_FRAMES
    init_at = ti.compare_lockstep(outs_j, outs_t)
    assert init_at == 15
    assert all(o.initialized and not o.status for o in outs_t[init_at:])
    hits = [(k, o.loop_hit) for k, o in enumerate(outs_t)
            if o.loop_hit is not None]
    assert hits == rc.EVENTS["hits"]
    after = rc.EVENTS["pose_graph"][0]
    corrected = [k for k, o in enumerate(outs_t)
                 if np.linalg.norm(o.p - o.p_raw) > 1e-6]
    assert corrected and min(corrected) == after, corrected
    check_carried_priors(revisit["carried"])


def test_revisit_aligned_ate_under_the_guard(revisit):
    """The published (drift-corrected) trajectory of each package, from
    the init frame, against the ground truth after alignment: under
    ATE_MAX in both, and the two within 5e-3 m of each other."""
    seq = revisit["seq"]
    ate_j = rc.aligned_ate(revisit["outs_j"], np.asarray(seq.p))
    ate_t = rc.aligned_ate(revisit["outs_t"], np.asarray(seq.p))
    print(f"aligned ATE: reference {ate_j:.4f} m, port {ate_t:.4f} m")
    assert ate_j < rc.ATE_MAX and ate_t < rc.ATE_MAX
    assert abs(ate_t - ate_j) < 5e-3


def test_revisit_db_and_pose_graph_match_jax(revisit):
    """After the run: the same keyframe rows (stored poses to 5e-3 m,
    BRIEF words bit for bit where both keep a keypoint, BoW rows to
    1e-5), BRIEF extracted once per keyframe insert (K3 from the raw
    frame; verification reads the stored words), the same loop edge
    refined to full weight (its measurement to 5e-3), no constraint
    pending, one pose-graph run each, and the port's loop counters: one
    hit verified, staged and attached, ridden on the five good solves,
    retired."""
    sj, st = revisit["sys_j"], revisit["sys_t"]
    lj, lt = sj.loop, st.loop
    n = lj.count
    assert lt.count == n and lt.n_inserts == n
    assert revisit["n_brief"] == n
    _close(lt.db.p[:n].numpy(), np.asarray(lj.db.p[:n]), 5e-3, "db.p")
    both = np.asarray(lj.db.kp_ok[:n]) & lt.db.kp_ok[:n].numpy()
    np.testing.assert_array_equal(
        lt.db.desc[:n].numpy()[both],
        np.asarray(lj.db.desc[:n]).view(np.int32)[both])
    _close(lt.bow[:n].numpy(), np.asarray(lj.bow[:n]), 1e-5, "bow")
    assert sj._pending_loop is None and st._pending_loop is None
    assert lt._loop_w_host == lj._loop_w_host == [lt.W_REFINED]
    for name in ("loop_i", "loop_j", "loop_w"):
        np.testing.assert_array_equal(getattr(lt.graph, name).numpy(),
                                      np.asarray(getattr(lj.graph, name)))
    _close(lt.graph.loop_t.numpy(), np.asarray(lj.graph.loop_t), 5e-3, "t")
    _close(lt.graph.loop_yaw.numpy(), np.asarray(lj.graph.loop_yaw), 5e-3,
           "yaw")
    assert lt.n_optimizes == lj.n_optimizes == 1
    assert st.loop_stats == dict(hits=1, staged=1, attached=1,
                                 good_frames=len(rc.EVENTS["ridden"]),
                                 retired=1)
