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

Those two carries are all that passes between the systems (the
reference forms its priors with the port's functions on its own
inputs), so the lockstep runs as two halves: the reference's
(revisit_reference), which writes the state the port takes as it
goes, and the port's (revisit_port), which reads it. Under xdist the
two are built at once in two workers (torch_watchdog orders their
builders first), the port's waiting on the reference's only where it
needs a state not written yet; elsewhere one after the other.

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
import os
import pickle
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_interactive as ti
import test_torch_interactive_revisit_card as rc
import torch_watchdog
from torch_brief_check import (FAULTS, assert_caught, check_brief,
                               record_inserts)
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


def _sequences():
    """The scene's JAX and port sequences."""
    from vins_tpu.io.synthetic import make_synthetic_sequence
    kw = rc.sequence_kwargs(N_FRAMES)
    return (make_synthetic_sequence(CFG, **kw),
            t_syn.make_synthetic_sequence(TCFG, device="cpu", **kw))


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


def _reference_state(sys_j, loop: bool):
    """What test_torch_interactive.carry_state (and carry_loop_state, if
    loop) reads of the reference system, as plain data under the same
    names."""
    get = jax.device_get
    ns = types.SimpleNamespace
    state = ns(tracker=ns(state=get(sys_j.tracker.state)),
               pnp=get(sys_j.pnp), est=get(sys_j.est),
               _pending_chunk=get(sys_j._pending_chunk),
               _last_good=get(sys_j._last_good), frame_idx=sys_j.frame_idx,
               kf_count=sys_j.kf_count, _pending_loop=get(sys_j._pending_loop))
    if loop:
        lj = sys_j.loop
        state.loop = ns(
            db=get(lj.db), graph=get(lj.graph), bow=get(lj.bow),
            r_drift=lj.r_drift.copy(), t_drift=lj.t_drift.copy(),
            _r_drift_dev=get(lj._r_drift_dev),
            _t_drift_dev=get(lj._t_drift_dev), last_match=lj.last_match,
            count=lj.count, n_loops=lj.n_loops,
            **{name: getattr(lj, name).copy() for name in (
                "_segments_np", "_kf_t_np", "_uid_np", "_kf_p_np",
                "_kf_yaw_np")})
    return state


def _dump(path: str, value) -> None:
    with open(path + ".tmp", "wb") as f:
        pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(path + ".tmp", path)


def _reference_half(folder: str):
    """The reference's half of the lockstep, alone: the JAX system through
    process_frame over the scene (ground-truth bootstrap, the port's
    priors carried into it: carry_priors applies the port's functions to
    the reference's own inputs, so this half needs nothing of the port's
    run). It writes the scene's frames to folder/frames first; after each
    frame it writes its frame index to folder/progress,
    and after the init frame and frame CARRY_AT, first, the state the
    port takes at that frame to folder/state_K.pkl (and the init frame's
    index to folder/init). Returns the reference's record: outputs, loop
    events, inserts and their frames, carried priors, ground-truth
    positions, DB and pose graph (loop_record)."""
    from vins_tpu.core import feature_manager as j_fm
    from vins_tpu.core.initialization import InitResult, InitStatus
    from vins_tpu.core.state import WindowState as JWindow
    from vins_tpu import pipeline as j_pipe

    seq, tseq = _sequences()
    imgs = rc.render(tseq).numpy()
    _dump(os.path.join(folder, "frames"), imgs)
    F, M = CFG.window.num_frames, CFG.window.max_landmarks
    sys_j = j_pipe.VinsSystem(CFG, use_loop=True, ext=seq.ext)

    def gt_initialize(feats, chunks, ext, cfg):
        cur = sys_j.frame_idx - 1
        idx = np.array([cur - CFG.freq * (F - 1 - f) for f in range(F)])
        win = JWindow(p=seq.p[idx], q=seq.q[idx], v=seq.v[idx],
                      ba=jnp.zeros((F, 3)), bg=jnp.zeros((F, 3)),
                      inv_depth=jnp.zeros(M))
        return InitResult(j_fm.triangulate(win, feats, ext, cfg),
                          InitStatus.SUCCESS)

    frame, ev_j, rows_j = [0], [], []
    rc.record_loop_events(sys_j, frame, ev_j, jax.device_get)
    record_inserts(sys_j.loop, frame, imgs, rows_j)
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pipe.init_mod, "initialize", gt_initialize)
    carried = carry_priors(mp, j_pipe, TCFG)
    sys_j._refine_init = lambda w, fe, ch: (w, 0.0)
    outs_j = []
    try:
        for k in range(N_FRAMES):
            frame[0] = k
            outs_j.append(sys_j.process_frame(
                jnp.asarray(imgs[k]), jax.tree.map(lambda x: x[k],
                                                   seq.chunks),
                t=float(seq.timestamps[k])))
            init = outs_j[-1].initialized and not outs_j[-2].initialized
            if init or k == CARRY_AT:
                _dump(os.path.join(folder, f"state_{k}.pkl"), dict(
                    init=init, loop=k == CARRY_AT,
                    state=_reference_state(sys_j, k == CARRY_AT)))
            if init:
                _dump(os.path.join(folder, "init"), k)
            _dump(os.path.join(folder, "progress"), k)
        jax.effects_barrier()
    finally:
        mp.undo()
    assert sys_j.loop._key_pool is None   # verify keys from its key chain
    return dict(outs_j=outs_j, ev_j=ev_j, rows_j=rows_j, carried=carried,
                gt_p=np.asarray(seq.p),
                frames={k: imgs[k] for _, k in rows_j},
                db_j=ti.loop_record(sys_j, jax.device_get))


class _States:
    """The frames and states _reference_half writes to `folder` for the
    port, read as the port's half needs them; follow(ready) waits until
    ready() while the reference's half is still running (None: it has
    ended)."""

    def __init__(self, folder: str, follow=None):
        self.folder, self.follow = folder, follow

    def _read(self, name: str, default=None):
        try:
            with open(os.path.join(self.folder, name), "rb") as f:
                return pickle.load(f)
        except FileNotFoundError:
            return default

    def _none_at(self, k: int) -> bool:
        """Whether the reference leaves no state after frame k (it has
        left its init frame's, and k is neither that nor CARRY_AT)."""
        init = self._read("init")
        return init is not None and k != init and k != CARRY_AT

    def frames(self):
        """The scene's frames, as the reference rendered them."""
        if self.follow is not None:
            self.follow(lambda: os.path.exists(
                os.path.join(self.folder, "frames")))
        return self._read("frames")

    def state(self, k: int):
        """The state the reference left for the port after frame k, or
        None; waits for the reference to pass frame k unless it is known
        to leave none there."""
        ready = lambda: self._none_at(k) or self._read("progress", -1) >= k
        if self.follow is not None:
            self.follow(ready)
        assert ready(), f"the reference's half has not passed frame {k}"
        return self._read(f"state_{k}.pkl")


def _port_half(states) -> dict:
    """The port's half of the lockstep: the port's system through
    process_frame over the same frames (ground-truth bootstrap, the
    reference's RANSAC noise) on the frames the reference rendered
    (states.frames()), taking the reference's state after each
    frame it left one for (states.state(k): test_torch_interactive.
    carry_state at the init frame, carry_loop_state after CARRY_AT).
    Returns the port's record: outputs, loop events, inserts and the
    frames of them, bootstrap states, DB and pose graph, BRIEF call count
    and loop counters."""
    from vins_tpu import pipeline as j_pipe

    seq, tseq = _sequences()
    imgs = states.frames()
    noise = jax_ransac_noise(0, N_FRAMES, CFG.frontend.f_ransac_hyps,
                             CFG.frontend.max_features)
    sys_t = t_pipe.VinsSystem(
        TCFG, ext=tseq.ext, device="cpu", use_loop=True,
        initializer=t_syn.ground_truth_initializer(tseq, TCFG))
    sys_t.loop.ransac_noise = jax_verify_noise(
        0, CFG.loop.geo_ransac_hyps, CFG.loop.max_kf_features)
    frame, ev_t, rows_t, n_brief = [0], [], [], []
    rc.record_loop_events(sys_t, frame, ev_t, interop.to_numpy)
    record_inserts(sys_t.loop, frame, imgs, rows_t)
    extract = t_brief.extract_brief

    def counted(*args, **kwargs):
        n_brief.append(1)
        return extract(*args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(t_brief, "extract_brief", counted)
    carried = carry_priors(mp, j_pipe, TCFG)
    outs_t = []
    try:
        for k in range(N_FRAMES):
            frame[0] = k
            outs_t.append(sys_t.process_frame(
                torch.as_tensor(imgs[k]),
                ImuChunk(*[x[k] for x in tseq.chunks]),
                t=float(seq.timestamps[k]),
                gumbel=torch.as_tensor(noise[k])))
            got = states.state(k)
            if got is not None:
                carry = carry_loop_state if got["loop"] else ti.carry_state
                carry(got["state"], sys_t)
    finally:
        mp.undo()
    return dict(outs_t=outs_t, ev_t=ev_t, rows_t=rows_t,
                frames={k: imgs[k] for _, k in rows_t},
                t=carried["t"], t_args=carried["t_args"],
                db_t=ti.loop_record(sys_t, interop.to_numpy),
                n_brief=len(n_brief), W_REFINED=sys_t.loop.W_REFINED,
                loop_stats=dict(sys_t.loop_stats))


def _merge(ref: dict, port: dict) -> dict:
    """The lockstep's record from its two halves' (build_revisit)."""
    return dict(
        outs_j=ref["outs_j"], outs_t=port["outs_t"], ev_j=ref["ev_j"],
        ev_t=port["ev_t"],
        carried=dict(ref["carried"], t=port["t"], t_args=port["t_args"]),
        gt_p=ref["gt_p"], n_brief=port["n_brief"], db_j=ref["db_j"],
        db_t=port["db_t"], rows_j=ref["rows_j"], rows_t=port["rows_t"],
        frames={**ref["frames"], **port["frames"]},
        W_REFINED=port["W_REFINED"],
        loop_stats=port["loop_stats"])


def build_revisit() -> dict:
    """The lockstep, recorded as plain data: both packages' outputs and
    loop events, their DBs and pose graphs after the run
    (test_torch_interactive.loop_record), each keyframe row's insert
    frame and that frame, the priors carried into the reference, the
    ground-truth positions, and the port's BRIEF call count and loop
    counters. The two halves share nothing but the state the port takes
    from the reference at two frames (_reference_half, _port_half), so
    running them one after the other gives the record both systems make
    stepping frame by frame; the test fixtures run them in two processes
    at once (revisit_reference, revisit_port)."""
    with tempfile.TemporaryDirectory(prefix="revisit_") as folder:
        ref = _reference_half(folder)
        return _merge(ref, _port_half(_States(folder)))


@pytest.fixture(scope="module")
def revisit_reference(request):
    """The reference's half (_reference_half), built once per test run;
    the states it leaves for the port go to a folder of the run that
    revisit_port's build reads while this one runs."""
    folder = torch_watchdog.shared_dir(request, "revisit_reference")
    return torch_watchdog.once_per_run(request,
                                       lambda: _reference_half(folder))


@pytest.fixture(scope="module")
def revisit_port(request):
    """The port's half (_port_half), built once per test run, beside the
    reference's half in another process of the run: it takes each state
    as the reference's build writes it (torch_watchdog.follow_build), or,
    where no process has begun the reference's half (outside xdist, or
    without its builder in the run), builds or reads that first."""
    folder = torch_watchdog.shared_dir(request, "revisit_reference")
    if not torch_watchdog.build_begun(request, "revisit_reference"):
        request.getfixturevalue("revisit_reference")
    follow = lambda ready: torch_watchdog.follow_build(
        request, "revisit_reference", ready)
    return torch_watchdog.once_per_run(
        request, lambda: _port_half(_States(folder, follow)))


@pytest.fixture(scope="module")
def revisit(revisit_port, revisit_reference):
    """build_revisit's record, from the two halves built once per test
    run (the port's first: it runs beside the reference's)."""
    return _merge(revisit_reference, revisit_port)


def test_revisit_reference_alone(revisit_reference):
    """The reference's half, run in a process of its own: the loop events
    of rc.EVENTS on their frames, and its published trajectory's aligned
    ATE under ATE_MAX (the port's half runs beside it, in another
    process, on the states it leaves)."""
    assert rc.event_frames(revisit_reference["ev_j"]) == rc.EVENTS
    assert rc.aligned_ate(revisit_reference["outs_j"],
                          revisit_reference["gt_p"]) < rc.ATE_MAX


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
    ate_j = rc.aligned_ate(revisit["outs_j"], revisit["gt_p"])
    ate_t = rc.aligned_ate(revisit["outs_t"], revisit["gt_p"])
    print(f"aligned ATE: reference {ate_j:.4f} m, port {ate_t:.4f} m")
    assert ate_j < rc.ATE_MAX and ate_t < rc.ATE_MAX
    assert abs(ate_t - ate_j) < 5e-3


def test_revisit_db_and_pose_graph_match_jax(revisit):
    """After the run: the same keyframe rows (stored poses to 5e-3 m,
    BoW rows to 1e-5; keypoints and BRIEF words by check_brief, whose
    readout is printed), BRIEF extracted once per keyframe insert (K3
    from the raw frame; verification reads the stored words), the same
    loop edge refined to full weight (its measurement to 5e-3), no
    constraint pending, one pose-graph run each, and the port's loop
    counters: one hit verified, staged and attached, ridden on the five
    good solves, retired."""
    dj, dt = revisit["db_j"], revisit["db_t"]
    n = dj["count"]
    assert dt["count"] == n and dt["n_inserts"] == n
    assert revisit["n_brief"] == n
    _close(dt["p"], dj["p"], 5e-3, "db.p")
    print("\n".join(check_brief(revisit)))
    _close(dt["bow"], dj["bow"], 1e-5, "bow")
    assert not dj["pending"] and not dt["pending"]
    assert dt["loop_w_host"] == dj["loop_w_host"] == [revisit["W_REFINED"]]
    for name in ("loop_i", "loop_j", "loop_w"):
        np.testing.assert_array_equal(dt[name], dj[name])
    _close(dt["loop_t"], dj["loop_t"], 5e-3, "t")
    _close(dt["loop_yaw"], dj["loop_yaw"], 5e-3, "yaw")
    assert dt["n_optimizes"] == dj["n_optimizes"] == 1
    assert revisit["loop_stats"] == dict(
        hits=1, staged=1, attached=1, good_frames=len(rc.EVENTS["ridden"]),
        retired=1)


@pytest.mark.parametrize("fault", FAULTS)
def test_brief_check_catches_a_real_fault(revisit, fault):
    """check_brief on the run's record with one fault planted in the last
    row (inserted after the carry) by torch_brief_check.assert_caught: a
    stored bit of the port's words flipped (the stored-word check fails:
    no sign change, far from the ulp bound), the reference's (the
    re-extraction fails), or the port's stored keypoint moved by 0.5 px
    (the position check fails)."""
    r = revisit["db_j"]["count"] - 1
    assert dict(revisit["rows_j"])[r] > CARRY_AT
    assert_caught(revisit, fault, r)
