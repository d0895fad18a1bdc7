"""The interactive path with loop closure over a scene that really
revisits, on the card against the CPU: VinsSystem.process_frame over
SCENE's circle (radius 1.5 m at 0.9 rad/s, 0.05 m of vertical bob, one
lap in 209 frames at 30 Hz) at the small test configuration of
test_torch_interactive_revisit.py, rendered by the port's own renderer,
bootstrapped from ground truth, the same tracker and verify-RANSAC noise
on both devices (Gumbel draws from seeded torch generators). On both
devices the revisit must be detected, verified, staged, attached (its
first good window solve), ridden, refined and retired with the 4-DoF
pose graph, on the same frames, and the published poses must agree.

Imports no JAX: chip_smoke.py's phase 12 runs it on the card with the
other gpu cases (chip_smoke.CARD_TEST_FILES); elsewhere it skips.
test_torch_interactive_revisit.py holds the same path on the CPU to the
JAX package and takes its configuration and scene from here.
"""
import copy

import numpy as np
import pytest
import torch

import vins_tpu_torch.config as tc
from vins_tpu_torch import interop
from vins_tpu_torch import pipeline as t_pipe
from vins_tpu_torch.core.preintegration import ImuChunk
from vins_tpu_torch.io import synthetic as t_syn
from vins_tpu_torch.io.evaluate import ate_rmse

pytest_plugins = ["torch_watchdog"]

# test_torch_interactive.py's 192x256 camera and frontend (restated: that
# file imports JAX); edges of up to 16 IMU samples, so that a backend
# edge (three frames of 4 samples) never overflows (ROADMAP, "IMU edge
# merge drops samples"); every loop gate as LoopConfig ships it (loop_freq
# 3, dislocal 20, temporal_k 1, min_loop_matches 22, the shipped
# vocabulary), the DB cut to 64 rows of 128 keypoints (a lap inserts 26).
_S = 0.4
CAM = dict(width=192, height=256, fx=526.600 * _S, fy=526.678 * _S,
           cx=243.481 * _S, cy=315.280 * _S)
FE = dict(max_features=48, target_features=40, min_distance=16,
          klt_eps=0.0)
WIN = dict(window_size=5, max_landmarks=96, max_imu_per_edge=16)
LOOP = dict(max_keyframes=64, max_kf_features=128)
TCFG = tc.VinsConfig(camera=tc.CameraConfig(**CAM),
                     frontend=tc.FrontendConfig(**FE),
                     window=tc.WindowConfig(**WIN), loop=tc.LoopConfig(**LOOP))
# Rendered without pixel noise, so that the port's renderer and the JAX
# package's draw the same frames (their noise generators differ).
SCENE = dict(traj=dict(r=1.5, w=0.9, bob=0.05), seed=3, imu_per_frame=4,
             n_landmarks=60, noise_sigma=0.0)
N_FRAMES = 262
# The scene's loop events, by frame, on the CPU in both packages: the
# first gate to pass a candidate, then every query's; verify RANSAC on
# each; the one hit (frame, old DB row), staged on its frame; the backend
# frames it rides with a good solve (each refines its edge); the pose
# graph when its TTL runs out.
EVENTS = dict(gated=[240, 249, 258], verify=[240, 249, 258],
              hits=[(240, 1)], staged=[240],
              ridden=[243, 246, 249, 252, 255], pose_graph=[258])
ATE_MAX = 0.15           # tests/test_stream_parity.py:242, after alignment
# The backend frame after which the revisit's loop phase starts (the last
# query before it; the first candidate passes the gate at frame 240).
CARRY_AT = 231
# The lockstep's per-frame position bound (test_torch_interactive.ATOL).
POSE_TOL = 5e-3


def sequence_kwargs(n_frames=N_FRAMES) -> dict:
    return dict(n_frames=n_frames, seed=SCENE["seed"], frame_dt=1.0 / 30.0,
                traj_kwargs=SCENE["traj"],
                imu_per_frame=SCENE["imu_per_frame"],
                n_landmarks=SCENE["n_landmarks"])


def render(seq) -> torch.Tensor:
    """The scene's frames [n, H, W] on the CPU (the port's renderer)."""
    return t_syn.render_sequence_images(seq, TCFG, seed=SCENE["seed"],
                                        noise_sigma=SCENE["noise_sigma"],
                                        device="cpu")


def record_loop_events(sys_, frame, ev, fetch):
    """Record in ev, by frame (frame[0]), what one system's loop path
    does: every query's place scores (its own row and the DB rows before
    it) and gate result, every verify RANSAC run, every candidate's
    verify readout (inliers, PnP accepted, its mean-squared residual, yaw
    and translation), every hit, every staging with the constraint it
    stages (fetch: the package's device-to-numpy copy), every edge
    refinement and every pose-graph run with the drift it leaves."""
    lc = sys_.loop
    scored, gate, dispatch = lc.detect_from_scores, lc._gate, \
        lc._dispatch_verify_batch
    finish, stage = lc.finish_detect, sys_._stage_loop_from_hit
    refine, optimize = sys_._refine_edge_to_kf, lc.optimize

    def on_scores(idxs, scores_all, floor):
        cur = int(idxs[0])
        ev.append(("scores", frame[0], cur,
                   np.array(scores_all[0][:cur + 1], np.float32)))
        return scored(idxs, scores_all, floor)

    def on_gate(cur, scores, floor):
        best = gate(cur, scores, floor)
        ev.append(("gate", frame[0], cur, best))
        return best

    def on_dispatch(pairs, *a, **kw):
        ev.append(("verify", frame[0], [tuple(p) for p in pairs]))
        return dispatch(pairs, *a, **kw)

    def on_finish(pend, fetched):
        hits = finish(pend, fetched)
        if fetched:
            n = sum(b is not None for b in pend[1])
            n_in, t_rel, yaw, good, msr = [np.asarray(x)[:n]
                                           for x in fetched[0][:5]]
            ev.append(("verified", frame[0], n_in.astype(int).tolist(),
                       good.astype(bool).tolist(), msr.astype(np.float32),
                       yaw.astype(np.float32), t_rel.astype(np.float32)))
        for h in hits:
            if h is not None:
                ev.append(("hit", frame[0], h.old_idx, h.cur_idx,
                           h.n_inliers, np.asarray(h.t_rel, np.float32),
                           float(h.yaw_rel)))
        return hits

    def on_stage(hit, *a, **kw):
        ok = stage(hit, *a, **kw)
        ev.append(("stage", frame[0], bool(ok),
                   fetch(sys_._pending_loop["dev"]) if ok else None))
        return ok

    def on_refine(e, t_g, ryaw_g, p_g, yaw_g, j):
        refine(e, t_g, ryaw_g, p_g, yaw_g, j)
        ev.append(("refine", frame[0], j, np.asarray(t_g, np.float32),
                   float(ryaw_g)))

    def on_optimize(*a, **kw):
        out = optimize(*a, **kw)
        ev.append(("optimize", frame[0], np.array(lc.r_drift),
                   np.array(lc.t_drift)))
        return out

    lc.detect_from_scores = on_scores
    lc._gate = on_gate
    lc._dispatch_verify_batch = on_dispatch
    lc.finish_detect = on_finish
    sys_._stage_loop_from_hit = on_stage
    sys_._refine_edge_to_kf = on_refine
    lc.optimize = on_optimize


def event_frames(ev) -> dict:
    """The frames of a run's loop events: gates that passed a candidate,
    verify RANSAC runs, hits (frame, old row), stagings, refinements
    (ridden backend frames) and pose-graph runs."""
    return dict(
        gated=[e[1] for e in ev if e[0] == "gate" and e[3] is not None],
        verify=[e[1] for e in ev if e[0] == "verify"],
        hits=[(e[1], e[2]) for e in ev if e[0] == "hit"],
        staged=[e[1] for e in ev if e[0] == "stage" and e[2]],
        ridden=[e[1] for e in ev if e[0] == "refine"],
        pose_graph=[e[1] for e in ev if e[0] == "optimize"])


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u.clamp(1e-12, 1.0 - 1e-7)))


class PortRun:
    """The port's VinsSystem on `device` over the scene (inputs on the
    CPU: the sequence, its frames, the tracker's noise [n, hyps, M] from a
    generator seeded 0), stepped frame by frame from a ground-truth
    bootstrap, its verify RANSAC's noise drawn from a generator seeded 1,
    its loop events recorded (record_loop_events)."""

    def __init__(self, device, seq, imgs, noise):
        self.dev = torch.device(device)
        self.seq, self.imgs, self.noise = seq, imgs, noise
        lp = TCFG.loop
        self.vgen = torch.Generator().manual_seed(1)
        self.sys = t_pipe.VinsSystem(
            TCFG, ext=seq.ext, device=self.dev,
            initializer=t_syn.ground_truth_initializer(seq, TCFG))
        self.sys.loop.ransac_noise = lambda n: _gumbel(torch.rand(
            (n, lp.geo_ransac_hyps, lp.max_kf_features),
            generator=self.vgen)).to(self.dev)
        self.frame, self.ev, self.outs = [0], [], {}
        record_loop_events(self.sys, self.frame, self.ev, interop.to_numpy)

    def step(self, k: int) -> None:
        self.frame[0] = k
        dev, seq = self.dev, self.seq
        self.outs[k] = self.sys.process_frame(
            self.imgs[k].to(dev),
            ImuChunk(*[x[k].to(dev) for x in seq.chunks]),
            t=float(seq.timestamps[k]), gumbel=self.noise[k].to(dev))


def scene_inputs(n_frames=N_FRAMES):
    seq = t_syn.make_synthetic_sequence(TCFG, device="cpu",
                                        **sequence_kwargs(n_frames))
    fe = TCFG.frontend
    noise = _gumbel(torch.rand((n_frames, fe.f_ransac_hyps,
                                fe.max_features),
                               generator=torch.Generator().manual_seed(0)))
    return seq, render(seq), noise


def run_port(device, n_frames=N_FRAMES) -> PortRun:
    """The port alone through process_frame over the whole scene."""
    run = PortRun(device, *scene_inputs(n_frames))
    for k in range(n_frames):
        run.step(k)
    return run


def _moved(x, dev):
    """x (a tensor, a NamedTuple or tuple of them, or a host value) on
    dev; host values are copied."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, copy=True)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_moved(v, dev) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_moved(v, dev) for v in x)
    return copy.deepcopy(x)


# What a carry takes from a system between two frames (pipeline.VinsSystem)
# and its loop closer (loop.keyframe_db.LoopCloser): every attribute the
# interactive path reads or writes, none of the configuration, the device,
# the vocabulary or the noise sources.
_SYSTEM_STATE = ("initialized", "est", "pnp", "frame_idx", "kf_count",
                 "_pending_chunk", "_pending_loop", "_last_good",
                 "_recover_anchor", "_pnp_preints_stale", "loop_stats")
_LOOP_STATE = ("db", "graph", "bow", "count", "n_loops", "n_optimizes",
               "n_inserts", "detect_stats", "_loop_i_host", "_loop_w_host",
               "_edge_abs_host", "_next_edge_abs", "last_match", "r_drift",
               "t_drift", "_drift_dirty", "segment", "_segments_np",
               "_kf_t_np", "generation", "_uid_np", "_next_uid", "_kf_p_np",
               "_kf_yaw_np", "n_edges_evicted", "_r_drift_dev",
               "_t_drift_dev")


def carry_port_state(src: PortRun, dst: PortRun) -> None:
    """src's system, loop closer, tracker and verify-noise generator after
    a backend frame, carried onto dst's device (the CPU run's state into
    the card's system)."""
    assert src.sys._pending_chunk is None and src.sys._pending_loop is None
    dev = dst.dev
    for name in _SYSTEM_STATE:
        setattr(dst.sys, name, _moved(getattr(src.sys, name), dev))
    for name in _LOOP_STATE:
        setattr(dst.sys.loop, name, _moved(getattr(src.sys.loop, name), dev))
    dst.sys.tracker.state = interop.to_torch(
        interop.to_numpy(src.sys.tracker.state), dst.sys.tracker.state)
    dst.sys.tracker.started = src.sys.tracker.started
    dst.vgen.set_state(src.vgen.get_state())


def aligned_ate(outs, gt_p) -> float:
    """The published (drift-corrected) trajectory's ATE against the
    ground-truth positions gt_p [n, 3] after alignment, from the first
    initialized frame; outs: the outputs of frames 0..n-1 in order."""
    init_at = next(k for k, o in enumerate(outs) if o.initialized)
    est = np.stack([o.p for o in outs[init_at:]])
    return ate_rmse(est, np.asarray(gt_p)[init_at:len(outs)]).rmse


@pytest.mark.gpu
def test_revisit_on_card_matches_cpu():
    """The loop phase on the card against the CPU: the CPU's run goes
    over the whole scene, and its state after CARRY_AT (the last query
    before the revisit) is carried into a system on the card, which runs
    the rest of the scene through klt_fb_ncc and K3 from the raw frame
    (the CPU through their plain versions), as the CPU lockstep with the
    JAX package carries its reference's state there. On both: EVENTS (the
    revisit detected, verified, staged, attached, ridden and retired with
    the pose graph) on the same frames; equal decisions, n_tracked within
    2 and the published poses within POSE_TOL on every frame after the
    carry; the whole run's aligned ATE under ATE_MAX with the CPU's
    frames up to the carry and either device's after it. The full lap on
    the card is chip_smoke.py's phase 13 (default_config())."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tracking kernel has no CPU mode")
    # One thread: the small configuration's CPU run is fastest so (its
    # tensors are too small to split), and it is most of this case.
    torch.set_num_threads(1)
    inputs = scene_inputs()
    cpu = PortRun("cpu", *inputs)
    card = PortRun(torch.device("cuda", 0), *inputs)
    for k in range(N_FRAMES):
        cpu.step(k)
        if k == CARRY_AT:
            carry_port_state(cpu, card)
        elif k > CARRY_AT:
            card.step(k)
    fc, fg = event_frames(cpu.ev), event_frames(card.ev)
    assert fc == fg == EVENTS, (fc, fg)
    for run in (cpu, card):
        assert run.sys.loop_stats == dict(
            hits=1, staged=1, attached=1,
            good_frames=len(EVENTS["ridden"]), retired=1)
        assert run.sys.loop.n_optimizes == 1
    dp = []
    for k in range(CARRY_AT + 1, N_FRAMES):
        oc, og = cpu.outs[k], card.outs[k]
        assert (oc.initialized, oc.is_keyframe, oc.status, oc.loop_hit) == \
            (og.initialized, og.is_keyframe, og.status, og.loop_hit), k
        assert abs(oc.n_tracked - og.n_tracked) <= 2, k
        dp.append(float(np.abs(og.p - oc.p).max()))
    gt = inputs[0].p.numpy()
    outs_c = [cpu.outs[k] for k in range(N_FRAMES)]
    outs_g = outs_c[:CARRY_AT + 1] + [card.outs[k] for k in range(
        CARRY_AT + 1, N_FRAMES)]
    ate_c, ate_g = aligned_ate(outs_c, gt), aligned_ate(outs_g, gt)
    print(f"revisit, card against CPU over the {len(dp)} frames after the "
          f"carry at frame {CARRY_AT}: loop events {fg}; largest position "
          f"difference {max(dp):.3g} m; aligned ATE CPU {ate_c:.4f} m, with "
          f"the card's frames {ate_g:.4f} m")
    assert max(dp) <= POSE_TOL
    assert ate_c < ATE_MAX and ate_g < ATE_MAX


def test_revisit_port_alone_on_cpu():
    """The port alone on the CPU with the seeded torch noise: the loop
    events of EVENTS on their frames, the port's counters (one hit
    verified, staged, attached, ridden on its good solves and retired,
    one pose-graph run) and the published trajectory's aligned ATE under
    ATE_MAX."""
    torch.set_num_threads(1)
    run = run_port("cpu")
    assert event_frames(run.ev) == EVENTS
    assert run.sys.loop_stats == dict(
        hits=1, staged=1, attached=1, good_frames=len(EVENTS["ridden"]),
        retired=1)
    assert run.sys.loop.n_optimizes == 1
    outs = [run.outs[k] for k in range(N_FRAMES)]
    assert aligned_ate(outs, run.seq.p.numpy()) < ATE_MAX
