"""Failure recovery in both packages, on the CPU: a garbage IMU chunk
(gyr = 40 rad/s on every sample, tests/test_pipeline.py's injection) on
a backend frame, once through process_frame and once inside a block of
process_stream at depth 2, where the block dispatched behind the failing
one is discarded and the stream is reprocessed from the frame after the
failure. Both systems bootstrap from ground truth (the same boot frames
by stream index, also for the re-initialization) on
test_torch_stream.py's small camera, loop closure off, RANSAC noise
replayed from the JAX key chain in the order the JAX tracker draws it
(one draw per tracked frame, the discarded block's frames included).
Compared: the failure frame, the re-initialization frame, the first
recovered pose against the last good one (the re-anchoring of
VINS.cpp:137-142), the recorded trajectory's length, and the poses
after recovery.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import render_cached
from test_torch_stream import (BLOCK, BOOT, CFG, F, SEED, TCFG, TRAJ,
                               _rot_err, carry_priors, check_carried_priors,
                               jax_ransac_noise)

from vins_tpu_torch import pipeline as t_pipe
from vins_tpu_torch.core.preintegration import ImuChunk
from vins_tpu_torch.core.state import WindowState as TWindow
from vins_tpu_torch.io import synthetic as t_syn
from vins_tpu_torch.core import feature_manager as t_fm

pytest_plugins = ["torch_watchdog"]

torch.set_num_threads(1)

N_FRAMES = 64
FAIL_AFTER = BOOT + BLOCK   # first backend frame at or after this fails


def _systems(seq, tseq, cur):
    """A JAX and a port system (loop off) whose bootstrap is the ground
    truth at the boot frames cur[0] - freq·(F-1-f), by stream index."""
    from vins_tpu.core import feature_manager as j_fm
    from vins_tpu.core.initialization import InitResult, InitStatus
    from vins_tpu.core.state import WindowState as JWindow
    from vins_tpu import pipeline as j_pipe

    M = CFG.window.max_landmarks
    boot = lambda: np.array([cur[0] - CFG.freq * (F - 1 - f)
                             for f in range(F)])

    def gt_initialize(feats, chunks, ext, cfg):
        idx = boot()
        win = JWindow(p=seq.p[idx], q=seq.q[idx], v=seq.v[idx],
                      ba=jnp.zeros((F, 3)), bg=jnp.zeros((F, 3)),
                      inv_depth=jnp.zeros(M))
        return InitResult(j_fm.triangulate(win, feats, ext, cfg),
                          InitStatus.SUCCESS)

    def t_initialize(feats, chunks, frames):
        idx = torch.as_tensor(boot())
        z = torch.zeros((F, 3))
        win = TWindow(p=tseq.p[idx], q=tseq.q[idx], v=tseq.v[idx], ba=z,
                      bg=z.clone(), inv_depth=torch.zeros(M))
        return t_fm.triangulate(win, feats, tseq.ext, TCFG)

    sys_j = j_pipe.VinsSystem(CFG, use_loop=False, ext=seq.ext)
    sys_j._refine_init = lambda w, fe, ch: (w, 0.0)
    sys_t = t_pipe.VinsSystem(TCFG, ext=tseq.ext, device="cpu",
                              use_loop=False, initializer=t_initialize)
    return sys_j, sys_t, (j_pipe.init_mod, "initialize", gt_initialize)


def _j_pipe():
    from vins_tpu import pipeline as j_pipe
    return j_pipe


def _inputs():
    seq, imgs = render_cached(CFG, n_frames=N_FRAMES, seed=SEED,
                              frame_dt=1.0 / 30.0, traj_kwargs=TRAJ,
                              imu_per_frame=2)
    tseq = t_syn.make_synthetic_sequence(
        TCFG, n_frames=N_FRAMES, n_landmarks=60, seed=SEED,
        frame_dt=1.0 / 30.0, traj_kwargs=TRAJ, imu_per_frame=2,
        device="cpu")
    noise = jax_ransac_noise(0, N_FRAMES + 2 * BLOCK,
                             CFG.frontend.f_ransac_hyps,
                             CFG.frontend.max_features)
    return seq, tseq, imgs, noise


def _summary(outs, sys_):
    """(failure frame, re-init frame, last good pose, first recovered
    pose, trajectory length) of one run."""
    fail = next(k for k, o in enumerate(outs) if o.status == "FAILURE")
    reinit = next(k for k in range(fail + 1, len(outs))
                  if outs[k].initialized)
    last_good = next(outs[k].p for k in range(fail - 1, -1, -1)
                     if outs[k].initialized)
    return fail, reinit, last_good, outs[reinit].p, len(sys_.trajectory)


@pytest.fixture(scope="module")
def interactive():
    seq, tseq, imgs, noise = _inputs()
    cur = [0]
    sys_j, sys_t, patch = _systems(seq, tseq, cur)
    mp = pytest.MonkeyPatch()
    mp.setattr(*patch)
    carried = carry_priors(mp, _j_pipe(), TCFG)
    runs, jax_prior_ok = [], None
    try:
        for sys_ in (sys_j, sys_t):
            outs, injected = [], None
            for k in range(N_FRAMES):
                cur[0] = k
                garbage = (injected is None and k >= FAIL_AFTER
                           and sys_.initialized
                           and sys_.frame_idx % CFG.freq == 0)
                if sys_ is sys_j:
                    chunk = jax.tree.map(lambda x: x[k], seq.chunks)
                    if garbage:
                        chunk = chunk._replace(gyr=jnp.full_like(chunk.gyr,
                                                                 40.0))
                    outs.append(sys_.process_frame(
                        jnp.asarray(imgs[k]), chunk,
                        t=float(seq.timestamps[k])))
                else:
                    chunk = ImuChunk(*[x[k] for x in tseq.chunks])
                    if garbage:
                        chunk = chunk._replace(gyr=torch.full_like(
                            chunk.gyr, 40.0))
                    outs.append(sys_.process_frame(
                        torch.as_tensor(imgs[k]), chunk,
                        t=float(tseq.timestamps[k]),
                        gumbel=torch.as_tensor(noise[k])))
                if garbage:
                    injected = k
                if (sys_ is sys_j and injected is not None
                        and jax_prior_ok is None and outs[-1].initialized):
                    jax_prior_ok = bool(np.isfinite(np.asarray(
                        sys_j.est.prior.J)).all())
            runs.append((injected, outs))
    finally:
        mp.undo()
    return sys_j, sys_t, runs, jax_prior_ok, np.asarray(seq.p), carried


@pytest.fixture(scope="module")
def streamed():
    seq, tseq, imgs, noise = _inputs()
    cur = [0]
    sys_j, sys_t, patch = _systems(seq, tseq, cur)
    # The garbage frame: a backend frame inside the second block after
    # bootstrap (frame_idx equals the stream index until the failure),
    # so the third block is in flight behind it.
    bad = next(k for k in range(BOOT + BLOCK + 1, BOOT + 2 * BLOCK)
               if k % CFG.freq == 0)
    chunks_j = seq.chunks._replace(gyr=seq.chunks.gyr.at[bad].set(40.0))
    gyr_t = tseq.chunks.gyr.clone()
    gyr_t[bad] = 40.0
    chunks_t = tseq.chunks._replace(gyr=gyr_t)

    # The stream index of every interactive frame, for the bootstrap.
    for sys_ in (sys_j, sys_t):
        frame = sys_.process_frame

        def tracked(img, chunk, t=0.0, _frame=frame, **kw):
            cur[0] = int(round(t * 30.0))
            return _frame(img, chunk, t=t, **kw)

        sys_.process_frame = tracked
    # The port draws its RANSAC noise in the JAX tracker's order: one
    # draw per tracked frame, also in the block that is discarded.
    drawn = [0]
    p_frame, p_dispatch = sys_t.process_frame, sys_t.dispatch_block

    def frame_t(img, chunk, t=0.0, gumbel=None):
        drawn[0] += 1
        return p_frame(img, chunk, t=t,
                       gumbel=torch.as_tensor(noise[drawn[0] - 1]))

    def dispatch_t(imgs_b, chunks_b, ts=None, gumbel=None):
        n = int(imgs_b.shape[0])
        drawn[0] += n
        return p_dispatch(imgs_b, chunks_b, ts=ts, gumbel=torch.as_tensor(
            noise[drawn[0] - n:drawn[0]]))

    sys_t.process_frame, sys_t.dispatch_block = frame_t, dispatch_t
    # The port's state right after its failure reset.
    after_reset = {}
    fail_reset = sys_t._fail_reset

    def reset_t():
        fail_reset()
        pnp = sys_t.pnp
        after_reset.update(
            frame_idx=sys_t.frame_idx, kf_count=sys_t.kf_count,
            pending_chunk=sys_t._pending_chunk, loop_dev=sys_t._loop_dev,
            anchor_dev=sys_t._anchor_dev, anchor_live=sys_t._anchor_live,
            pending_loop=sys_t._pending_loop,
            initialized=sys_t.initialized,
            pnp_fresh=bool(torch.all(pnp.state.p == 0)
                           and torch.all(pnp.state.v == 0)
                           and not pnp.anchored.any()))

    sys_t._fail_reset = reset_t
    mp = pytest.MonkeyPatch()
    mp.setattr(*patch)
    carried = carry_priors(mp, _j_pipe(), TCFG)
    try:
        outs_j = sys_j.process_stream(jnp.asarray(imgs), chunks_j,
                                      block=BLOCK,
                                      ts=np.asarray(seq.timestamps),
                                      depth=2)
        outs_t = sys_t.process_stream(torch.as_tensor(imgs), chunks_t,
                                      block=BLOCK,
                                      ts=tseq.timestamps.numpy(), depth=2)
    finally:
        mp.undo()
    return (sys_j, sys_t, bad, outs_j, outs_t, drawn[0], np.asarray(seq.p),
            after_reset, carried)


def _compare(sys_j, sys_t, outs_j, outs_t, bad, gt, upto=None):
    """The recovery summaries agree; per-frame outputs agree on frames
    before `upto` (all frames by default) and are finite after it."""
    sj, st = _summary(outs_j, sys_j), _summary(outs_t, sys_t)
    assert st[0] == sj[0] == bad, (st[0], sj[0], bad)
    assert st[1] == sj[1], (st[1], sj[1])
    assert len(outs_j) == len(outs_t) == N_FRAMES
    assert st[4] == sj[4]
    # The re-initialized window is anchored at the last good pose: the
    # first recovered pose lies no further from it than the camera
    # travelled in between (10 cm of slack), in both packages alike.
    last = max(k for k in range(sj[0]) if outs_j[k].initialized)
    travelled = float(np.sum(np.linalg.norm(np.diff(gt[last:sj[1] + 1],
                                                    axis=0), axis=1)))
    jump_j = np.linalg.norm(sj[3] - sj[2])
    jump_t = np.linalg.norm(st[3] - st[2])
    assert max(jump_j, jump_t) < travelled + 0.1, (jump_j, jump_t,
                                                   travelled)
    assert abs(jump_t - jump_j) < 5e-3
    assert np.linalg.norm(st[3]) > 0.5, "teleported to the origin"
    for k, (oj, ot) in enumerate(zip(outs_j, outs_t)):
        if upto is not None and k >= upto:
            assert ot.initialized and np.all(np.isfinite(ot.p)), k
            continue
        assert (oj.initialized, oj.status, oj.is_keyframe) == \
            (ot.initialized, ot.status, ot.is_keyframe), k
        if oj.initialized:
            np.testing.assert_allclose(ot.p, oj.p, atol=5e-3,
                                       err_msg=f"frame {k}")
            assert _rot_err(np.asarray(oj.q), np.asarray(ot.q)) < 5e-3, k
    return sj


def test_interactive_failure_recovery_matches_jax(interactive):
    """process_frame with the garbage chunk on the first backend frame
    after frame BOOT + BLOCK: the same failure frame, re-initialization
    frame, re-anchored first pose (its distance to the last good pose
    within 5 mm of the JAX one's, and within the camera's path between
    them) and trajectory length; every frame's pose to
    5e-3 m / 5e-3 rad, as test_torch_stream.py, on every frame. Both
    bootstrap priors and every later one are the port's in both packages
    (test_torch_stream.carry_priors): the reference's own re-initialized
    prior on this sequence is NaN or the 100x ridge by the host (both
    ridge Cholesky factorizations of an indefinite float32 Schur
    complement can fail, ROADMAP item 31), and the carried ones hold the
    reference's own wherever that is finite (check_carried_priors)."""
    (sys_j, sys_t, ((inj_j, outs_j), (inj_t, outs_t)), prior_ok,
     gt, carried) = interactive
    assert inj_j == inj_t is not None
    assert prior_ok
    sj = _compare(sys_j, sys_t, outs_j, outs_t, inj_j, gt)
    check_carried_priors(carried)
    assert sj[4] == N_FRAMES     # every interactive frame is recorded
    assert not sys_t.boot and sys_t.initialized


def test_streamed_failure_discards_the_block_in_flight(streamed):
    """The same garbage chunk inside a block of process_stream at depth 2:
    the good prefix is published, the block dispatched behind it is
    discarded, the system re-initializes from the frame after the
    failure, and the same frames and poses come out of both packages.
    Nothing of the discarded block survives the reset: the frame counter,
    the pending IMU chunk, the loop mirrors and the pnp window start
    fresh, as in the JAX package."""
    (sys_j, sys_t, bad, outs_j, outs_t, drawn, gt, after_reset,
     carried) = streamed
    sj = _compare(sys_j, sys_t, outs_j, outs_t, bad, gt)
    check_carried_priors(carried)
    assert after_reset == dict(
        frame_idx=0, kf_count=0, pending_chunk=None, loop_dev=None,
        anchor_dev=None, anchor_live=False, pending_loop=None,
        initialized=False, pnp_fresh=True)
    # Block mode records the published poses, not the failure marker.
    assert sj[4] == N_FRAMES - 1
    # Every frame tracked once, and the frames from the one after the
    # failure to the end of the discarded block tracked twice.
    assert drawn == N_FRAMES + (BOOT + 3 * BLOCK) - (bad + 1)
    assert sys_t._dispatch_seq == sys_j._dispatch_seq
    assert sys_t.timings["blocks"] == sys_j.timings["blocks"]
