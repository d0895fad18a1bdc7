"""vins_tpu_torch's scale-out layer against the JAX package, on the CPU:
the synthetic window and BA generators, the select-variant backend step
vmapped over B streams, run_sequence_scan and VinsEstimator, the mesh,
the landmark-sharded BA and global BA over gloo worlds of 2 and 4
processes, and the scaling report, at tests/test_parallel.py's sizes.

The multi-rank cases spawn tests/torch_ranks.py once per world size
(module fixture): every rank joins with init_method file:// in a
temporary directory and a 60 s timeout, and the fixture waits at most
RANKS_TIMEOUT_S for them, so a hung rank fails the tests instead of
stalling the run. The ranks import neither jax nor vins_tpu. JAX's
sharded solves run on the 8-device virtual CPU mesh of conftest.py.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu import default_config as j_default_config
from vins_tpu.core import estimator as j_est
from vins_tpu.io import synthetic as j_syn
from vins_tpu.parallel import make_batched_step as j_make_batched_step
from vins_tpu.parallel import make_mesh as j_make_mesh
from vins_tpu.parallel import solve_ba_sharded as j_solve_ba_sharded
from vins_tpu.parallel import stack_inputs as j_stack_inputs
from vins_tpu.parallel import stack_states as j_stack_states

from vins_tpu_torch import interop
from vins_tpu_torch.core import estimator as t_est
from vins_tpu_torch.io import synthetic as t_syn
from vins_tpu_torch.parallel import (make_batched_sequence_runner,
                                     make_batched_step, make_mesh, solve_ba,
                                     stack_inputs, stack_states)

sys.path.insert(0, os.path.dirname(__file__))
import torch_ranks  # noqa: E402

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS_TIMEOUT_S = 240
TCFG = torch_ranks.tiny_config()
F = TCFG.window.num_frames
# Backend sequence frames: at 50 Hz the parallax alternates around the
# keyframe threshold, so both slides run; the last frame's IMU is garbage
# and fails, so the scan freezes its state there.
N_SEQ, SEQ_DT, FAIL_AT = 4, 0.02, 3


@functools.cache
def jcfg():
    """tests/test_parallel.py's tiny_config()."""
    cfg = j_default_config()
    return cfg.replace(
        window=cfg.window.__class__(window_size=4, max_imu_per_edge=8,
                                    max_landmarks=32),
        frontend=cfg.frontend.__class__(max_features=32,
                                        target_features=16))


@functools.cache
def _jitted():
    """The JAX bootstrap, ingest and triangulation, jitted once (eager
    they take tens of seconds on the CPU)."""
    from vins_tpu.core import feature_manager as fm
    cfg = jcfg()
    return dict(
        boot=jax.jit(lambda s, f, c, ext, g: j_est.BackendState.bootstrap(
            cfg, s, f, c, ext, g)),
        ingest=jax.jit(fm.ingest_frame),
        triangulate=jax.jit(lambda w, f, ext: fm.triangulate(w, f, ext,
                                                             cfg)))


def _np(x):
    return np.array(jax.device_get(x))


def _equal_trees(t, j, name):
    if hasattr(j, "_fields"):
        for f in j._fields:
            if getattr(j, f) is not None:
                _equal_trees(getattr(t, f), getattr(j, f), f"{name}.{f}")
        return
    a, b = t.numpy(), _np(j)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    np.testing.assert_array_equal(a, b, err_msg=name)


# -- the synthetic generators ----------------------------------------------

@pytest.mark.parametrize("seed,noise_px,imu_noise", [(0, 0.0, 0.0),
                                                     (3, 0.3, 1.0)])
def test_make_synthetic_window_matches_jax(seed, noise_px, imu_noise):
    """The same seed gives the same window, bit for bit."""
    kw = dict(n_landmarks=24, seed=seed, noise_px=noise_px,
              imu_noise=imu_noise)
    _equal_trees(t_syn.make_synthetic_window(TCFG, device="cpu", **kw),
                 j_syn.make_synthetic_window(jcfg(), **kw), "window")


def test_make_ba_problem_matches_jax():
    kw = dict(n_poses=8, n_landmarks=64, seed=1, noise_px=0.5,
              pose_noise=0.05, point_noise=0.2)
    for t, j in zip(t_syn.make_ba_problem(device="cpu", **kw),
                    j_syn.make_ba_problem(**kw)):
        _equal_trees(t, j, type(j).__name__)


# -- the batched backend step -----------------------------------------------

@pytest.fixture(scope="module")
def batched():
    """B = 8 streams of two synthetic worlds: the port's batched step, its
    single-stream steps and the JAX make_batched_step on the 8-device
    mesh."""
    states, inputs, ext, gravity = torch_ranks.stream_problems(TCFG)
    est_b, out_b = make_batched_step(TCFG, ext, gravity)(
        stack_states(states), stack_inputs(inputs))
    n_worlds = len(torch_ranks.STREAM_SEEDS)
    singles = [t_est.backend_step(s, i, TCFG, ext, gravity)
               for s, i in zip(states[:n_worlds], inputs[:n_worlds])]

    cfg = jcfg()
    wins = [j_syn.make_synthetic_window(cfg, n_landmarks=24, seed=s,
                                        noise_px=0.3)
            for s in torch_ranks.STREAM_SEEDS]
    js = [_jitted()["boot"](w.state, w.feats, w.chunks, w.ext, w.gravity)
          for w in wins]
    ji = [j_est.FrameInput(chunk=jax.tree.map(lambda x: x[-1], w.chunks),
                           ids=w.feats.track_id, obs=w.feats.obs[F - 1],
                           obs_valid=w.feats.mask[F - 1] & w.feats.valid)
          for w in wins]
    tile = lambda xs: [xs[b % n_worlds]
                       for b in range(torch_ranks.N_STREAMS)]
    step = j_make_batched_step(cfg, wins[0].ext, wins[0].gravity,
                               j_make_mesh(batch=8, block=1))
    est_j, out_j = step(j_stack_states(tile(js)), j_stack_inputs(tile(ji)))
    return dict(est_b=est_b, out_b=out_b, singles=singles, est_j=est_j,
                out_j=jax.device_get(out_j))


def test_batched_step_matches_jax(batched):
    """Keyframe and failure decisions equal; poses within 1e-3 m (the
    backend step's parity bound), the slid windows too."""
    o, oj = batched["out_b"], batched["out_j"]
    np.testing.assert_array_equal(o.is_keyframe.numpy(), oj.is_keyframe)
    np.testing.assert_array_equal(o.failure.numpy(), oj.failure)
    np.testing.assert_allclose(o.pose_p.numpy(), oj.pose_p, atol=1e-3)
    np.testing.assert_allclose(batched["est_b"].window.p.numpy(),
                               _np(batched["est_j"].window.p), atol=1e-3)


def _information(prior):
    """(JᵀJ, Jᵀr) of a prior in float64: its square-root factor is not
    unique to float32 round-off near singularity, its information is."""
    J = prior.J.double().numpy()
    return J.T @ J, J.T @ prior.r.double().numpy()


def test_batched_step_matches_single_streams(batched):
    """Each stream of the vmapped select variant against the main path's
    host-branch step on its world alone: decisions equal, output pose and
    slid window within 1e-4 m, the new prior's information within 1e-3
    of its scale (tests/test_torch_backend.py's _same_information)."""
    o, e = batched["out_b"], batched["est_b"]
    singles = batched["singles"]
    for b in range(torch_ranks.N_STREAMS):
        es, os_ = singles[b % len(singles)]
        assert bool(o.is_keyframe[b]) == bool(os_.is_keyframe)
        assert bool(o.failure[b]) == bool(os_.failure)
        np.testing.assert_allclose(o.pose_p[b].numpy(), os_.pose_p.numpy(),
                                   atol=1e-4, err_msg=f"stream {b}")
        np.testing.assert_allclose(e.window.p[b].numpy(),
                                   es.window.p.numpy(), atol=1e-4,
                                   err_msg=f"stream {b}")
        Hb, gb = _information(t_est.tree_index(e.prior, b))
        Hs, gs = _information(es.prior)
        assert np.abs(Hb - Hs).max() <= 1e-3 * np.abs(Hs).max()
        assert np.abs(gb - gs).max() <= 1e-2 * max(np.abs(gs).max(), 1e-3)


# -- run_sequence_scan, VinsEstimator and the sequence runner ---------------

def _jax_backend_inputs(cfg, n_frames, seed, frame_dt):
    """bench.py's build_backend_inputs with a frame interval (its steps
    jitted)."""
    from vins_tpu.core.state import FeatureTable

    fns = _jitted()
    Fc = cfg.window.num_frames
    seq = j_syn.make_synthetic_sequence(
        cfg, n_frames=Fc + n_frames, n_landmarks=300, seed=seed,
        noise_px=0.5, frame_dt=frame_dt)
    feats = FeatureTable.empty(Fc, cfg.window.max_landmarks)
    for f in range(Fc):
        feats = fns["ingest"](feats, jnp.asarray(f), seq.ids[f],
                              seq.obs[f], seq.obs_valid[f])
    chunks = jax.tree.map(lambda x: x[1:Fc], seq.chunks)
    win = j_est.BackendState.fresh(cfg).window._replace(
        p=seq.p[:Fc], q=seq.q[:Fc], v=seq.v[:Fc])
    win = fns["triangulate"](win, feats, seq.ext)
    est = fns["boot"](win, feats, chunks, seq.ext, seq.gravity)
    inputs = j_est.FrameInput(
        chunk=jax.tree.map(lambda x: x[Fc:], seq.chunks),
        ids=seq.ids[Fc:], obs=seq.obs[Fc:], obs_valid=seq.obs_valid[Fc:])
    return est, inputs, seq.ext, seq.gravity


def _garbage_at(inputs, k):
    """inputs with frame k's IMU chunk replaced by a failing one
    (tests/test_estimator.py's garbage IMU)."""
    ch = jax.tree.map(np.array, inputs.chunk)
    ch.dt[k] = 0.0
    ch.dt[k, 1:] = 0.01
    ch.acc[k] = 300.0
    ch.gyr[k] = 50.0
    return inputs._replace(chunk=type(inputs.chunk)(
        *[jnp.asarray(x) for x in ch]))


@pytest.fixture(scope="module")
def scan():
    """The JAX sequence (failing at its last frame) through the JAX scan and
    VinsEstimator, and carried into the port through its own."""
    cfg = jcfg()
    est_j, inp_j, ext_j, grav_j = _jax_backend_inputs(cfg, N_SEQ, 0, SEQ_DT)
    inp_j = _garbage_at(inp_j, FAIL_AT)
    fin_j, outs_j = jax.jit(lambda e, i: j_est.run_sequence_scan(
        e, i, cfg, ext_j, grav_j))(est_j, inp_j)
    ve_j = j_est.VinsEstimator(cfg, ext_j)
    ve_j.state, ve_j.initialized = est_j, True
    frames_j = []
    for k in range(N_SEQ):
        frames_j.append(jax.device_get(ve_j.process_frame(
            jax.tree.map(lambda x: x[k], inp_j))))

    like_est, like_inp, ext, grav = t_syn.build_backend_inputs(
        TCFG, N_SEQ, seed=0, frame_dt=SEQ_DT, device="cpu")
    est_t = interop.to_torch(jax.device_get(est_j), like_est)
    inp_t = interop.to_torch(jax.device_get(inp_j), like_inp)
    ext = type(ext)(*[torch.as_tensor(_np(x)) for x in ext_j])
    fin_t, outs_t = t_est.run_sequence_scan(est_t, inp_t, TCFG, ext, grav)
    ve_t = t_est.VinsEstimator(TCFG, ext, device="cpu")
    ve_t.state, ve_t.initialized = est_t, True
    frames_t = []
    for k in range(N_SEQ):
        if k == FAIL_AT:
            before_fail = ve_t.state
        frames_t.append(ve_t.process_frame(t_est.tree_index(inp_t, k)))
    return dict(fin_j=jax.device_get(fin_j), outs_j=jax.device_get(outs_j),
                frames_j=frames_j, ve_j=ve_j, fin_t=fin_t, outs_t=outs_t,
                before_fail=before_fail, frames_t=frames_t, ve_t=ve_t,
                est_t=est_t, inp_t=inp_t, ext=ext, grav=grav)


def test_run_sequence_scan_matches_jax(scan):
    """Both slides run, the last frame fails, and decisions are equal to the
    JAX scan's; poses within 1e-3 m; the final state is the frozen one
    (exactly the state VinsEstimator's host-branch steps reach before
    that frame) and within 1e-3 m of the JAX scan's."""
    o, oj = scan["outs_t"], scan["outs_j"]
    kf = o.is_keyframe.numpy()
    assert kf.any() and not kf.all(), kf
    fail = o.failure.numpy()
    assert fail[FAIL_AT] and not fail[:FAIL_AT].any(), fail
    np.testing.assert_array_equal(kf, oj.is_keyframe)
    np.testing.assert_array_equal(fail, oj.failure)
    np.testing.assert_allclose(o.pose_p[:FAIL_AT].numpy(),
                               oj.pose_p[:FAIL_AT], atol=1e-3)
    fin, before = scan["fin_t"], scan["before_fail"]
    for a, b in zip(torch.utils._pytree.tree_leaves(fin),
                    torch.utils._pytree.tree_leaves(before)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(fin.window.p.numpy(), scan["fin_j"].window.p,
                               atol=1e-3)
    np.testing.assert_allclose(fin.window.q.numpy(), scan["fin_j"].window.q,
                               atol=1e-3)


def test_vins_estimator_matches_jax(scan):
    """VinsEstimator frame by frame (the host-branch step): the JAX shell's
    decisions, poses within 1e-3 m, the select variant's outputs exactly,
    and uninitialized after the failure (process_frame then raises)."""
    for k, (ft, fj) in enumerate(zip(scan["frames_t"], scan["frames_j"])):
        assert bool(ft.is_keyframe) == bool(fj.is_keyframe), k
        assert bool(ft.failure) == bool(fj.failure), k
        if k < FAIL_AT:
            np.testing.assert_allclose(ft.pose_p.numpy(), fj.pose_p,
                                       atol=1e-3)
        assert torch.equal(ft.pose_p, scan["outs_t"].pose_p[k]), k
    assert not scan["ve_t"].initialized and not scan["ve_j"].initialized
    with pytest.raises(RuntimeError, match="not initialized"):
        scan["ve_t"].process_frame(t_est.tree_index(scan["inp_t"], 0))


def test_batched_sequence_runner_matches_single_scans(scan):
    """make_batched_sequence_runner over two streams (the scan's sequence
    and the same without its failing frame): each stream's decisions
    equal to run_sequence_scan's on it alone, its failure frozen on its
    own, poses within 1e-3 m. Not 1e-4: the batched products round
    otherwise, and the next frames' LM solves amplify that (up to
    2.8e-4 m after one step from the same state on this sequence)."""
    inp_t = scan["inp_t"]
    ok_chunk = t_syn.build_backend_inputs(
        TCFG, N_SEQ, seed=0, frame_dt=SEQ_DT, device="cpu")[1].chunk
    inp_ok = inp_t._replace(chunk=ok_chunk)
    run = make_batched_sequence_runner(TCFG, scan["ext"], scan["grav"])
    fin_b, outs_b = run(stack_states([scan["est_t"]] * 2),
                        stack_inputs([inp_t, inp_ok]))
    fin_ok, outs_ok = t_est.run_sequence_scan(scan["est_t"], inp_ok, TCFG,
                                              scan["ext"], scan["grav"])
    for b, (fin, outs) in enumerate(((scan["fin_t"], scan["outs_t"]),
                                     (fin_ok, outs_ok))):
        np.testing.assert_array_equal(outs_b.failure[b].numpy(),
                                      outs.failure.numpy())
        np.testing.assert_array_equal(outs_b.is_keyframe[b].numpy(),
                                      outs.is_keyframe.numpy())
        np.testing.assert_allclose(outs_b.pose_p[b].numpy(),
                                   outs.pose_p.numpy(), atol=1e-3)
        np.testing.assert_allclose(fin_b.window.p[b].numpy(),
                                   fin.window.p.numpy(), atol=1e-3)
    assert not outs_ok.failure.any()


# -- the mesh and the landmark-sharded BA over gloo worlds -------------------

def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(block=2, device_type="cpu")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """tests/torch_ranks.py in gloo worlds of 2 and 4 processes, both at
    once; {world size: each rank's results}."""
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    procs = {}
    for n in (2, 4):
        d = tmp_path_factory.mktemp(f"world{n}")
        procs[n] = (d, [subprocess.Popen(
            [sys.executable, os.path.join(_REPO, "tests", "torch_ranks.py"),
             str(n), str(r), str(d / "init"), str(d)], env=env, cwd=_REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)])
    logs = {}
    try:
        for n, (_, ps) in procs.items():
            logs[n] = [p.communicate(timeout=RANKS_TIMEOUT_S)[0] for p in ps]
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank hung past {RANKS_TIMEOUT_S} s")
    finally:
        for _, ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    out = {}
    for n, (d, ps) in procs.items():
        for r, (p, log) in enumerate(zip(ps, logs[n])):
            assert p.returncode == 0, f"world {n} rank {r}: {log[-3000:]}"
        out[n] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                  for r in range(n)]
    return out


@pytest.fixture(params=[2, 4], ids=["world2", "world4"])
def world(request, worlds):
    return request.param, worlds[request.param]


def _ba_inputs(prior: bool):
    """The ranks' BA problem on both sides; without a prior the JAX side's
    is the inert one that its solver materializes (one jit for both)."""
    kw = dict(n_poses=8, n_landmarks=64, seed=1, pose_noise=0.05,
              point_noise=0.2)
    gt_j, init_j, prob_j = j_syn.make_ba_problem(**kw)
    gt_t, init_t, prob_t = t_syn.make_ba_problem(device="cpu", **kw)
    w = 0.1 if prior else 0.0
    prob_j = prob_j._replace(prior_p=init_j.p if prior else
                             jnp.zeros_like(init_j.p),
                             prior_w=jnp.asarray(w, jnp.float32))
    if prior:
        prob_t = prob_t._replace(prior_p=init_t.p,
                                 prior_w=torch.tensor(0.1))
    return (init_j, prob_j), (init_t, prob_t)


@functools.cache
def _j_sharded(block: int):
    mesh = j_make_mesh(batch=1, block=block, devices=jax.devices()[:block])
    return jax.jit(functools.partial(j_solve_ba_sharded, mesh=mesh,
                                     iters=8))


def test_ranks_import_neither_jax_nor_the_jax_package(world):
    n, ranks = world
    assert all(r["imported"] == [] for r in ranks)


def test_make_mesh_in_a_gloo_world(world):
    """make_mesh's shapes and dim names, batch=0 filling the world."""
    n, ranks = world
    want = {str([("block", n)]): ((1, n), ("batch", "block")),
            str([("batch", n)]): ((n, 1), ("batch", "block"))}
    if n == 4:
        want[str([("batch", 2), ("block", 2)])] = ((2, 2),
                                                   ("batch", "block"))
    for r in ranks:
        assert r["mesh"] == want


@pytest.mark.parametrize("tag", ["ba", "ba_prior"])
def test_solve_ba_sharded_matches_jax(world, tag):
    """solve_ba_sharded at block = world size against the JAX
    solve_ba_sharded at the same block count on the virtual mesh and
    against the port's solve_ba: the cost within rtol 1e-3 (atol 1e-6),
    the poses within atol 1e-4 / rtol 1e-3 (tests/test_parallel.py:44-47);
    every rank holds the same poses, cost and gathered points."""
    n, ranks = world
    (init_j, prob_j), (init_t, prob_t) = _ba_inputs(tag == "ba_prior")
    st_j, cost_j, _ = _j_sharded(n)(init_j, prob_j)
    st_1, cost_1, _ = solve_ba(init_t, prob_t, iters=8)
    r0 = ranks[0][tag]
    assert r0["pts"].shape == init_t.pts.shape
    for ref_cost, ref_p in ((_np(cost_j), _np(st_j.p)),
                            (cost_1.numpy(), st_1.p.numpy())):
        np.testing.assert_allclose(r0["cost"].numpy(), ref_cost, rtol=1e-3,
                                   atol=1e-6)
        np.testing.assert_allclose(r0["p"].numpy(), ref_p, rtol=1e-3,
                                   atol=1e-4)
    for r in ranks[1:]:
        for k in ("p", "q", "pts", "cost", "hist"):
            assert torch.equal(r[tag][k], r0[k]), k


def test_global_ba_sharded_refines_the_map(world):
    """LoopCloser.global_ba(mesh=...) over the world (rank 0 owns the DB):
    the pose error at most 0.85 of the drifted input's, within 2e-3 m of
    global_ba(mesh=None) on the same map (tests/test_parallel.py:216-222),
    and the same cost on every rank."""
    n, ranks = world
    lc, p_gt = torch_ranks.fake_keyframe_db(pose_noise=0.05,
                                            point_noise=0.1)
    err_before = np.linalg.norm(lc.db.p[:12].numpy() - p_gt, axis=1).mean()
    cost_1 = lc.global_ba(mesh=None, iters=8)
    p_after = ranks[0]["global_ba_p"].numpy()
    err_after = np.linalg.norm(p_after - p_gt, axis=1).mean()
    assert err_after < err_before * 0.85, (err_before, err_after)
    np.testing.assert_allclose(p_after, lc.db.p[:12].numpy(), atol=2e-3)
    assert ranks[0]["global_ba_cost"] == pytest.approx(cost_1, rel=1e-3)
    assert len({r["global_ba_cost"] for r in ranks}) == 1


def test_global_ba_followers_take_the_owners_iters(world):
    """global_ba(mesh=..., iters=3) on rank 0 while the followers name no
    count: every rank runs rank 0's 3 iterations (the same cost on every
    rank, that of global_ba(mesh=None, iters=3))."""
    n, ranks = world
    lc, _ = torch_ranks.fake_keyframe_db(pose_noise=0.05, point_noise=0.1)
    cost_3 = lc.global_ba(mesh=None, iters=3)
    assert len({r["global_ba_cost_3"] for r in ranks}) == 1
    assert ranks[0]["global_ba_cost_3"] == pytest.approx(cost_3, rel=1e-3)
    assert ranks[0]["global_ba_cost_3"] != ranks[0]["global_ba_cost"]


def test_scaling_report_rows(world):
    """One row per block count the world can form, the all_reduce payload
    4·((6K)² + 6K) bytes, finite costs and seconds, speedup 1 first."""
    n, ranks = world
    rows = ranks[0]["scaling"]
    assert [r["block"] for r in rows] == [b for b in (1, 2, 4) if b <= n]
    assert rows[0]["speedup"] == 1.0
    for r in rows:
        assert r["psum_bytes_per_iter"] == 4 * ((6 * 8) ** 2 + 6 * 8)
        assert r["landmarks_per_shard"] == 64 // r["block"]
        assert np.isfinite(r["final_cost"]) and r["wall_s_per_solve"] > 0


def test_batched_step_split_over_the_batch_axis(world, batched):
    """make_batched_step(mesh=...): each rank steps its slice of the 8
    streams; the slices in rank order equal the single-process batched
    step (decisions exactly, poses within 1e-4 m)."""
    n, ranks = world
    o = batched["out_b"]
    got = {k: torch.cat([r["batched"][k] for r in ranks])
           for k in ("pose_p", "is_keyframe", "failure")}
    assert torch.equal(got["is_keyframe"], o.is_keyframe)
    assert torch.equal(got["failure"], o.failure)
    np.testing.assert_allclose(got["pose_p"].numpy(), o.pose_p.numpy(),
                               atol=1e-4)


def test_new_modules_import_neither_jax_nor_the_jax_package():
    """The scale-out modules and the profiler import no jax and no
    vins_tpu module."""
    code = (
        "import sys\n"
        "import vins_tpu_torch.parallel, vins_tpu_torch.parallel.mesh, "
        "vins_tpu_torch.parallel.batched, vins_tpu_torch.parallel.scaling, "
        "vins_tpu_torch.utils.profiling, vins_tpu_torch.core.estimator\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'vins_tpu', 'triton'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "clean"


def test_run_euroc_joins_a_two_rank_world(tmp_path):
    """run_euroc with WORLD_SIZE = 2 (torchrun's environment, gloo on the
    CPU): rank 0 runs 12 frames of the 80-frame ASL fixture (11 aligned
    with the IMU), too few to initialize, so its sharded global BA finds
    no map and releases rank 1, which waited in it; both exit 0 inside
    RANKS_TIMEOUT_S, rank 0 reports 2 devices."""
    import json
    import socket

    from conftest import asl_fixture_cached

    root, _ = asl_fixture_cached(n_frames=80, seed=5)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1",
                   WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "vins_tpu_torch.run_euroc", "--root",
             root, "--frames", "12", "--global-ba", "--device", "cpu",
             "--dist-timeout", "120", "--out", str(tmp_path / "out")],
            env=env, cwd=_REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=RANKS_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    results = [json.loads([ln for ln in log.splitlines()
                           if ln.startswith("{")][-1]) for log in logs]
    assert results[0]["frames"] == 11
    assert results[0]["global_ba_devices"] == 2
    assert results[0]["global_ba_cost"] is None
    assert results[1] == {"rank": 1, "global_ba_cost": None}
