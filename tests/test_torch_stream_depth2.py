"""process_stream at its default depth 2 in both packages, on the CPU:
the lockstep of a loop-on stream whose verified hit is staged during the
stream (two blocks in flight, so the hit first rides the block after
next), the real-time budget policy under one patched clock, and the
global BA (harvest, solve, write-back) on the keyframe DB of the JAX run.

The lockstep reuses test_torch_stream_loop.py's config, ground-truth
bootstrap and state carry: both systems stream the bootstrap and a block,
the JAX state is carried into the port, and the same verified hit (the
first keyframe row, at its stored pose) is queued on both sides. The
first sync of the next stream stages it after the second block was
dispatched; each dispatch is stamped, so the block already in flight is
not charged for it. Against a port whose process_stream has no `depth`,
this file fails with a TypeError.

The lockstep also records, on each side, every two-view triangulation
gate decision (feature_manager.triangulate: a new landmark whose DLT
depth in its anchor camera comes out under GATE_DEPTH takes the init
depth instead) with its margin to the gate, computed in float64 from
that side's own inputs. It reports the closest margin of every backend
frame on both sides, and where the per-frame comparison fails it names
the first gate decision the two sides took differently before that
frame, so that a flip reads as a flip and not as drift.
"""
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_watchdog
from conftest import render_cached
from test_torch_interactive import loop_record
from test_torch_stream import (_rot_err, carry_priors, check_carried_priors,
                               jax_ransac_noise)
from test_torch_stream_loop import (BLOCK, CFG, F, N_FIRST, SEED, TCFG,
                                    _PACK_COLS, _carry_state)

from vins_tpu_torch import interop
from vins_tpu_torch import pipeline as t_pipe
from vins_tpu_torch.core.preintegration import ImuChunk
from vins_tpu_torch.io import synthetic as t_syn
from vins_tpu_torch.loop import keyframe_db as t_kdb
from vins_tpu_torch.parallel import dist_ba as t_ba
from vins_tpu_torch.parallel import harvest as t_harvest

pytest_plugins = ["torch_watchdog"]

torch.set_num_threads(1)

N_FRAMES = N_FIRST + 6 * BLOCK      # stage, ride from block 2, retire
# Half test_torch_stream_loop.py's turn rate: at depth 2 the hit rides two
# blocks (12 frames) after its keyframe row was the newest, and at
# w = 0.7 rad/s the view has turned 17 degrees by then, past what the
# ride-time attach matches.
TRAJ = dict(w=0.35, bob=0.15)


# The two-view triangulation gate of feature_manager.triangulate in both
# packages (feature_manager.cpp:190-256): depth under it takes the init
# depth.
GATE_DEPTH = 0.1


def _rotmat64(q):
    w, x, y, z = np.moveaxis(np.asarray(q, np.float64), -1, 0)
    return np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y), 2 * (x * y + w * z),
                     1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1).reshape(
                         np.shape(q)[:-1] + (3, 3))


def gate_decisions(p, q, inv_depth, obs, mask, anchor, valid, track_id,
                   tic, qic, inv_out, init_depth):
    """One triangulate call's gate decisions: for every slot it fills
    (valid, not yet initialized, seen at least twice), the track id, the
    DLT depth in its anchor camera by triangulate's own formula in
    float64 (NaN where its normal equations are singular) and whether
    the call took the init depth (inv_out, the call's output, at
    1 / init_depth)."""
    p, obs = np.asarray(p, np.float64), np.asarray(obs, np.float64)
    mask, anchor = np.asarray(mask, bool), np.asarray(anchor).astype(int)
    R_wb = _rotmat64(q)
    R_wc = R_wb @ _rotmat64(qic)
    t_wc = p + np.einsum("fij,j->fi", R_wb, np.asarray(tic, np.float64))
    R_rel = np.einsum("fij,mik->fmjk", R_wc, R_wc[anchor])
    t_rel = np.einsum("fij,fmi->fmj", R_wc,
                      t_wc[anchor][None] - t_wc[:, None])
    P = np.concatenate([R_rel, t_rel[..., None]], -1)      # [F, M, 3, 4]
    w = mask[..., None]
    rows = np.concatenate([(obs[..., :1] * P[..., 2, :] - P[..., 0, :]) * w,
                           (obs[..., 1:] * P[..., 2, :] - P[..., 1, :]) * w])
    B, c = rows[..., :3], -rows[..., 3]
    N = np.einsum("rma,rmb->mab", B, B)
    b = np.einsum("rma,rm->ma", B, c)
    need = (np.asarray(valid, bool) & (np.asarray(inv_depth) <= 0)
            & (mask.sum(0) >= 2))
    depth = np.full(need.shape, np.nan)
    ok = need & (np.abs(np.linalg.det(N)) > 1e-12)
    depth[ok] = np.linalg.solve(N[ok], b[ok][..., None])[:, 2, 0]
    took_init = np.asarray(inv_out) == np.float32(1.0 / init_depth)
    return dict(tids=np.asarray(track_id)[need], depth=depth[need],
                took_init=took_init[need])


def record_gate_decisions(mp, rec):
    """Record in rec["gate_j"] / rec["gate_t"], call by call, each
    package's triangulate gate decisions (gate_decisions); the JAX side's
    through an ordered host callback inside its jitted scan."""
    from vins_tpu.core import feature_manager as j_fm
    from vins_tpu_torch.core import feature_manager as t_fm

    rec.update(gate_j=[], gate_t=[])
    j_tri, t_tri = j_fm.triangulate, t_fm.triangulate

    def args(state, feats, ext, out):
        return (state.p, state.q, state.inv_depth, feats.obs, feats.mask,
                feats.anchor, feats.valid, feats.track_id, ext.tic, ext.qic,
                out.inv_depth)

    def ref(state, feats, ext, cfg):
        out = j_tri(state, feats, ext, cfg)
        jax.debug.callback(lambda *a: rec["gate_j"].append(gate_decisions(
            *a, cfg.window.init_depth)), *args(state, feats, ext, out),
            ordered=True)
        return out

    def port(state, feats, ext, cfg):
        out = t_tri(state, feats, ext, cfg)
        rec["gate_t"].append(gate_decisions(
            *[x.numpy() for x in args(state, feats, ext, out)],
            cfg.window.init_depth))
        return out

    mp.setattr(j_fm, "triangulate", ref)
    mp.setattr(t_fm, "triangulate", port)


def closest_margin(call) -> float:
    """depth - GATE_DEPTH of the call's decision closest to the gate,
    negative where the depth fell under it (inf if it filled no slot)."""
    m = call["depth"] - GATE_DEPTH
    m = m[np.isfinite(m)]
    return float(m[np.argmin(np.abs(m))]) if len(m) else float("inf")


def first_flip(gate_j, gate_t, upto):
    """The first of the first `upto` triangulate calls where the two
    sides fill the same track and one takes the init depth while the
    other keeps its DLT depth: (call index, track id, reference depth,
    port depth), or None."""
    for i, (cj, ct) in enumerate(zip(gate_j[:upto], gate_t[:upto])):
        both, ij, it = np.intersect1d(cj["tids"], ct["tids"],
                                      return_indices=True)
        diff = cj["took_init"][ij] != ct["took_init"][it]
        if diff.any():
            k = int(np.argmax(diff))
            return i, int(both[k]), float(cj["depth"][ij[k]]), \
                float(ct["depth"][it[k]])
    return None


def _instrument(sys_, log):
    """Record each dispatched block's LGOOD/LRET flags, each anchor
    staging (stream frame, row), each pose-graph run's frame, and at each
    sync the synced block's stamp and the staged constraint's "rode"
    stamps."""
    dispatch, sync = sys_.dispatch_block, sys_.sync_block
    optimize, stage = sys_.loop.optimize, sys_._stage_anchor_from_hit

    def dispatch_block(*a, **kw):
        handle = dispatch(*a, **kw)
        packed = handle[0].packed
        log["flags"].append(np.asarray(packed.cpu() if isinstance(
            packed, torch.Tensor) else packed)[:, list(_PACK_COLS)])
        return handle

    def sync_block(handle):
        pl = sys_._pending_loop
        log["events"].append(("sync", int(handle[-1]), None if pl is None
                              else sorted(pl.get("rode", ()))))
        return sync(handle)

    def opt(*a, **kw):
        log["events"].append(("optimize", sys_.frame_idx))
        return optimize(*a, **kw)

    def stg(hit):
        log["events"].append(("stage", sys_.frame_idx, hit.old_idx))
        return stage(hit)

    sys_.dispatch_block, sys_.sync_block = dispatch_block, sync_block
    sys_.loop.optimize, sys_._stage_anchor_from_hit = opt, stg


def run_streams():
    """Both systems streamed at depth 2 (module docstring): their outputs,
    loop events, dispatched flags, gate decisions, carried priors and the
    two live systems."""
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
    log_j = dict(flags=[], events=[])
    log_t = dict(flags=[], events=[])
    _instrument(sys_j, log_j)
    _instrument(sys_t, log_t)

    mp = pytest.MonkeyPatch()
    mp.setattr(j_pipe.init_mod, "initialize", gt_initialize)
    carried = carry_priors(mp, j_pipe, TCFG)
    gates = {}
    record_gate_decisions(mp, gates)
    sys_j._refine_init = lambda w, fe, ch: (w, 0.0)
    imgs_t = torch.as_tensor(imgs)

    def run(s, e):
        oj = sys_j.process_stream(
            jnp.asarray(imgs[s:e]), jax.tree.map(lambda x: x[s:e],
                                                 seq.chunks),
            block=BLOCK, ts=ts[s:e], depth=2)
        ot = sys_t.process_stream(
            imgs_t[s:e], ImuChunk(*[x[s:e] for x in tseq.chunks]),
            block=BLOCK, ts=tseq.timestamps.numpy()[s:e], depth=2,
            gumbel=torch.as_tensor(noise[s:e]))
        return oj, ot

    try:
        first_j, first_t = run(0, N_FIRST)
        _carry_state(sys_j, sys_t)
        assert sys_j.loop.count >= 1
        old = sys_j.loop.count - 1
        hit = dict(old_idx=old, cur_idx=old, n_inliers=40,
                   t_rel=np.zeros(3, np.float32), yaw_rel=0.0,
                   p_old=np.asarray(sys_j.loop.db.p_origin[old]),
                   q_old=np.asarray(sys_j.loop.db.q_origin[old]))
        hj, ht = JHit(**hit), t_kdb.LoopHit(**hit)
        sys_j._stage_queue.append(
            hj._replace(edge_abs=sys_j.loop._add_loop_edge(hj)))
        sys_t._stage_queue.append(
            ht._replace(edge_abs=sys_t.loop._add_loop_edge(ht)))
        outs_j, outs_t = run(N_FIRST, N_FRAMES)
        jax.effects_barrier()
    finally:
        mp.undo()
    return dict(first_j=first_j, first_t=first_t, outs_j=outs_j,
                carried=carried, gate_j=gates["gate_j"],
                gate_t=gates["gate_t"],
                outs_t=outs_t, sys_j=sys_j, sys_t=sys_t,
                flags_j=np.concatenate(log_j["flags"]),
                flags_t=np.concatenate(log_t["flags"]),
                ev_j=log_j["events"], ev_t=log_t["events"])


def test_depth2_stages_after_the_next_dispatch(streams):
    """Both packages stage the queued hit at the first sync of the second
    stream, when two blocks are in flight: the constraint's first rode
    stamp is the block after next, the block already in flight is synced
    without charging it, and the anchor attaches, rides, retires and runs
    the pose graph on the same frames. The sync, stage and pose-graph
    events and the per-frame LGOOD/LRET flags are identical."""
    s = streams
    assert s["ev_t"] == s["ev_j"]
    stages = [e for e in s["ev_j"] if e[0] == "stage"]
    assert stages == [("stage", N_FIRST + 2 * BLOCK, 0)]
    syncs = [e for e in s["ev_j"] if e[0] == "sync"]
    first = syncs[1][1]          # the second stream's first synced block
    assert syncs[2] == ("sync", first + 1, [first + 2])
    assert syncs[3] == ("sync", first + 2, [first + 2, first + 3])
    fj, ft = s["flags_j"], s["flags_t"]
    assert fj.shape == ft.shape
    np.testing.assert_array_equal(ft > 0.5, fj > 0.5)
    good = fj[:, 0] > 0.5
    assert good.any(), "the staged anchor never attached"
    # One row per dispatched frame: the first stream's one block, then
    # the second stream's; nothing rides its blocks 0 and 1.
    assert not good[:3 * BLOCK].any()
    assert (fj[:, 1] > 0.5).any(), "the loop constraint never retired"
    st_t = s["loop_stats"]
    assert (st_t["staged"], st_t["attached"]) == (1, 1)
    lj, lt = s["after_j"], s["after_t"]
    assert lt["n_optimizes"] == lj["n_optimizes"] >= 1
    assert lt["count"] == lj["count"]
    assert lt["loop_w_host"] == lj["loop_w_host"] == [s["W_REFINED"]]
    assert not lt["pending"] and not lj["pending"]
    assert lt["dispatch_seq"] == lj["dispatch_seq"]
    np.testing.assert_allclose(lt["t_drift"], lj["t_drift"], atol=5e-3)
    np.testing.assert_allclose(lt["r_drift"], lj["r_drift"], atol=5e-3)


def test_depth2_matches_jax_per_frame(streams):
    """Per-frame parity at depth 2: discrete decisions exactly, n_tracked
    within 2, the published (drift-corrected) poses to
    test_torch_stream_loop.py's 5e-3 m / 5e-3 rad, the raw poses to 1e-2
    m: on this circle the two raw VIO estimates part by fp32 round-off
    after the state carry, at about 1.5x a backend frame (0.1 mm 12
    frames after the carry, 5.7 mm 36 frames after it), while the
    loop constraint and the pose graph hold the published poses closer."""
    s = streams
    outs_j = s["first_j"] + s["outs_j"]
    outs_t = s["first_t"] + s["outs_t"]
    assert len(outs_j) == len(outs_t) == N_FRAMES
    n_corr = 0
    for k, (oj, ot) in enumerate(zip(outs_j, outs_t)):
        try:
            assert (oj.initialized, oj.is_keyframe, oj.status,
                    oj.loop_hit) == (ot.initialized, ot.is_keyframe,
                                     ot.status, ot.loop_hit), k
            assert abs(oj.n_tracked - ot.n_tracked) <= 2, k
            if not oj.initialized:
                continue
            np.testing.assert_allclose(ot.p, oj.p, atol=5e-3,
                                       err_msg=f"frame {k}")
            np.testing.assert_allclose(ot.p_raw, oj.p_raw, atol=1e-2,
                                       err_msg=f"frame {k}")
            assert _rot_err(np.asarray(oj.q), np.asarray(ot.q)) < 5e-3, k
        except AssertionError as e:
            raise AssertionError(f"{e}\n{_parting(s, k)}") from None
        n_corr += int(np.linalg.norm(np.asarray(oj.p) - np.asarray(oj.p_raw))
                      > 1e-6)
    assert n_corr >= 1, "no published pose carries a drift correction"
    check_carried_priors(s["carried"])


def _gate_frames(s) -> list:
    """The stream frame of each recorded triangulate call: the bootstrap
    at the first initialized frame, then one call per backend frame."""
    outs = s["first_j"] + s["outs_j"]
    init_at = next(k for k, o in enumerate(outs) if o.initialized)
    return [init_at + CFG.freq * i for i in range(len(s["gate_j"]))]


def _parting(s, k) -> str:
    """What parted the two streams by frame k: the first triangulation
    gate decision taken differently before it, or, if none, each side's
    closest margin up to it."""
    frames = _gate_frames(s)
    upto = sum(f <= k for f in frames)
    flip = first_flip(s["gate_j"], s["gate_t"], upto)
    if flip is not None:
        i, tid, dj, dt = flip
        return (f"the streams part at frame {k} after the {GATE_DEPTH} m "
                f"triangulation gate flipped at frame {frames[i]} on track "
                f"{tid}: reference depth {dj:.5f} m, port {dt:.5f} m")
    mj = min((closest_margin(c) for c in s["gate_j"][:upto]), key=abs,
             default=np.inf)
    mt = min((closest_margin(c) for c in s["gate_t"][:upto]), key=abs,
             default=np.inf)
    return (f"no triangulation gate decision differs up to frame {k}; the "
            f"closest margins: reference {mj:+.3g} m, port {mt:+.3g} m")


def test_depth2_reports_triangulation_gate_margins(streams):
    """Both sides triangulate on the same frames (the bootstrap and every
    backend frame) and fill the same tracks wherever neither has taken a
    gate decision the other did not; the closest margin to the 0.1 m gate
    of each such frame is printed for both sides, beside the first flip
    if the two ever decide a track differently (ROADMAP item 33: this
    scene's frame-51 triangulation lies millimetres from the gate)."""
    s = streams
    gj, gt = s["gate_j"], s["gate_t"]
    frames = _gate_frames(s)
    assert len(gj) == len(gt) == 1 + (N_FRAMES - 1 - frames[0]) // CFG.freq
    flip = first_flip(gj, gt, len(gj))
    for i, (f, cj, ct) in enumerate(zip(frames, gj, gt)):
        if flip is None or i < flip[0]:
            np.testing.assert_array_equal(np.sort(ct["tids"]),
                                          np.sort(cj["tids"]), err_msg=f)
        print(f"frame {f}: {len(cj['tids'])} / {len(ct['tids'])} "
              f"triangulations, closest margin to the {GATE_DEPTH} m gate "
              f"{closest_margin(cj):+.4g} m (reference) / "
              f"{closest_margin(ct):+.4g} m (port)")
    print(_parting(s, N_FRAMES - 1))


def _carry_loop(lj, lt):
    """The JAX LoopCloser's DB, pose graph and drift, carried into the
    port's (the lockstep leaves them equal to fp32 round-off)."""
    get = jax.device_get
    lt.db = interop.to_torch(get(lj.db), lt.db)
    lt.graph = interop.to_torch(get(lj.graph), lt.graph)
    lt.r_drift, lt.t_drift = lj.r_drift.copy(), lj.t_drift.copy()
    lt._r_drift_dev = torch.as_tensor(np.array(get(lj._r_drift_dev)))
    lt._t_drift_dev = torch.as_tensor(np.array(get(lj._t_drift_dev)))
    assert (lt.count, lt.n_loops) == (int(lj.db.count), lj.n_loops)


def _global_ba(lj, lt) -> dict:
    """LoopCloser.global_ba on both sides (the same DB, graph and drift),
    and what test_global_ba_writes_the_same_columns reads after it."""
    n = lt.count
    cost_j = lj.global_ba()
    cost_t = lt.global_ba()
    dj, dt = jax.device_get(lj.db), lt.db
    gj, gt = jax.device_get(lj.graph), lt.graph
    cols = lambda db, names: {k: np.asarray(getattr(db, k))[:n]
                              for k in names}
    return dict(
        n=n, cost_j=float(cost_j), cost_t=float(cost_t),
        db_j=cols(dj, ("p_origin", "q_origin", "p", "q")),
        db_t=cols(interop.to_numpy(dt), ("p_origin", "q_origin", "p", "q")),
        graph_j=cols(gj, ("t_origin", "yaw_origin")),
        graph_t=cols(interop.to_numpy(gt), ("t_origin", "yaw_origin")),
        n_optimizes=(lj.n_optimizes, lt.n_optimizes))


def _in_stream_global_ba(lj, lt) -> dict:
    """VinsSystem(global_ba_every_kf=1) in both packages on the carried
    loop closers: insert_block_keyframes twice each (the second adds no
    row), and what test_in_stream_global_ba_matches_jax reads after."""
    from vins_tpu import pipeline as j_pipe
    _carry_loop(lj, lt)
    sys_j = j_pipe.VinsSystem(CFG, use_loop=True, global_ba_every_kf=1)
    sys_t = t_pipe.VinsSystem(TCFG, use_loop=True, global_ba_every_kf=1,
                              device="cpu")
    sys_j.loop, sys_t.loop = lj, lt
    prep = dict(outs=None, imgs=None, ts=None, n_ok=0, is_kf=[], p=None,
                q=None)
    runs = []
    for sys_ in (sys_j, sys_t):
        sys_.insert_block_keyframes(prep)
        sys_.insert_block_keyframes(prep)   # no new rows: no second run
        runs.append(sys_.ba_runs)
    n = lt.count
    return dict(ba_runs=runs, p_origin_t=lt.db.p_origin[:n].numpy(),
                p_origin_j=np.asarray(lj.db.p_origin)[:n],
                mesh_t=sys_t._ba_mesh is None)


def _stage(fn, *args) -> tuple:
    """(True, fn(*args)), or (False, its traceback): a stage of
    build_record whose error fails only the tests that read it."""
    try:
        return True, fn(*args)
    except Exception:
        return False, traceback.format_exc()


def _result(stage):
    ok, value = stage
    if not ok:
        pytest.fail(f"the shared build's stage failed:\n{value}",
                    pytrace=False)
    return value


def build_record() -> dict:
    """Everything the file's tests read, as plain data: run_streams'
    record without the live systems (their state after the stream in
    "after_j" / "after_t"); then, on the JAX run's DB carried into the
    port (_carry_loop), the harvested BA problems and their solves
    ("ba"), LoopCloser.global_ba ("global_ba") and the in-stream global
    BA ("in_stream"), in the file's order, each stage's error kept for
    the tests that read it."""
    from vins_tpu.parallel import dist_ba as j_ba
    from vins_tpu.parallel import harvest as j_harvest
    s = run_streams()
    sys_j, sys_t = s.pop("sys_j"), s.pop("sys_t")
    s.update(after_j=loop_record(sys_j, jax.device_get),
             after_t=loop_record(sys_t, interop.to_numpy),
             loop_stats=dict(sys_t.loop_stats),
             W_REFINED=sys_t.loop.W_REFINED)
    lj, lt = sys_j.loop, sys_t.loop

    def problems():
        _carry_loop(lj, lt)
        res_j = j_harvest.harvest_ba_problem(lj.db, lj.tic, lj.qic)
        res_t = t_harvest.harvest_ba_problem(lt.db, lt.count, lt.tic,
                                             lt.qic)
        return dict(res_j=jax.device_get(res_j), res_t=res_t,
                    solved_j=jax.device_get(j_ba.solve_ba(
                        res_j.state, res_j.prob, iters=8)),
                    solved_t=t_ba.solve_ba(res_t.state, res_t.prob, iters=8))

    ba = _stage(problems)
    return dict(streams=s, ba=ba,
                global_ba=_stage(_global_ba, lj, lt) if ba[0] else ba,
                in_stream=_stage(_in_stream_global_ba, lj, lt)
                if ba[0] else ba)


@pytest.fixture(scope="module")
def record(request):
    """build_record's record, built once per test run
    (torch_watchdog.once_per_run)."""
    return torch_watchdog.once_per_run(request, build_record)


@pytest.fixture(scope="module")
def streams(record):
    return record["streams"]


@pytest.fixture(scope="module")
def ba(record):
    return _result(record["ba"])


def test_harvest_matches_jax(ba):
    """harvest_ba_problem on the same DB: the same keyframe rows, tracks,
    observations and masks exactly; initial points, camera poses and the
    prior to 1e-6 (one float32 pose composition)."""
    rj, rt = ba["res_j"], ba["res_t"]
    np.testing.assert_array_equal(rt.kf_indices, rj.kf_indices)
    np.testing.assert_array_equal(rt.track_ids, rj.track_ids)
    L, K = rj.prob.mask.shape
    assert K >= 3 and L >= 10, (L, K)
    np.testing.assert_array_equal(rt.prob.obs.numpy(), rj.prob.obs)
    np.testing.assert_array_equal(rt.prob.mask.numpy(), rj.prob.mask)
    np.testing.assert_array_equal(rt.prob.pose_free.numpy(),
                                  rj.prob.pose_free)
    for a, b in ((rt.state.pts, rj.state.pts), (rt.state.p, rj.state.p),
                 (rt.state.q, rj.state.q), (rt.prob.prior_p, rj.prob.prior_p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert float(rt.prob.prior_w) == float(rj.prob.prior_w)


def test_solve_ba_matches_jax(ba):
    """solve_ba, 8 LM iterations on the harvested problem: the final cost
    to 1e-4 relative, poses to 1e-4 m / 1e-4, every observation's
    reprojection residual to 1e-4 (normalized units, 0.05 px here), each
    side's cost never rising and falling overall, and the per-iteration
    costs to 5%. The reduced camera system is near singular (frozen
    anchors, two-view tracks with short baselines): the first damped step
    of float32 normal equations summed in another order lowers the cost
    by a few percent more or less, and a landmark's depth along its
    viewing rays moves by millimetres, while the poses and what the BA
    minimizes, the residuals, agree."""
    (sj, cj, hj), (st, ct, ht) = ba["solved_j"], ba["solved_t"]
    ht, hj = ht.numpy(), np.asarray(hj)
    cost0 = float(t_ba._ba_cost(ba["res_t"].state, t_ba._materialize_prior(
        ba["res_t"].state, ba["res_t"].prob)))
    assert np.all(np.diff(ht) <= 0) and np.all(np.diff(hj) <= 0)
    assert ht[-1] < cost0
    np.testing.assert_allclose(ht, hj, rtol=0.05)
    assert float(ct) == pytest.approx(float(cj), rel=1e-4)
    np.testing.assert_allclose(st.p.numpy(), np.asarray(sj.p), atol=1e-4)
    np.testing.assert_allclose(st.q.numpy(), np.asarray(sj.q), atol=1e-4)
    prob = ba["res_t"].prob
    res = [t_ba._residual_lk(
        pts[:, None, :], prob.obs, p[None], q[None].expand(
            prob.mask.shape + (4,))) * prob.mask[..., None]
        for p, q, pts in (
            (st.p, st.q, st.pts),
            tuple(torch.as_tensor(np.asarray(x)) for x in (sj.p, sj.q,
                                                           sj.pts)))]
    np.testing.assert_allclose(res[0].numpy(), res[1].numpy(), atol=1e-4)


def test_global_ba_writes_the_same_columns(record, ba):
    """LoopCloser.global_ba on the same DB, graph and drift: the same
    cost (1e-4 relative), and the same raw and published pose columns and
    pose-graph origin columns (1e-4 m / 1e-4 rad), then the same
    re-published poses after the pose-graph run (1e-3 m / 1e-3 rad: the
    graph's own fp32 LM on top). The harvested problem padded for a
    sharded solve (masked zero rows) has the same cost."""
    g = _result(record["global_ba"])
    assert g["cost_t"] == pytest.approx(g["cost_j"], rel=1e-4)
    for name in ("p_origin", "q_origin"):
        np.testing.assert_allclose(g["db_t"][name], g["db_j"][name],
                                   atol=1e-4, err_msg=name)
    for name in ("t_origin", "yaw_origin"):
        np.testing.assert_allclose(g["graph_t"][name], g["graph_j"][name],
                                   atol=1e-4, err_msg=name)
    for name in ("p", "q"):
        np.testing.assert_allclose(g["db_t"][name], g["db_j"][name],
                                   atol=1e-3, err_msg=name)
    assert g["n_optimizes"][1] == g["n_optimizes"][0]
    res = ba["res_t"]
    padded = t_harvest.pad_landmarks_to(res.state, res.prob, 8)
    assert padded[1].mask.shape[0] % 8 == 0
    cost = lambda st, pr: float(t_ba._ba_cost(st, t_ba._materialize_prior(
        st, pr)))
    assert cost(*padded) == pytest.approx(cost(res.state, res.prob),
                                          rel=1e-6)


class _Stub:
    """Scripted blocks for VinsSystem.process_stream: dispatch and sync
    record what they are given (sync also the budget the previous block
    left), a scripted block fails at a frame (the system re-enters
    INITIAL), publish advances the patched clock by the block's scripted
    wall time, and an interactive frame re-initializes at once."""

    def __init__(self, sys_, clock, walls, fail):
        self.sys, self.clock, self.walls, self.fail = sys_, clock, walls, fail
        self.log, self.k = [], 0
        sys_.initialized = True
        sys_.dispatch_block = self.dispatch
        sys_.sync_block = self.sync
        sys_.insert_block_keyframes = lambda prep: None
        sys_.publish_block = self.publish
        sys_.process_frame = self.frame
        sys_.drain_loop_work = lambda: None

    def dispatch(self, imgs, chunks, ts=None, **_):
        self.log.append(("dispatch", float(ts[0]), len(ts), self.k))
        self.k += 1
        return (self.k - 1, len(ts))

    def sync(self, handle):
        k, n = handle
        fail_at = self.fail.get(k)
        if fail_at is not None:
            self.sys.initialized = False
        self.log.append(("sync", k, self.sys.solver_budget))
        return dict(k=k, n=n, fail_at=fail_at)

    def publish(self, prep):
        self.clock[0] += self.walls[prep["k"]]
        n_out = prep["n"] if prep["fail_at"] is None else prep["fail_at"] + 1
        return [None] * n_out

    def frame(self, img, chunk, t=0.0, **_):
        self.log.append(("frame", float(t)))
        self.sys.initialized = True
        return None


def test_realtime_budget_policy_matches_jax(monkeypatch):
    """Both packages' process_stream(realtime=True, depth=2) under one
    patched time.perf_counter, their blocks scripted alike: the same
    dispatches, syncs, discarded block and reprocessing after a failure,
    and the same solver_budget after every block, which steps down to
    cfg.solver.min_iters under walls above the 0.2 s span, stays for
    walls in between and steps back up under walls below 0.7 of it."""
    from vins_tpu import pipeline as j_pipe

    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    n, block = 100, 6
    ts = np.arange(n) / 30.0
    # Span of a 6-frame block: 5 intervals of 1/30 s, scaled by 6/5, so
    # 0.2 s. Block 9 fails at its third frame: block 10, in flight, is
    # discarded and the stream resumes at frame 57.
    walls = [0.1] + [0.3] * 6 + [0.17] * 2 + [0.1] * 11
    logs = []
    for make in (lambda: j_pipe.VinsSystem(CFG, use_loop=False),
                 lambda: t_pipe.VinsSystem(TCFG, use_loop=False,
                                           device="cpu")):
        clock[0] = 100.0
        sys_ = make()
        stub = _Stub(sys_, clock, walls, fail={9: 2})
        imgs = np.zeros((n, 2, 2), np.float32)
        chunks = (ImuChunk(*[torch.zeros((n, 4))] * 3)
                  if isinstance(sys_, t_pipe.VinsSystem) else
                  jax.tree.map(np.asarray, sys_.pnp.chunks._replace(
                      dt=np.zeros((n, 4)), acc=np.zeros((n, 4, 3)),
                      gyr=np.zeros((n, 4, 3)))))
        if isinstance(sys_, t_pipe.VinsSystem):
            imgs = torch.as_tensor(imgs)
        outs = sys_.process_stream(imgs, chunks, block=block, ts=ts,
                                   realtime=True)
        assert len(outs) == n
        logs.append(stub.log + [("end", sys_.solver_budget)])
    assert logs[1] == logs[0]
    budgets = [e[2] for e in logs[0] if e[0] == "sync"] + [logs[0][-1][1]]
    assert budgets == [8, 8, 7, 6, 5, 4, 3, 3, 3, 3,   # syncs of blocks 0-9
                       3, 3, 4, 5, 6, 7, 8, 8]        # 11-17, then the end
    assert [e[1] for e in logs[0] if e[0] == "frame"] == [57 / 30.0]
    assert [e[1] for e in logs[0] if e[0] == "sync"] == \
        list(range(10)) + list(range(11, 18))


def test_in_stream_global_ba_matches_jax(record):
    """VinsSystem(global_ba_every_kf=1): insert_block_keyframes runs the
    global BA once the DB has grown by that many rows since the last run,
    its cost fetch deferred, in both packages alike: one run each, and the
    same raw pose columns (1e-4 m, as above). The JAX system shards this
    BA over the test harness's eight CPU devices; the port solves it on
    one. (build_record runs both systems, after the global BA above.)"""
    r = _result(record["in_stream"])
    assert r["ba_runs"] == [1, 1]
    np.testing.assert_allclose(r["p_origin_t"], r["p_origin_j"], atol=1e-4)
    assert r["mesh_t"]
