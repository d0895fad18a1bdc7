"""The interactive path with loop closure on: vins_tpu_torch against
vins_tpu, in lockstep through process_frame.

Both systems initialize themselves (test_torch_interactive.py's config
and comparison, the reference's state carried into the port at the init
frame), then insert every keyframe into their loop DBs (BRIEF from the
raw frame, the BoW row, the pose-graph node) and score it; the detection
gate never fires (dislocal exceeds the keyframe count), so no verify
RANSAC runs. Once two keyframes are in, the same drift-free loop hit is
recorded as a pose-graph edge and staged on both sides through
_stage_loop_from_hit (the old keyframe's observations: the current
landmarks projected through its stored pose), and the next frames must
ride it through the window solves, refine its edge, retire it, run the
4-DoF pose graph and publish drift-corrected poses on the same frames.
"""
import numpy as np
import pytest

import test_torch_interactive as ti
import torch_watchdog
from torch_brief_check import (FAULTS, assert_caught, check_brief,
                               record_inserts)
from vins_tpu.config import (CameraConfig, FrontendConfig, LoopConfig,
                             VinsConfig, WindowConfig)

import vins_tpu_torch.config as tc
from vins_tpu_torch.loop import keyframe_db as t_kdb
from vins_tpu_torch.ops import brief as t_brief

pytest_plugins = ["torch_watchdog"]

_LOOP = dict(max_keyframes=32, max_kf_features=128, loop_freq=1,
             dislocal=40)
CFG = VinsConfig(camera=CameraConfig(**ti._CAM),
                 frontend=FrontendConfig(**ti._FE),
                 window=WindowConfig(**ti._WIN), loop=LoopConfig(**_LOOP))
TCFG = tc.VinsConfig(camera=tc.CameraConfig(**ti._CAM),
                     frontend=tc.FrontendConfig(**ti._FE),
                     window=tc.WindowConfig(**ti._WIN),
                     loop=tc.LoopConfig(**_LOOP))
# Init at frame 18; the hit is staged once two keyframes are in and
# retires (TTL or support) before the end.
N_FRAMES = 49


def _drift_free_hit(sys_j, cls):
    """A verified hit on DB row 0 at its stored pose: the current
    landmarks that project into that keyframe, with their projections as
    the old observations (vins_tpu's tests/test_stream_parity.py builds
    its injected loop the same way)."""
    from vins_tpu.core.estimator import landmark_world_points
    from vins_tpu.utils import lie

    est = sys_j.est
    p_old = np.asarray(sys_j.loop.db.p_origin[0])
    q_old = np.asarray(sys_j.loop.db.q_origin[0])
    pts_w = np.asarray(landmark_world_points(est.window, est.feats,
                                             sys_j.ext))
    ok = (np.asarray(est.feats.valid)
          & (np.asarray(est.window.inv_depth) > 1e-3))
    Rwb = np.asarray(lie.quat_to_rotmat(q_old))
    R_ic = np.asarray(lie.quat_to_rotmat(sys_j.ext.qic))
    pc = ((pts_w - p_old) @ Rwb - np.asarray(sys_j.ext.tic)) @ R_ic
    z = pc[:, 2]
    xy = pc[:, :2] / np.maximum(z[:, None], 1e-6)
    ok &= (z > 0.3) & (np.abs(xy) < 0.9).all(1)
    return cls(old_idx=0, cur_idx=sys_j.loop.count - 1,
               n_inliers=int(ok.sum()), t_rel=np.zeros(3, np.float32),
               yaw_rel=0.0, obs_old=xy.astype(np.float32), match_ok=ok,
               p_old=p_old, q_old=q_old,
               tids=np.asarray(est.feats.track_id))


@pytest.fixture(scope="module")
def lockstep(request):
    """build_lockstep's record, built once per test run
    (torch_watchdog.once_per_run)."""
    return torch_watchdog.once_per_run(request, build_lockstep)


def build_lockstep() -> dict:
    """The loop-on lockstep with a drift-free hit staged on both sides
    once both DBs hold two keyframes, recorded as plain data: outputs,
    the staging, the port's BRIEF call count and loop counters, each
    system's DB and pose graph after the run (ti.loop_record), each
    keyframe row's insert frame (torch_brief_check.record_inserts) and
    that frame."""
    import jax
    from vins_tpu.loop.keyframe_db import LoopHit as JHit
    from vins_tpu_torch import interop

    staged = {}
    frame, rows_j, rows_t = [0], [], []
    _, imgs = ti.render_cached(CFG, n_frames=N_FRAMES, seed=ti.SEED,
                               frame_dt=1.0 / 30.0, traj_kwargs=ti.TRAJ,
                               imu_per_frame=2)

    def on_frame(k, sys_j, sys_t):
        frame[0] = k + 1
        if k == 0:   # before any keyframe is inserted (from the init on)
            record_inserts(sys_j.loop, frame, imgs, rows_j)
            record_inserts(sys_t.loop, frame, imgs, rows_t)
        # Stage on both sides once both DBs hold two keyframes.
        if staged or not sys_j.initialized or sys_j.loop.count < 2:
            return
        assert sys_t.loop.count == sys_j.loop.count
        hj = _drift_free_hit(sys_j, JHit)
        ht = _drift_free_hit(sys_j, t_kdb.LoopHit)
        hj = hj._replace(edge_abs=sys_j.loop._add_loop_edge(hj))
        ht = ht._replace(edge_abs=sys_t.loop._add_loop_edge(ht))
        staged.update(j=sys_j._stage_loop_from_hit(hj),
                      t=sys_t._stage_loop_from_hit(ht), frame=k)

    n_brief = []
    extract = t_brief.extract_brief

    def counted(*args, **kwargs):
        n_brief.append(1)
        return extract(*args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(t_brief, "extract_brief", counted)
    try:
        seq, outs_j, outs_t, sys_j, sys_t = ti.run_lockstep(
            CFG, TCFG, N_FRAMES, use_loop=True, on_frame=on_frame)
    finally:
        mp.undo()
    return dict(outs_j=outs_j, outs_t=outs_t, staged=staged,
                n_brief=len(n_brief), rows_j=rows_j, rows_t=rows_t,
                frames={k: imgs[k] for _, k in rows_j + rows_t},
                after_j=ti.loop_record(sys_j, jax.device_get),
                after_t=ti.loop_record(sys_t, interop.to_numpy),
                loop_stats=dict(sys_t.loop_stats),
                W_REFINED=sys_t.loop.W_REFINED)


def _brief_record(s) -> dict:
    """The lockstep's record as torch_brief_check.check_brief reads it."""
    return dict(db_j=s["after_j"], db_t=s["after_t"], rows_j=s["rows_j"],
                rows_t=s["rows_t"], frames=s["frames"])


def test_loop_on_process_frame_matches_jax(lockstep):
    """Per frame, test_torch_interactive.compare_lockstep's checks: the
    same init frame and statuses, then the same keyframe decisions and
    outputs, the drift-corrected published poses included; at least one
    published pose carries a pose-graph correction."""
    s = lockstep
    init_at = ti.compare_lockstep(s["outs_j"], s["outs_t"])
    assert init_at is not None
    assert s["staged"]["j"] and s["staged"]["t"]
    corrected = [k for k, o in enumerate(s["outs_t"])
                 if o.initialized
                 and np.linalg.norm(np.asarray(o.p) - np.asarray(o.p_raw))
                 > 1e-6]
    assert corrected, "no published pose carries a drift correction"


def test_loop_on_db_and_constraint_lifecycle_match_jax(lockstep):
    """The same keyframe inserts (rows, stored poses within 5e-3 m, at
    least 90% of the reference's stored keypoints kept by both, their
    positions and BRIEF words held by torch_brief_check.check_brief, whose
    readout is printed, BoW rows to 1e-5), the staged
    constraint refined and retired on both sides (edge promoted to the
    refined weight, no constraint pending), the same number of pose-graph
    runs, and the edge measurement and drift to 5e-3."""
    s = lockstep
    lj, lt = s["after_j"], s["after_t"]
    assert lt["count"] == lj["count"] >= 2
    assert lt["n_inserts"] == lj["count"]
    np.testing.assert_allclose(lt["p"], lj["p"], atol=5e-3)
    both = lj["kp_ok"] & lt["kp_ok"]
    assert both.sum() >= 0.9 * lj["kp_ok"].sum()
    print("\n".join(check_brief(_brief_record(s))))
    np.testing.assert_allclose(lt["bow"], lj["bow"], atol=1e-5)
    assert not lt["pending"] and not lj["pending"]
    assert lt["loop_w_host"] == lj["loop_w_host"] == [s["W_REFINED"]]
    assert lt["n_optimizes"] == lj["n_optimizes"] >= 1
    st = s["loop_stats"]
    assert st["staged"] == 1 and st["retired"] == 1 and st["good_frames"] >= 1
    for name in ("loop_i", "loop_j", "loop_w"):
        np.testing.assert_array_equal(lt[name], lj[name])
    np.testing.assert_allclose(lt["loop_t"], lj["loop_t"], atol=5e-3)
    np.testing.assert_allclose(lt["loop_yaw"], lj["loop_yaw"], atol=5e-3)
    np.testing.assert_allclose(lt["t_drift"], lj["t_drift"], atol=5e-3)
    np.testing.assert_allclose(lt["r_drift"], lj["r_drift"], atol=5e-3)


def test_brief_runs_once_per_keyframe_insert(lockstep):
    """The interactive path extracts BRIEF once per keyframe insert (K3's
    raw-frame entry, its plain version on the CPU) and nowhere else, and
    inserts every keyframe (loop_freq = 1)."""
    s = lockstep
    lt = s["after_t"]
    assert s["n_brief"] == lt["n_inserts"] == lt["kf_count"] >= 2


@pytest.mark.parametrize("fault", FAULTS)
def test_brief_check_catches_a_real_fault(lockstep, fault):
    """check_brief on this lockstep's record with one fault planted in its
    last keyframe row (torch_brief_check.assert_caught: a large-margin
    bit of the port's stored words flipped, of the reference's, or the
    port's stored keypoint moved 0.5 px): each fails the check, on that
    row."""
    rec = _brief_record(lockstep)
    assert_caught(rec, fault, rec["db_j"]["count"] - 1)
