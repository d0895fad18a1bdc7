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
import torch_watchdog
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
from vins_tpu_torch.ops import image as t_image

pytest_plugins = ["torch_watchdog"]

torch.set_num_threads(1)

CFG = VinsConfig(camera=CameraConfig(**rc.CAM),
                 frontend=FrontendConfig(**rc.FE),
                 window=WindowConfig(**rc.WIN), loop=LoopConfig(**rc.LOOP))
TCFG = rc.TCFG
N_FRAMES = rc.N_FRAMES
CARRY_AT = rc.CARRY_AT
# The BRIEF check (check_brief; ROADMAP, "Departures on purpose"): the
# two packages' stored keypoints may lie KP_TOL px apart (measured: at
# most 1.07e-4 px, in the three rows inserted after the carry), and a
# bit whose float64 margin lies within ULP_BOUND float32 ulps of the
# pair's larger tap may take either value (measured on this run's kept
# keypoints by tools/torch_brief_margins.py: the port's float32 margin
# lies at most 4.2 ulp from the float64 one, the reference's 23.3 ulp,
# since its CPU branch rounds each tap's position to float32 on its own
# where the port, as the TPU branch, reads every tap at the fraction of
# one patch corner).
KP_TOL = 1e-3
ULP_BOUND = 32.0


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


def run_revisit(carry_at=CARRY_AT, n_frames=N_FRAMES, record_rows=False):
    """Both systems through process_frame over the scene (ground-truth
    bootstrap, the port's priors carried into the reference, the
    reference's state carried into the port at the init frame and at
    carry_at). Returns dict(seq, imgs, outs_j, outs_t, ev_j, ev_t, sys_j,
    sys_t, carried, rows_j, rows_t); rows_*: (DB row, frame) of each
    side's keyframe inserts (record_inserts), if record_rows."""
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
    rows_j, rows_t = [], []
    if record_rows:
        record_inserts(sys_j.loop, frame, imgs, rows_j)
        record_inserts(sys_t.loop, frame, imgs, rows_t)
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
    return dict(seq=seq, imgs=imgs, outs_j=outs_j, outs_t=outs_t, ev_j=ev_j,
                ev_t=ev_t, sys_j=sys_j, sys_t=sys_t, carried=carried,
                rows_j=rows_j, rows_t=rows_t)


def record_inserts(lc, frame, imgs, rows):
    """Record in rows, insert by insert, (DB row, frame) of every keyframe
    the loop closer lc inserts (frame[0]: the frame being processed),
    holding the image it was given to the scene's raw frame."""
    add = lc.add_keyframe

    def on_add(img, *args, **kwargs):
        np.testing.assert_array_equal(np.asarray(img), imgs[frame[0]])
        idx = add(img, *args, **kwargs)
        rows.append((int(idx), frame[0]))
        return idx

    lc.add_keyframe = on_add


def build_revisit() -> dict:
    """run_revisit's lockstep, recorded as plain data: both packages'
    outputs and loop events, their DBs and pose graphs after the run
    (test_torch_interactive.loop_record), each keyframe row's insert
    frame and that frame, the priors carried into the reference, the
    ground-truth positions, and the port's BRIEF call count and loop
    counters."""
    n_brief = []
    extract = t_brief.extract_brief

    def counted(*args, **kwargs):
        n_brief.append(1)
        return extract(*args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(t_brief, "extract_brief", counted)
    try:
        out = run_revisit(record_rows=True)
    finally:
        mp.undo()
    sys_j, sys_t = out["sys_j"], out["sys_t"]
    frames = sorted({k for _, k in out["rows_j"] + out["rows_t"]})
    return dict(
        outs_j=out["outs_j"], outs_t=out["outs_t"], ev_j=out["ev_j"],
        ev_t=out["ev_t"], carried=out["carried"],
        gt_p=np.asarray(out["seq"].p), n_brief=len(n_brief),
        db_j=ti.loop_record(sys_j, jax.device_get),
        db_t=ti.loop_record(sys_t, interop.to_numpy),
        rows_j=out["rows_j"], rows_t=out["rows_t"],
        frames={k: out["imgs"][k] for k in frames},
        W_REFINED=sys_t.loop.W_REFINED, loop_stats=dict(sys_t.loop_stats))


@pytest.fixture(scope="module")
def revisit(request):
    """build_revisit's record, built once per test run
    (torch_watchdog.once_per_run)."""
    return torch_watchdog.once_per_run(request, build_revisit)


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


def blur64(raw: np.ndarray) -> np.ndarray:
    """The BRIEF blur of raw [H, W] in float64: the 5 taps of
    image.gaussian_taps(2.0) (float32 values, as both packages hold
    them), reflect-101, rows then columns."""
    taps = np.asarray(t_image.gaussian_taps(2.0), np.float64)
    out = np.asarray(raw, np.float64)
    for axis in (0, 1):
        n = out.shape[axis]
        acc = np.zeros_like(out)
        for t, w in enumerate(taps):
            j = np.arange(n) + t - len(taps) // 2
            j = np.where(j < 0, -j, j)
            j = np.where(j >= n, 2 * n - 2 - j, j)
            acc += w * np.take(out, j, axis=axis)
        out = acc
    return out


def _bilinear64(img, x, y):
    """Bilinear samples of img at (x, y), each point clamped inside the
    frame (no inserted keypoint's pair comes near a border: insert keeps
    keypoints PATCH_HALF + 4 px inside it; unused slots hold any value)."""
    H, W = img.shape
    x = np.clip(np.nan_to_num(x), 0.0, W - 1.001)
    y = np.clip(np.nan_to_num(y), 0.0, H - 1.001)
    x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    fx, fy = x - x0, y - y0
    return ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
            + fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))


def margins64(blur: np.ndarray, pts: np.ndarray):
    """([N, 256] float64 margin ib - ia of every pattern pair, where bit
    k is ib > ia, at keypoints pts [N, 2] (pixel x, y) of the float64 blur;
    [N, 256] the float32 ulp of the pair's larger tap)."""
    pat = t_brief.make_pattern().astype(np.float64)
    x = pts[:, 0].astype(np.float64)[:, None]
    y = pts[:, 1].astype(np.float64)[:, None]
    ia = _bilinear64(blur, x + pat[:, 0], y + pat[:, 1])
    ib = _bilinear64(blur, x + pat[:, 2], y + pat[:, 3])
    top = np.maximum(np.abs(ia), np.abs(ib)).astype(np.float32)
    return ib - ia, np.spacing(top).astype(np.float64)


def _bits(desc: np.ndarray) -> np.ndarray:
    """[N, 8] int32 words -> [N, 256] bool (bit 32 w + j is bit j of
    word w)."""
    w = desc.astype(np.int64)[:, :, None] & 0xFFFFFFFF
    return ((w >> np.arange(32)) & 1).reshape(desc.shape[0], -1) > 0


def check_brief(rec) -> list:
    """The revisit's keyframe rows against the reference (ROADMAP,
    "Departures on purpose": BRIEF words at drifted keypoints). Every
    row's insert frame is the same on both sides, and on every row:
    - each keypoint both keep lies within KP_TOL px of the reference's,
      and a keypoint a side does not keep has words 0 there;
    - the port's extract_brief (its CPU path: the blur and K3's plain
      version) on the row's raw frame at the reference's keypoints gives
      the reference's stored words bit for bit, but for a bit whose
      float64 margin is within ULP_BOUND float32 ulps of the pair's
      larger tap (the two blurs' round-off);
    - every bit where the two stored words differ is one whose float64
      margin changes sign between the two packages' positions, or is
      within ULP_BOUND ulps at either.
    Returns the readout of every differing bit (row, frame, keypoint,
    both positions, pattern pair, each side's bit and float64 margin at
    its own position); raises AssertionError with it if a check fails."""
    dj, dt = rec["db_j"], rec["db_t"]
    n = dj["count"]
    faults, lines = [], []
    frame_of = dict(rec["rows_j"])
    if dict(rec["rows_t"]) != frame_of or sorted(frame_of) != list(range(n)):
        faults.append(f"insert frames differ: reference {rec['rows_j']}, "
                      f"port {rec['rows_t']}")
    both = dj["kp_ok"] & dt["kp_ok"]
    dpx = np.abs(dt["kp_px"] - dj["kp_px"]).max(-1)
    for r, kp in zip(*np.nonzero(both & (dpx > KP_TOL))):
        faults.append(f"row {r} keypoint {kp}: port {dt['kp_px'][r, kp]} px, "
                      f"reference {dj['kp_px'][r, kp]} px, {dpx[r, kp]:.3g} "
                      f"px apart (tolerance {KP_TOL})")
    lines.append(f"stored keypoints both keep: {int(both.sum())}, kept by "
                 f"one side only: {int((dj['kp_ok'] != dt['kp_ok']).sum())}, "
                 f"largest position difference {dpx[both].max():.3g} px")
    for side, d in (("port", dt), ("reference", dj)):
        for r, kp in zip(*np.nonzero(~d["kp_ok"] & np.any(d["desc"] != 0,
                                                          -1))):
            faults.append(f"{side}: row {r} keypoint {kp} is not kept but "
                          f"its words are not 0")

    def pair(r, kp, k, where, px, bit, m, ulp):
        return (f"{where}: row {r} (frame {frame_of.get(r)}) keypoint {kp} "
                f"pair {k} (word {k // 32} bit {k % 32}) at "
                f"({px[0]:.5f}, {px[1]:.5f}) px: bit {int(bit)}, float64 "
                f"margin {m:+.3g} ({abs(m) / ulp:.2f} ulp)")

    for r in range(n):
        raw = rec["frames"][frame_of[r]]
        blur = blur64(raw)
        mj, uj = margins64(blur, dj["kp_px"][r])
        mt, ut = margins64(blur, dt["kp_px"][r])
        bj, bt = _bits(dj["desc"][r]), _bits(dt["desc"][r])
        redo = _bits(t_brief.extract_brief(
            torch.as_tensor(raw), torch.as_tensor(dj["kp_px"][r]),
            torch.as_tensor(dj["kp_ok"][r])).numpy())
        for kp, k in zip(*np.nonzero(redo != bj)):
            line = pair(r, kp, k, "port at the reference's keypoint",
                        dj["kp_px"][r, kp], redo[kp, k], mj[kp, k],
                        uj[kp, k]) + f"; reference bit {int(bj[kp, k])}"
            inside = abs(mj[kp, k]) <= ULP_BOUND * uj[kp, k]
            (lines if inside else faults).append(line)
        for kp, k in zip(*np.nonzero((bt != bj) & both[r][:, None])):
            flips = np.sign(mt[kp, k]) != np.sign(mj[kp, k])
            inside = min(abs(mt[kp, k]) / ut[kp, k],
                         abs(mj[kp, k]) / uj[kp, k]) <= ULP_BOUND
            line = (pair(r, kp, k, "stored words differ; port",
                         dt["kp_px"][r, kp], bt[kp, k], mt[kp, k], ut[kp, k])
                    + "; " + pair(r, kp, k, "reference", dj["kp_px"][r, kp],
                                  bj[kp, k], mj[kp, k], uj[kp, k])
                    + ("; the margin changes sign between the positions"
                       if flips else ""))
            (lines if flips or inside else faults).append(line)
    if faults:
        raise AssertionError("\n".join(["BRIEF check failed:", *faults,
                                         "readout:", *lines]))
    return lines


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


@pytest.mark.parametrize("fault", ["port_word_flipped",
                                   "reference_word_flipped",
                                   "port_keypoint_shifted"])
def test_brief_check_catches_a_real_fault(revisit, fault):
    """check_brief on the run's record with one fault planted in the last
    row (inserted after the carry), at the first keypoint both keep and
    its pair of largest float64 margin: a stored bit of the port's words
    flipped (the stored-word check fails: no sign change, far from the
    ulp bound), the reference's (the re-extraction fails), or the port's
    stored keypoint moved by 0.5 px (the position check fails)."""
    rec = dict(revisit, db_j=dict(revisit["db_j"]),
               db_t=dict(revisit["db_t"]))
    dj, dt = rec["db_j"], rec["db_t"]
    r = dj["count"] - 1
    assert dict(rec["rows_j"])[r] > CARRY_AT
    kp = int(np.nonzero(dj["kp_ok"][r] & dt["kp_ok"][r])[0][0])
    blur = blur64(rec["frames"][dict(rec["rows_j"])[r]])
    m, _ = margins64(blur, dj["kp_px"][r, kp:kp + 1])
    k = int(np.argmax(np.abs(m[0])))
    side = dt if fault.startswith("port") else dj
    if fault.endswith("shifted"):
        side["kp_px"] = side["kp_px"].copy()
        side["kp_px"][r, kp, 0] += 0.5
        expect = "px apart"
    else:
        side["desc"] = side["desc"].copy()
        words = side["desc"][r, kp].view(np.uint32)
        words[k // 32] ^= np.uint32(1 << (k % 32))
        expect = ("stored words differ" if fault.startswith("port")
                  else "port at the reference's keypoint")
    with pytest.raises(AssertionError) as err:
        check_brief(rec)
    failed = str(err.value).split("readout:")[0]
    assert expect in failed and f"row {r}" in failed, str(err.value)
