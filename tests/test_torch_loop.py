"""Loop closure: vins_tpu_torch.loop against vins_tpu.loop.

The vocabulary (shipped asset, transform, scoring, training), the PnP of
the verify step, the 4-DoF pose graph, and a LoopCloser fed the same
rendered revisit keyframes and ground-truth poses on both sides (no VIO),
with the JAX verify-RANSAC key chain replayed into the port. Resample and
edge eviction are held against the JAX closer at a small capacity.
"""
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import render_cached
from vins_tpu.config import CameraConfig, LoopConfig, VinsConfig
from vins_tpu.loop import keyframe_db as j_kdb
from vins_tpu.loop import pose_graph as j_pg
from vins_tpu.loop import vocabulary as j_voc
from vins_tpu.ops import corners as j_corners
from vins_tpu.ops import ransac as j_ransac
from vins_tpu.utils import lie as j_lie

import vins_tpu_torch.config as tc
from vins_tpu_torch.loop import keyframe_db as t_kdb
from vins_tpu_torch.loop import pose_graph as t_pg
from vins_tpu_torch.loop import vocabulary as t_voc
from vins_tpu_torch.ops import ransac as t_ransac

pytest_plugins = ["torch_watchdog"]

torch.set_num_threads(1)

CPU = torch.device("cpu")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(words):
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8))


def _random_words(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)


# ---------------------------------------------------------------------------
# Vocabulary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["brief_k10L4.npz", "brief_k10L3.npz"])
def test_vocabulary_assets_are_byte_identical_copies(name):
    port = os.path.join(_REPO, "vins_tpu_torch", "assets", name)
    ref = os.path.join(_REPO, "vins_tpu", "assets", name)
    assert filecmp.cmp(port, ref, shallow=False)
    assert t_voc.ASSETS_DIR == os.path.dirname(port)


def test_vocabulary_transform_and_scores_match_jax():
    """On the shipped tree: word ids exact, BoW rows and L1 scores within
    1e-6."""
    vj = j_voc.default_vocabulary()
    vt = t_voc.default_vocabulary(CPU)
    assert vt.n_words == vj.n_words == 10 ** 4
    for a, b in zip(vt.levels, vj.levels):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b))
    rng = np.random.default_rng(0)
    rows_j, rows_t = [], []
    for k in range(6):
        d = _random_words(rng, 120)
        ok = rng.uniform(size=120) > 0.2
        wj, bj = j_voc.transform(vj, jnp.asarray(d), jnp.asarray(ok))
        wt, bt = t_voc.transform(vt, torch.as_tensor(d.view(np.int32)),
                                 torch.as_tensor(ok))
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-6,
                                   rtol=0)
        rows_j.append(np.asarray(bj))
        rows_t.append(bt)
    db_j = jnp.asarray(np.stack(rows_j + [np.zeros_like(rows_j[0])]))
    db_t = torch.stack(rows_t + [torch.zeros_like(rows_t[0])])
    for q in range(3):
        sj = np.asarray(j_voc.score_database(db_j, db_j[q]))
        st = t_voc.score_database(db_t, db_t[q]).numpy()
        np.testing.assert_allclose(st, sj, atol=1e-6, rtol=0)
        assert st[-1] == 0.0


def test_train_vocabulary_matches_jax(tmp_path):
    """The port's numpy training copy builds the same tree and idf as the
    JAX package's, and save/load round-trips it bit for bit."""
    rng = np.random.default_rng(1)
    d = _random_words(rng, 300)
    img_ids = rng.integers(0, 12, 300)
    vj = j_voc.train_vocabulary(d, k=4, levels=2, iters=4,
                                image_ids=img_ids)
    vt = t_voc.train_vocabulary(d, k=4, levels=2, iters=4,
                                image_ids=img_ids, device=CPU)
    for a, b in zip(vt.levels, vj.levels):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b))
    np.testing.assert_array_equal(vt.weights.numpy(), np.asarray(vj.weights))
    path = str(tmp_path / "v.npz")
    t_voc.save_vocabulary(path, vt)
    back = j_voc.load_vocabulary(path)
    for a, b in zip(vt.levels, back.levels):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b))


# ---------------------------------------------------------------------------
# Verify PnP and the pose graph
# ---------------------------------------------------------------------------


def test_pnp_gn_matches_jax():
    rng = np.random.default_rng(2)
    N = 40
    X = np.stack([rng.uniform(-2, 2, N), rng.uniform(-2, 2, N),
                  rng.uniform(4, 8, N)], -1).astype(np.float32)
    q = np.asarray(j_lie.so3_exp_quat(jnp.asarray([0.05, -0.1, 0.2],
                                                  jnp.float32)))
    p = np.array([0.1, -0.2, 0.3], np.float32)
    pc = (X - p) @ np.asarray(j_lie.quat_to_rotmat(q))
    obs = (pc[:, :2] / pc[:, 2:]).astype(np.float32) + rng.normal(
        size=(N, 2)).astype(np.float32) * 1e-3
    valid = rng.uniform(size=N) > 0.2
    p0 = p + np.array([0.05, 0.03, -0.04], np.float32)
    q0 = np.asarray(j_lie.quat_mul(q, j_lie.so3_exp_quat(
        jnp.asarray([0.02, 0.01, -0.03], jnp.float32))))
    ref = j_ransac.pnp_gn(jnp.asarray(X), jnp.asarray(obs),
                          jnp.asarray(valid), jnp.asarray(p0),
                          jnp.asarray(q0), iters=10)
    got = t_ransac.pnp_gn(torch.as_tensor(X), torch.as_tensor(obs),
                          torch.as_tensor(valid), torch.as_tensor(p0),
                          torch.as_tensor(q0), iters=10)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)


def _drifted_graph(mod, K=64, E=8, n=40):
    """A circle of n keyframes whose odometry drifts in yaw and position,
    one full-weight loop edge (last -> first) and one tentative edge."""
    rng = np.random.default_rng(3)
    ang = np.linspace(0, 2 * np.pi, n)
    t_gt = np.stack([3 * np.cos(ang), 3 * np.sin(ang),
                     0.1 * np.sin(np.linspace(0, 6, n))], -1)
    yaw_gt = ang.astype(np.float32)
    yaw_d = (yaw_gt + 0.15 * np.linspace(0, 1, n)).astype(np.float32)
    t_d = t_gt.copy()
    for k in range(1, n):
        dy = yaw_d[k - 1] - yaw_gt[k - 1]
        Rz = np.array([[np.cos(dy), -np.sin(dy), 0],
                       [np.sin(dy), np.cos(dy), 0], [0, 0, 1]])
        t_d[k] = (t_d[k - 1] + Rz @ (t_gt[k] - t_gt[k - 1])
                  + rng.normal(size=3) * 0.01)
    t_d = t_d.astype(np.float32)
    pitch = (rng.normal(size=n) * 0.05).astype(np.float32)
    roll = (rng.normal(size=n) * 0.05).astype(np.float32)
    R0 = np.array([[np.cos(yaw_gt[0]), -np.sin(yaw_gt[0]), 0],
                   [np.sin(yaw_gt[0]), np.cos(yaw_gt[0]), 0], [0, 0, 1]])
    lt = np.zeros((E, 3), np.float32)
    lt[0] = R0.T @ (t_gt[n - 1] - t_gt[0])
    lt[1] = R0.T @ (t_gt[20] - t_gt[0])
    ly = np.zeros(E, np.float32)
    ly[0], ly[1] = yaw_gt[n - 1] - yaw_gt[0], yaw_gt[20] - yaw_gt[0]
    lj = np.zeros(E, np.int32)
    lj[:2] = [n - 1, 20]
    lw = np.zeros(E, np.float32)
    lw[:2] = [1.0, 0.02]

    def pad(a, fill=0):
        return np.concatenate([a, np.full((K - n,) + a.shape[1:], fill,
                                          a.dtype)])

    A = jnp.asarray if mod is j_pg else torch.as_tensor
    g = mod.PoseGraph.empty(K, E)
    return g._replace(
        t=A(pad(t_d)), yaw=A(pad(yaw_d)), pitch=A(pad(pitch)),
        roll=A(pad(roll)), node_ok=A(pad(np.ones(n, bool), False)),
        t_origin=A(pad(t_d)), yaw_origin=A(pad(yaw_d)),
        loop_i=A(np.zeros(E, np.int32)), loop_j=A(lj), loop_t=A(lt),
        loop_yaw=A(ly), loop_w=A(lw))


def test_pose_graph_and_drift_match_jax():
    """optimize_pose_graph (closed-form per-edge Jacobian blocks in the
    port, jax.jacfwd in the reference) and drift_from_solution on a
    drifted graph: t within 1e-4 m, yaw within 1e-5 rad."""
    gj, gt = _drifted_graph(j_pg), _drifted_graph(t_pg)
    aj, cj = j_pg.optimize_pose_graph(gj, jnp.asarray(0), iters=12)
    at, ct = t_pg.optimize_pose_graph(gt, 0, iters=12)
    np.testing.assert_allclose(at.t.numpy(), np.asarray(aj.t), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(at.yaw.numpy(), np.asarray(aj.yaw), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)
    Rj, tj = j_pg.drift_from_solution(aj, jnp.asarray(39))
    Rt, tt = t_pg.drift_from_solution(at, 39)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    sj = j_pg.sequential_measurements(gj, 5)
    st = t_pg.sequential_measurements(gt, 5)
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


# ---------------------------------------------------------------------------
# LoopCloser on a rendered revisit
# ---------------------------------------------------------------------------

_S = 0.4   # the 480x640 default camera scaled to 192x256
_CAM = dict(width=192, height=256, fx=526.600 * _S, fy=526.678 * _S,
            cx=243.481 * _S, cy=315.280 * _S)
_LOOP = dict(max_keyframes=32, dislocal=6, min_loop_matches=15,
             max_kf_features=160, similarity_alpha=0.5, temporal_k=1)
CFG = VinsConfig(camera=CameraConfig(**_CAM), loop=LoopConfig(**_LOOP))
TCFG = tc.VinsConfig(camera=tc.CameraConfig(**_CAM),
                     loop=tc.LoopConfig(**_LOOP))
N_KF = 20          # one lap in 16 keyframes, then 4 revisits
MW = 32


def _raycast_world(seq, cfg, pts_px, f, wall_radius=8.0, floor_z=-2.0,
                   ceil_z=2.0):
    """World points hit by pixel rays of frame f (renderer geometry)."""
    c = cfg.camera
    R_ic = np.asarray(j_lie.quat_to_rotmat(seq.ext.qic))
    Rwb = np.asarray(j_lie.quat_to_rotmat(seq.q[f]))
    o = np.asarray(seq.p[f]) + Rwb @ np.asarray(seq.ext.tic)
    d_c = np.stack([(pts_px[:, 0] - c.cx) / c.fx, (pts_px[:, 1] - c.cy) / c.fy,
                    np.ones(len(pts_px), np.float32)], -1)
    d = d_c @ (Rwb @ R_ic).T
    a = d[:, 0] ** 2 + d[:, 1] ** 2
    b = 2 * (o[0] * d[:, 0] + o[1] * d[:, 1])
    cc = o[0] ** 2 + o[1] ** 2 - wall_radius ** 2
    t_cyl = (-b + np.sqrt(np.maximum(b * b - 4 * a * cc, 0))) / np.maximum(
        2 * a, 1e-9)
    dz = d[:, 2]
    t_flo = np.where(dz < -1e-6, (floor_z - o[2]) / np.where(
        np.abs(dz) < 1e-6, -1e-6, dz), np.inf)
    t_cei = np.where(dz > 1e-6, (ceil_z - o[2]) / np.where(
        np.abs(dz) < 1e-6, 1e-6, dz), np.inf)
    t_hit = np.minimum(np.minimum(t_cyl, t_flo), t_cei)
    return (o + d * t_hit[:, None]).astype(np.float32), np.isfinite(t_hit)


def jax_verify_noise(seed, hyps, Nf):
    """The port's ransac_noise(C): the Gumbel draws of the JAX closer's
    verify RANSAC. Each dispatch pads C candidates to a multiple of 4,
    splits the carried key into C + 1, keeps the first as the next key,
    and draws gumbel(k, (Nf,)) per hypothesis key of each candidate
    (keyframe_db.py:933-938, ops/ransac.py:102-107)."""
    state = {"key": jax.random.PRNGKey(seed)}
    draw = jax.jit(jax.vmap(lambda k: jax.vmap(
        lambda kk: jax.random.gumbel(kk, (Nf,)))(jax.random.split(k, hyps))))

    def noise(n):
        C = 4 * (-(-n // 4))
        keys = jax.random.split(state["key"], C + 1)
        state["key"] = keys[0]
        return torch.as_tensor(np.asarray(draw(keys[1:n + 1])))

    return noise


def _record_gates(lc):
    gates = []
    orig = lc._gate

    def gate(*args):
        best = orig(*args)
        gates.append(best)
        return best

    lc._gate = gate
    return gates


@pytest.fixture(scope="module")
def revisit():
    period = 2 * np.pi / 0.6
    seq, imgs = render_cached(CFG, n_frames=N_KF, seed=5,
                              frame_dt=period / 16, traj_kwargs={},
                              imu_per_frame=None, n_landmarks=50)
    H, W = imgs.shape[1:]
    tic, qic = np.asarray(seq.ext.tic), np.asarray(seq.ext.qic)
    lj = j_kdb.LoopCloser(CFG, ext=(seq.ext.tic, seq.ext.qic))
    lt = t_kdb.LoopCloser(
        TCFG, ext=(torch.as_tensor(tic), torch.as_tensor(qic)), device=CPU,
        ransac_noise=jax_verify_noise(0, CFG.loop.geo_ransac_hyps,
                                      CFG.loop.max_kf_features))
    gates_j, gates_t = _record_gates(lj), _record_gates(lt)
    out = dict(seq=seq, lj=lj, lt=lt, gates_j=gates_j, gates_t=gates_t,
               hits_j=[], hits_t=[], scores_j=[], scores_t=[])
    for f in range(N_KF):
        pick = j_corners.select_corners_grid(
            j_corners.shi_tomasi_response(jnp.asarray(imgs[f])),
            jnp.zeros((H, W), bool), MW, 30)
        px = np.asarray(pick.pts[:MW])
        ok = np.asarray(pick.valid[:MW])
        pw, pw_ok = _raycast_world(seq, CFG, px, f)
        p, q = np.asarray(seq.p[f]), np.asarray(seq.q[f])
        ij = lj.add_keyframe(jnp.asarray(imgs[f]), jnp.asarray(p),
                             jnp.asarray(q), jnp.asarray(px),
                             jnp.asarray(ok), jnp.asarray(pw),
                             jnp.asarray(pw_ok))
        it = lt.add_keyframe(torch.as_tensor(imgs[f]), torch.as_tensor(p),
                             torch.as_tensor(q), torch.as_tensor(px),
                             torch.as_tensor(ok), torch.as_tensor(pw),
                             torch.as_tensor(pw_ok))
        assert ij == it == f
        sj, _ = lj._place_scores_many([ij])
        st, _ = lt.dispatch_scores([it])
        out["scores_j"].append(np.asarray(sj)[0])
        out["scores_t"].append(st.numpy()[0])
        out["hits_j"].append(lj.detect(ij))
        out["hits_t"].append(lt.detect(it))
    return out


def test_loop_closer_descriptors_and_words_match_jax(revisit):
    """Keyframe rows: descriptor bits within the raw-frame tolerance of
    test_torch_brief.py (0.1%; the two blurs round differently), word ids
    on >= 99% of keypoints, BoW scores within 1e-4; keypoints, masks,
    world points and poses as the JAX closer stores them."""
    lj, lt = revisit["lj"], revisit["lt"]
    n = lt.count
    assert n == int(lj.db.count) == N_KF
    ok_j = np.asarray(lj.db.kp_ok[:n])
    np.testing.assert_array_equal(lt.db.kp_ok[:n].numpy(), ok_j)
    dj = np.asarray(lj.db.desc[:n])
    dt = lt.db.desc[:n].numpy().view(np.uint32)
    n_diff = int(np.sum(_bits(dt[ok_j]) != _bits(dj[ok_j])))
    assert n_diff <= 1e-3 * ok_j.sum() * 256, n_diff
    for name in ("kp_px", "kp_norm", "pts_w", "p", "q", "p_origin",
                 "q_origin", "gdesc"):
        np.testing.assert_allclose(getattr(lt.db, name)[:n].numpy(),
                                   np.asarray(getattr(lj.db, name)[:n]),
                                   atol=1e-5, err_msg=name)
    for name in ("pts_ok", "segment", "tid"):
        np.testing.assert_array_equal(getattr(lt.db, name)[:n].numpy(),
                                      np.asarray(getattr(lj.db, name)[:n]))
    same = wj_all = 0
    for k in range(n):
        wj, _ = j_voc.transform(lj.vocab, lj.db.desc[k], lj.db.kp_ok[k])
        wt, _ = t_voc.transform(lt.vocab, lt.db.desc[k], lt.db.kp_ok[k])
        m = ok_j[k]
        same += int(np.sum(wt.numpy()[m] == np.asarray(wj)[m]))
        wj_all += int(m.sum())
    assert same >= 0.99 * wj_all, (same, wj_all)
    np.testing.assert_allclose(np.stack(revisit["scores_t"]),
                               np.stack(revisit["scores_j"]), atol=1e-4)


def test_loop_closer_gates_hits_and_edges_match_jax(revisit):
    """Gate decisions, verified hits and the edge table are identical;
    the verify rows agree within the PnP tolerance (1e-4)."""
    assert revisit["gates_t"] == revisit["gates_j"]
    hj, ht = revisit["hits_j"], revisit["hits_t"]
    assert [h is None for h in ht] == [h is None for h in hj]
    assert sum(h is not None for h in hj) >= 1
    for a, b in zip(ht, hj):
        if b is None:
            continue
        assert (a.old_idx, a.cur_idx, a.n_inliers, a.edge_abs) == (
            b.old_idx, b.cur_idx, b.n_inliers, b.edge_abs)
        np.testing.assert_allclose(a.t_rel, np.asarray(b.t_rel), atol=1e-4)
        assert abs(a.yaw_rel - float(b.yaw_rel)) < 1e-4
        for name in ("p_old", "q_old", "p_cur", "q_cur", "pts_w",
                     "obs_old"):
            np.testing.assert_allclose(
                np.asarray(getattr(a, name)),
                np.asarray(getattr(b, name)), atol=1e-4, err_msg=name)
        np.testing.assert_array_equal(np.asarray(a.match_ok),
                                      np.asarray(b.match_ok))
    lj, lt = revisit["lj"], revisit["lt"]
    assert lt.n_loops == lj.n_loops
    assert lt._loop_i_host == lj._loop_i_host
    assert lt._loop_w_host == lj._loop_w_host
    assert lt._edge_abs_host == lj._edge_abs_host
    for name in ("loop_i", "loop_j", "loop_w"):
        np.testing.assert_array_equal(getattr(lt.graph, name).numpy(),
                                      np.asarray(getattr(lj.graph, name)))
    np.testing.assert_allclose(lt.graph.loop_t.numpy(),
                               np.asarray(lj.graph.loop_t), atol=1e-4)


def test_loop_closer_slim_verify_rows_match_jax(revisit):
    """The streaming path's slim verify rows ([C, 21]: inliers, yaw, good,
    msr, t_rel, old and current poses) for the verified pairs, with the
    next keys of the replayed chain on both sides, within 1e-4."""
    lj, lt = revisit["lj"], revisit["lt"]
    pairs = [(h.cur_idx, h.old_idx) for h in revisit["hits_j"]
             if h is not None]
    rows_j = np.asarray(lj._dispatch_verify_batch(pairs, slim=True))
    rows_t = lt._dispatch_verify_batch(pairs, slim=True).numpy()
    assert rows_t.shape == (len(pairs), 21)
    # Inlier count and the good flag exactly.
    np.testing.assert_array_equal(rows_t[:, [0, 2]],
                                  rows_j[:len(pairs), [0, 2]])
    np.testing.assert_allclose(rows_t, rows_j[:len(pairs)], atol=1e-4)


def test_loop_closer_pose_graph_matches_jax(revisit):
    """Refining the first edge and optimizing: the pose graph, the DB's
    written-back poses and the drift agree (t 1e-4 m, yaw 1e-5 rad)."""
    lj, lt = revisit["lj"], revisit["lt"]
    t_ref = np.array([0.05, -0.02, 0.01], np.float32)
    lj.update_loop_edge(0, t_ref, 0.01)
    lt.update_loop_edge(0, t_ref, 0.01)
    Rj, tj = lj.optimize()
    Rt, tt = lt.optimize()
    assert lt.n_optimizes == lj.n_optimizes == 1
    np.testing.assert_allclose(lt.graph.t.numpy(), np.asarray(lj.graph.t),
                               atol=1e-4)
    np.testing.assert_allclose(lt.graph.yaw.numpy(),
                               np.asarray(lj.graph.yaw), atol=1e-5)
    np.testing.assert_allclose(lt.db.q.numpy(), np.asarray(lj.db.q),
                               atol=1e-5)
    np.testing.assert_allclose(Rt, np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt, np.asarray(tj), atol=1e-4)
    kt_j, kp_j, kq_j = lj.trajectory()
    kt_t, kp_t, kq_t = lt.trajectory()
    np.testing.assert_allclose(kp_t, kp_j, atol=1e-4)


# ---------------------------------------------------------------------------
# Capacity: resample and edge eviction
# ---------------------------------------------------------------------------


def _fill_rows(lj, lt, K, Nf):
    """Fill both DBs to capacity with a dense line of keyframes (no image
    work), each row's pose and global descriptor the same on both sides."""
    rng = np.random.default_rng(4)
    for i in range(K):
        p = np.array([i * 0.05, 0.01 * np.sin(i), 0.0], np.float32)
        gd = rng.normal(size=1024).astype(np.float32)
        lj.db = j_kdb._add_row(
            lj.db, jnp.asarray(i), jnp.asarray(p), j_lie.quat_identity(),
            jnp.asarray(gd), jnp.zeros((Nf, 8), jnp.uint32),
            jnp.zeros((Nf, 2)), jnp.zeros((Nf, 2)), jnp.zeros((Nf, 3)),
            jnp.zeros((Nf,), bool), jnp.zeros((Nf,), bool),
            jnp.asarray(0, jnp.int32), jnp.full((Nf,), -1, jnp.int32))
        lj.graph = lj.graph._replace(t=lj.graph.t.at[i].set(p),
                                     node_ok=lj.graph.node_ok.at[i].set(True))
        lt.db.p[i] = torch.as_tensor(p)
        lt.db.p_origin[i] = torch.as_tensor(p)
        lt.db.gdesc[i] = torch.as_tensor(gd)
        lt.graph.t[i] = torch.as_tensor(p)
        lt.graph.node_ok[i] = True
        for lc in (lj, lt):
            lc._kf_p_np[i] = p
            lc._uid_np[i] = i
            lc._kf_t_np[i] = 0.1 * i
    lt.count = K
    lt._next_uid = lj._next_uid = K


def test_resample_matches_jax():
    """A full DB decimates the same rows on both sides, protecting the
    loop-edge endpoints and the recent window, and remaps the edges, the
    host mirrors and the temporal-consistency match."""
    loop = dict(max_keyframes=32, dislocal=4, max_kf_features=8)
    lj = j_kdb.LoopCloser(VinsConfig(loop=LoopConfig(**loop)))
    lt = t_kdb.LoopCloser(tc.VinsConfig(loop=tc.LoopConfig(**loop)),
                          device=CPU)
    K, Nf = 32, 8
    _fill_rows(lj, lt, K, Nf)
    hj =j_kdb.LoopHit(old_idx=3, cur_idx=20, n_inliers=30,
                       t_rel=np.zeros(3, np.float32), yaw_rel=0.0)
    ht = t_kdb.LoopHit(old_idx=3, cur_idx=20, n_inliers=30,
                       t_rel=np.zeros(3, np.float32), yaw_rel=0.0)
    lj._add_loop_edge(hj)
    lt._add_loop_edge(ht)
    lj.last_match = lt.last_match = 25
    lj.resample()
    lt.resample()
    m = int(lj.db.count)
    assert lt.count == lj.count == m < K
    for name in ("p", "gdesc"):
        np.testing.assert_array_equal(getattr(lt.db, name).numpy(),
                                      np.asarray(getattr(lj.db, name)))
    for name in ("loop_i", "loop_j", "node_ok"):
        np.testing.assert_array_equal(getattr(lt.graph, name).numpy(),
                                      np.asarray(getattr(lj.graph, name)))
    np.testing.assert_array_equal(lt.graph.t.numpy(), np.asarray(lj.graph.t))
    np.testing.assert_array_equal(lt._uid_np, lj._uid_np)
    np.testing.assert_array_equal(lt._kf_p_np, lj._kf_p_np)
    assert lt._loop_i_host == lj._loop_i_host
    assert lt.last_match == lj.last_match
    assert lt.generation == lj.generation == 1
    assert lt.row_of(20) == lj.row_of(20) >= 0


def test_edge_eviction_matches_jax():
    """Past the 64-edge table the lowest-weight, oldest edge goes; the
    table, its host mirrors and the absolute edge ids match the JAX
    closer's, and a refined edge survives the tentative ones."""
    lj = j_kdb.LoopCloser(VinsConfig())
    lt = t_kdb.LoopCloser(tc.VinsConfig(), device=CPU)
    E = lt.graph.loop_w.shape[0]
    for e in range(E + 6):
        kw = dict(old_idx=e, cur_idx=e + 100, n_inliers=30,
                  t_rel=np.array([0.1 * e, 0, 0], np.float32),
                  yaw_rel=0.01 * e)
        lj._add_loop_edge(j_kdb.LoopHit(**kw))
        lt._add_loop_edge(t_kdb.LoopHit(**kw))
        if e == 2:
            for lc in (lj, lt):
                lc.update_loop_edge(2, np.array([1, 2, 3], np.float32), 0.5)
    assert lt.n_loops == lj.n_loops == E
    assert lt.n_edges_evicted == lj.n_edges_evicted == 6
    assert lt._loop_i_host == lj._loop_i_host
    assert lt._loop_w_host == lj._loop_w_host
    assert lt._edge_abs_host == lj._edge_abs_host
    assert lt.edge_index(2) == lj.edge_index(2) >= 0
    assert lt.edge_index(0) == lj.edge_index(0) == -1
    for name in ("loop_i", "loop_j", "loop_t", "loop_yaw", "loop_w"):
        np.testing.assert_allclose(getattr(lt.graph, name).numpy(),
                                   np.asarray(getattr(lj.graph, name)),
                                   atol=1e-7, err_msg=name)
