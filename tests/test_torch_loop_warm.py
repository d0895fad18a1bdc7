"""The last public names of vins_tpu.loop.keyframe_db.LoopCloser the port
lacked: rows_of (UIDs to current rows) against the JAX closer after a
resample, and warm (every steady-state loop program run once on dummy
inputs), which must leave the closer as it was: a warmed closer inserts and
detects exactly like one that was not, on the CPU."""
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_loop import (CFG, MW, N_KF, TCFG, _fill_rows,
                             _raycast_world)
from conftest import render_cached
from vins_tpu.config import LoopConfig, VinsConfig
from vins_tpu.loop import keyframe_db as j_kdb
from vins_tpu.ops import corners as j_corners

import vins_tpu_torch.config as tc
from vins_tpu_torch.loop import keyframe_db as t_kdb

torch.set_num_threads(1)

CPU = torch.device("cpu")


def test_rows_of_matches_jax_after_resample():
    """rows_of maps keyframe UIDs to their rows after a resample exactly
    as the JAX closer does, dropping the UIDs of decimated frames."""
    loop = dict(max_keyframes=32, dislocal=4, max_kf_features=8)
    lj = j_kdb.LoopCloser(VinsConfig(loop=LoopConfig(**loop)))
    lt = t_kdb.LoopCloser(tc.VinsConfig(loop=tc.LoopConfig(**loop)),
                          device=CPU)
    _fill_rows(lj, lt, 32, 8)
    uids = list(range(0, 40, 3)) + [31, 5, 99]
    assert lt.rows_of(uids) == [u for u in uids if u < 32]
    lj.resample()
    lt.resample()
    rows = lt.rows_of(uids)
    assert rows == lj.rows_of(uids)
    assert len(rows) < len([u for u in uids if u < 32])   # some dropped
    assert rows == [lt.row_of(u) for u in uids if lt.row_of(u) >= 0]


def _keyframes():
    period = 2 * np.pi / 0.6
    seq, imgs = render_cached(CFG, n_frames=N_KF, seed=5,
                              frame_dt=period / 16, traj_kwargs={},
                              imu_per_frame=None, n_landmarks=50)
    H, W = imgs.shape[1:]
    out = []
    for f in range(N_KF):
        pick = j_corners.select_corners_grid(
            j_corners.shi_tomasi_response(jnp.asarray(imgs[f])),
            jnp.zeros((H, W), bool), MW, 30)
        px = np.asarray(pick.pts[:MW])
        ok = np.asarray(pick.valid[:MW])
        pw, pw_ok = _raycast_world(seq, CFG, px, f)
        out.append(tuple(torch.as_tensor(np.asarray(x)) for x in (
            imgs[f], seq.p[f], seq.q[f], px, ok, pw, pw_ok)))
    return seq, out


def test_warm_closer_inserts_and_detects_like_a_cold_one():
    """Two closers with the same seed, one warmed first, fed the same
    revisit keyframes: identical DB rows, graphs, hits and RANSAC
    generator state (warm draws from self.gen and must restore it)."""
    seq, kfs = _keyframes()
    ext = (torch.as_tensor(np.asarray(seq.ext.tic)),
           torch.as_tensor(np.asarray(seq.ext.qic)))
    cold = t_kdb.LoopCloser(TCFG, ext=ext, device=CPU)
    warm = t_kdb.LoopCloser(TCFG, ext=ext, device=CPU)
    db0 = [x.clone() for x in warm.db]
    warm.warm()
    for a, b in zip(warm.db, db0):
        assert torch.equal(a, b)
    assert torch.equal(warm.gen.get_state(), cold.gen.get_state())
    hits = {"cold": [], "warm": []}
    for kf in kfs:
        for name, lc in (("cold", cold), ("warm", warm)):
            hits[name].append(lc.detect(lc.add_keyframe(*kf)))
    assert sum(h is not None for h in hits["cold"]) >= 1
    for a, b in zip(hits["warm"], hits["cold"]):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.old_idx, a.cur_idx, a.n_inliers, a.edge_abs) == (
                b.old_idx, b.cur_idx, b.n_inliers, b.edge_abs)
            np.testing.assert_array_equal(np.asarray(a.t_rel),
                                          np.asarray(b.t_rel))
    for a, b in zip(warm.db, cold.db):
        assert torch.equal(a, b)
    for a, b in zip(warm.graph, cold.graph):
        assert torch.equal(a, b)
    assert torch.equal(warm.bow, cold.bow)
    assert torch.equal(warm.gen.get_state(), cold.gen.get_state())
