"""The port's trajectory/AR renderer, its Delaunay mesher and the demo's
output writer against the JAX package, on the CPU. Every input comes
from numpy with a seed and is given once as numpy and once as CPU
tensors; the renderer is host numpy in both packages, so geometry agrees
to 1e-9 and images to 1e-6."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu import viz as j_viz
from vins_tpu.utils import lie as j_lie
from vins_tpu.viz import delaunay as j_del
from vins_tpu.viz import renderer as j_ren

from vins_tpu_torch import default_config
from vins_tpu_torch import run_synthetic
from vins_tpu_torch import viz as t_viz
from vins_tpu_torch.core.estimator import BackendState
from vins_tpu_torch.io import synthetic as t_syn
from vins_tpu_torch.io.replay import Recorder, load_checkpoint
from vins_tpu_torch.pipeline import PipelineOutput
from vins_tpu_torch.viz import delaunay as t_del
from vins_tpu_torch.viz import renderer as t_ren

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = (300.0, 310.0, 80.0, 60.0)          # fx, fy, cx, cy of a 160x120 view


def _as(x, as_tensor):
    return torch.as_tensor(x) if as_tensor else x


def _camera(seed):
    """A camera 4 m above the floor looking down and ahead, with a random
    small tilt."""
    rng = np.random.default_rng(seed)
    R = j_lie.np_quat_to_rotmat(np.asarray(j_lie.np_so3_exp_quat(
        rng.normal(0, 0.05, 3)))).astype(np.float64)
    down = np.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]])
    return down @ R, np.array([0.2, -0.1, 4.0])


def _floor(seed, n=90, n_out=25):
    """Points on the floor z = -0.5 with 1 cm noise, plus outliers above."""
    rng = np.random.default_rng(seed)
    fl = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                   -0.5 + rng.normal(0, 0.01, n)], -1)
    out = np.stack([rng.uniform(-2, 2, n_out), rng.uniform(-2, 2, n_out),
                    rng.uniform(0.0, 1.5, n_out)], -1)
    pts = np.concatenate([fl, out])[rng.permutation(n + n_out)]
    valid = rng.uniform(size=n + n_out) < 0.95
    return pts, valid


@pytest.mark.parametrize("as_tensor", [False, True])
def test_project_points_matches_jax(as_tensor):
    rng = np.random.default_rng(1)
    pts = np.stack([rng.normal(0, 2, 64), rng.normal(0, 2, 64),
                    rng.uniform(-3.0, 8.0, 64)], -1)   # some behind
    R, t = _camera(1)
    uv_j, ok_j = j_viz.project_points(pts, R, t, *CAM)
    uv_t, ok_t = t_viz.project_points(_as(pts, as_tensor), _as(R, as_tensor),
                                      _as(t, as_tensor), *CAM)
    assert ok_j.any() and not ok_j.all()
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_allclose(uv_t, uv_j, atol=1e-9)


def test_segment_colors_match_jax():
    for n in (0, 1, 7):
        a, b = t_viz.segment_colors(n), j_viz.segment_colors(n)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_find_ground_plane_matches_jax(as_tensor):
    """The same RANSAC draws (seed 0) give the same plane, atol 1e-9."""
    pts, valid = _floor(0)
    pj = j_viz.find_ground_plane(pts, valid, seed=0)
    pt = t_viz.find_ground_plane(_as(pts, as_tensor), _as(valid, as_tensor),
                                 seed=0)
    assert pj is not None and pt is not None
    np.testing.assert_allclose(pt[0], pj[0], atol=1e-9)
    np.testing.assert_allclose(pt[1], pj[1], atol=1e-9)
    assert pj[0][2] > 0.99 and abs(pj[1] - 0.5) < 0.02
    assert t_viz.find_ground_plane(_as(pts[:5], as_tensor),
                                   _as(valid[:5], as_tensor)) is None


@pytest.mark.parametrize("as_tensor", [False, True])
def test_delaunay_and_triangulate_ground_match_jax(as_tensor):
    rng = np.random.default_rng(3)
    p2 = rng.uniform(0, 1, (40, 2))
    p2 = np.concatenate([p2, p2[:2]])              # duplicates are kept
    tj = j_del.delaunay(p2)
    assert len(tj) > 40
    assert t_del.delaunay(_as(p2, as_tensor)) == tj
    assert t_del.delaunay(_as(p2[:2], as_tensor)) == []

    pts, _ = _floor(4)
    n, d = np.array([0.0, 0.02, 1.0]), 0.5
    inl_j, tri_j = j_del.triangulate_ground(pts, n, d, 0.05)
    inl_t, tri_t = t_del.triangulate_ground(
        _as(pts, as_tensor), _as(n, as_tensor),
        _as(np.float64(d), as_tensor) if as_tensor else d, 0.05)
    assert len(tri_j) > 20
    assert tri_t == tri_j
    np.testing.assert_allclose(inl_t, inl_j, atol=1e-12)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_draw_ground_mesh_and_ar_overlay_match_jax(as_tensor):
    rng = np.random.default_rng(5)
    gray = rng.uniform(0, 1, (120, 160)).astype(np.float32)
    R, t = _camera(5)
    pts, valid = _floor(5)
    n, d = j_viz.find_ground_plane(pts, valid, seed=0)
    gj = j_ren.draw_ground_mesh(gray, R, t, *CAM, pts, n, d)
    gt = t_ren.draw_ground_mesh(_as(gray, as_tensor), _as(R, as_tensor),
                                _as(t, as_tensor), *CAM, _as(pts, as_tensor),
                                _as(n, as_tensor), d)
    assert gj.shape == (120, 160, 3)
    assert np.abs(gj - np.repeat(gray[:, :, None], 3, 2)).max() > 0.1
    np.testing.assert_allclose(gt, gj, atol=1e-6)

    center = np.array([0.3, 0.2, -0.5])
    for img in (gray, gj):
        aj = j_viz.draw_ar_overlay(img, R, t, *CAM, center, box_size=0.6)
        at = t_viz.draw_ar_overlay(_as(img, as_tensor), _as(R, as_tensor),
                                   _as(t, as_tensor), *CAM,
                                   _as(center, as_tensor), box_size=0.6)
        assert np.abs(aj - (img if img.ndim == 3 else
                            np.repeat(img[:, :, None], 3, 2))).max() > 0.1
        np.testing.assert_allclose(at, aj, atol=1e-6)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_trajectory_renderer_matches_jax(as_tensor):
    """Two renders in a row (the view's center follows the trajectory)
    with segments, the sparse map and loop edges."""
    rng = np.random.default_rng(6)
    s = np.linspace(0, 2 * np.pi, 80)
    traj = np.stack([3 * np.cos(s), 3 * np.sin(s), 0.2 * np.sin(3 * s)], -1)
    seg = (np.arange(80) // 30).astype(np.int32)
    pts = rng.normal(0, 4, (200, 3))
    kfs = traj[::8]
    edges = [(0, 9), (2, 7), (3, 5)]
    rj = j_viz.TrajectoryRenderer(width=200, height=160, focal=150.0)
    rt = t_viz.TrajectoryRenderer(width=200, height=160, focal=150.0)
    e_t = torch.as_tensor(edges) if as_tensor else edges
    for _ in range(2):
        ij = rj.render(traj, segments=seg, points_w=pts, loop_edges=edges,
                       keyframes=kfs)
        it = rt.render(_as(traj, as_tensor), segments=_as(seg, as_tensor),
                       points_w=_as(pts, as_tensor), loop_edges=e_t,
                       keyframes=_as(kfs, as_tensor))
        assert (np.abs(ij - 0.08) > 1e-3).any(axis=-1).sum() > 200
        np.testing.assert_allclose(it, ij, atol=1e-6)
    np.testing.assert_allclose(rt.center, rj.center, atol=1e-12)
    empty = rt.render(_as(traj[:0], as_tensor))
    np.testing.assert_array_equal(empty, rj.render(traj[:0]))


def _jax_demo():
    """examples/run_synthetic.py as a module (its _save_png)."""
    spec = importlib.util.spec_from_file_location(
        "jax_run_synthetic", os.path.join(_REPO, "examples",
                                          "run_synthetic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_write_outputs_matches_the_jax_demo(tmp_path):
    """run_synthetic.write_outputs on recorded outputs (the ground-truth
    poses of the demo's sequence, initialized from frame 3): its PNG
    bytes equal the JAX demo's _save_png of the JAX renderer's images at
    the same poses; the AR pose is the JAX demo's formula (atol 1e-6);
    run.npz and the checkpoint read back."""
    cfg = default_config()
    seq = t_syn.make_synthetic_sequence(
        cfg, n_frames=12, n_landmarks=60, seed=run_synthetic.SEED,
        frame_dt=1.0 / 30.0, traj_kwargs=dict(w=0.35, bob=0.15),
        imu_per_frame=4, device="cpu")
    rng = np.random.default_rng(7)
    imgs = torch.as_tensor(rng.uniform(
        0, 1, (12, cfg.camera.height, cfg.camera.width)).astype(np.float32))
    p, q = seq.p.numpy(), seq.q.numpy()
    outs = [PipelineOutput(t=0.1 * k, p=p[k], q=q[k], p_raw=p[k],
                           is_keyframe=False, initialized=k >= 3,
                           n_tracked=100, solver_cost=0.0, loop_hit=None)
            for k in range(12)]
    est = BackendState.fresh(cfg, "cpu")
    paths = run_synthetic.write_outputs(str(tmp_path), cfg, seq, imgs, outs,
                                        est, init_at=3)

    demo = _jax_demo()
    ref = tmp_path / "ref.png"
    demo._save_png(str(ref), j_viz.TrajectoryRenderer().render(p[3:]))
    traj_png = open(paths["trajectory.png"], "rb").read()
    assert traj_png == ref.read_bytes()
    assert traj_png[12:16] == b"IHDR"

    # The JAX demo's AR pose (examples/run_synthetic.py:79-83).
    qic, tic = seq.ext.qic.numpy(), seq.ext.tic.numpy()
    R_wb = np.asarray(j_lie.quat_to_rotmat(jnp.asarray(q[11])))
    R_wc = R_wb @ np.asarray(j_lie.quat_to_rotmat(jnp.asarray(qic)))
    t_wc = p[11] + R_wb @ tic
    center = p[11] + R_wc @ np.array([0.0, 0.5, 3.0])
    got = run_synthetic.ar_pose(outs[11], seq)
    for a, b in zip(got, (R_wc, t_wc, center)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    cam = cfg.camera
    demo._save_png(str(ref), j_viz.draw_ar_overlay(
        imgs[11].numpy(), got[0], got[1], cam.fx, cam.fy, cam.cx, cam.cy,
        got[2]))
    assert open(paths["ar_overlay.png"], "rb").read() == ref.read_bytes()

    rec = Recorder.load(paths["run.npz"])
    np.testing.assert_array_equal(rec["p"], p)
    np.testing.assert_array_equal(rec["initialized"], np.arange(12) >= 3)
    _assert_same_tree(load_checkpoint(paths["estimator.ckpt"]), est)


def _assert_same_tree(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    else:
        assert a == b
