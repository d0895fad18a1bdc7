"""vins_tpu_torch's import rule, config and front-end layers against the
JAX package, on the CPU: image prep, Lie and camera utilities, corners,
F-RANSAC with injected noise, the tracker steps, and the state interop.
Inputs come from numpy with a seed or from the in-repo renderer."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import render_cached
from vins_tpu import config as j_config
from vins_tpu.ops import corners as j_corners
from vins_tpu.ops import image as j_img
from vins_tpu.ops import ransac as j_ransac
from vins_tpu.utils import camera as j_cam
from vins_tpu.utils import lie as j_lie

import vins_tpu_torch
from vins_tpu_torch import config as t_config
from vins_tpu_torch import interop
from vins_tpu_torch.ops import corners as t_corners
from vins_tpu_torch.ops import image as t_img
from vins_tpu_torch.ops import ransac as t_ransac
from vins_tpu_torch.utils import camera as t_cam
from vins_tpu_torch.utils import lie as t_lie

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x, dtype=None):
    out = torch.as_tensor(np.array(x))
    return out if dtype is None else out.to(dtype)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing the port (its main-path, loop-closure, dataset IO,
    global BA, EuRoC and demo entry modules, the renderer and the native
    IO wrappers) imports no jax, no vins_tpu module and no triton, builds
    no kernel and no host library,
    and loading the shipped vocabulary opens no file of the JAX
    package."""
    code = (
        "import os, sys\n"
        "opened = []\n"
        "sys.addaudithook(lambda ev, args: opened.append(str(args[0])) "
        "if ev == 'open' else None)\n"
        "import vins_tpu_torch, vins_tpu_torch.pipeline, "
        "vins_tpu_torch.stream, vins_tpu_torch.ops.klt\n"
        "import vins_tpu_torch.loop, vins_tpu_torch.loop.keyframe_db, "
        "vins_tpu_torch.loop.pose_graph, vins_tpu_torch.loop.vocabulary\n"
        "from vins_tpu_torch.ops import brief, brief_cuda, native\n"
        "import vins_tpu_torch.io.euroc, vins_tpu_torch.io.asl_fixture, "
        "vins_tpu_torch.io.imu_sync, vins_tpu_torch.io.stream_sync, "
        "vins_tpu_torch.io.replay, vins_tpu_torch.io.evaluate, "
        "vins_tpu_torch.parallel.dist_ba, vins_tpu_torch.parallel.harvest, "
        "vins_tpu_torch.run_euroc, vins_tpu_torch.run_synthetic, "
        "vins_tpu_torch.viz\n"
        "from vins_tpu_torch.io import native_loader, native_runtime\n"
        "assert vins_tpu_torch.loop.default_vocabulary('cpu') is not None\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'vins_tpu', 'triton'))\n"
        "assert not bad, bad\n"
        "assert native._lib is None and not native.build_info\n"
        "assert native_loader._lib is None and native_runtime._lib is None\n"
        "ref = os.sep + 'vins_tpu' + os.sep\n"
        "assert not [p for p in opened if ref in p], opened\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "clean"


def test_port_disables_tf32():
    """The package keeps float32 matmuls and convolutions at full
    precision, as vins_tpu/__init__.py forces "highest"."""
    assert vins_tpu_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("name", ["default_config", "euroc_config"])
def test_config_matches_jax(name):
    """The port's config is a copy of vins_tpu/config.py: every field and
    derived value equal, so the two cannot drift."""
    j_cfg = getattr(j_config, name)()
    t_cfg = getattr(t_config, name)()
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert t_cfg.freq == j_cfg.freq
    assert t_cfg.window.num_frames == j_cfg.window.num_frames
    assert t_cfg.camera.focal == j_cfg.camera.focal
    np.testing.assert_array_equal(t_cfg.camera.ric_matrix(),
                                  j_cfg.camera.ric_matrix())


@pytest.mark.parametrize("shape", [(256, 192), (128, 96), (96, 120)])
def test_image_prep_matches_jax(shape):
    """CLAHE, pyramid, Scharr gradients, blur and bilinear sampling.
    CLAHE is exact: its blend uses the bf16-rounded LUT values the JAX
    one-hot contraction returns. The filters sum the same float32 taps in
    another order: 1e-6 on [0, 1] images."""
    rng = np.random.default_rng(shape[0] + shape[1])
    H, W = shape
    img = np.asarray(j_img.gaussian_blur(
        jnp.asarray(rng.uniform(0, 1, (H, W)).astype(np.float32)), 1.5))
    ti = _t(img)
    np.testing.assert_array_equal(t_img.clahe(ti, 3.0, 8, 256).numpy(),
                                  np.asarray(j_img.clahe(jnp.asarray(img),
                                                         3.0, 8, 256)))
    pj = j_img.build_pyramid(jnp.asarray(img), 3)
    pt = t_img.build_pyramid(ti, 3)
    for a, b in zip(pt, pj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for a, b in zip(t_img.sobel_gradients(ti),
                    j_img.sobel_gradients(jnp.asarray(img))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(
        t_img.gaussian_blur(ti, 2.0).numpy(),
        np.asarray(j_img.gaussian_blur(jnp.asarray(img), 2.0)), atol=1e-6)
    xy = rng.uniform(-3, max(H, W) + 3, (50, 2)).astype(np.float32)
    np.testing.assert_allclose(
        t_img.bilinear_sample(ti, _t(xy)).numpy(),
        np.asarray(j_img.bilinear_sample(jnp.asarray(img), jnp.asarray(xy))),
        atol=1e-6)


def test_clahe_batched_equals_per_frame():
    """precompute_block equalizes a whole block in one call: the batched
    CLAHE equals the JAX one frame by frame."""
    rng = np.random.default_rng(3)
    imgs = rng.uniform(0, 1, (3, 128, 96)).astype(np.float32)
    ref = np.stack([np.asarray(j_img.clahe(jnp.asarray(i))) for i in imgs])
    np.testing.assert_array_equal(t_img.clahe(_t(imgs)).numpy(), ref)


def test_lie_utilities_match_jax():
    """Quaternion, SO(3) and yaw-pitch-roll helpers the slice calls
    (float32 round-off: 1e-6, 1e-5 through the arccos/atan2 of a log)."""
    rng = np.random.default_rng(4)
    th = rng.normal(size=(16, 3)).astype(np.float32) * 0.8
    qa = np.asarray(j_lie.so3_exp_quat(jnp.asarray(th)))
    qb = np.asarray(j_lie.so3_exp_quat(jnp.asarray(th[::-1].copy())))
    v = rng.normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_allclose(t_lie.so3_exp_quat(_t(th)).numpy(), qa,
                               atol=1e-6)
    pairs = [
        (t_lie.quat_mul(_t(qa), _t(qb)), j_lie.quat_mul(qa, qb)),
        (t_lie.quat_rotate(_t(qa), _t(v)), j_lie.quat_rotate(qa, v)),
        (t_lie.quat_to_rotmat(_t(qa)), j_lie.quat_to_rotmat(qa)),
        (t_lie.so3_log(_t(qa)), j_lie.so3_log(qa)),
        (t_lie.quat_boxminus(_t(qa), _t(qb)), j_lie.quat_boxminus(qa, qb)),
        (t_lie.delta_q(_t(th) * 0.01), j_lie.delta_q(th * 0.01)),
        (t_lie.skew(_t(v)), j_lie.skew(v)),
    ]
    R = np.asarray(j_lie.quat_to_rotmat(qa))
    ypr = np.asarray(j_lie.rotmat_to_ypr(R[0]))
    pairs += [
        (t_lie.rotmat_to_quat(_t(R[0])), j_lie.rotmat_to_quat(R[0])),
        (t_lie.rotmat_to_ypr(_t(R[0])), ypr),
        (t_lie.ypr_to_rotmat(_t(ypr)), j_lie.ypr_to_rotmat(ypr)),
    ]
    d = np.concatenate([v, th], -1) * 0.1
    p, q = t_lie.pose_retract(_t(v), _t(qa), _t(d))
    pj, qj = j_lie.pose_retract(v, qa, d)
    pairs += [(p, pj), (q, qj)]
    # Initialization's helpers: the quaternion product matrices, gravity
    # levelling (g antiparallel to +z included) and the numpy twins.
    g = np.concatenate([v, [[0.0, 0.0, -9.8], [0.0, 0.0, 9.8]]]).astype(
        np.float32)
    pairs += [
        (t_lie.quat_left(_t(qa)), j_lie.quat_left(qa)),
        (t_lie.quat_right(_t(qa)), j_lie.quat_right(qa)),
        (t_lie.gravity_to_rotmat(_t(g)), j_lie.gravity_to_rotmat(g)),
        (_t(t_lie.np_quat_mul(qa, qb)), j_lie.np_quat_mul(qa, qb)),
        (_t(t_lie.np_so3_exp_quat(th)), j_lie.np_so3_exp_quat(th)),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    R0 = t_lie.gravity_to_rotmat(_t(g))
    up = (R0 @ _t(g)[..., None])[..., 0]
    np.testing.assert_allclose((up / up.norm(dim=-1, keepdim=True)).numpy(),
                               np.tile([0.0, 0.0, 1.0], (len(g), 1)),
                               atol=1e-5)


@pytest.mark.parametrize("name", ["default_config", "euroc_config"])
def test_pixel_to_normalized_matches_jax(name):
    """Undistortion keeps the reference's fixed 20 fixed-point iterations
    (camera.py:47), with and without radial-tangential distortion."""
    cam_j = getattr(j_config, name)().camera
    cam_t = getattr(t_config, name)().camera
    rng = np.random.default_rng(5)
    uv = rng.uniform(0, [cam_j.width, cam_j.height], (64, 2)).astype(
        np.float32)
    np.testing.assert_allclose(
        t_cam.pixel_to_normalized(cam_t, _t(uv)).numpy(),
        np.asarray(j_cam.pixel_to_normalized(cam_j, jnp.asarray(uv))),
        atol=2e-6)


def test_corners_match_jax():
    """Shi-Tomasi response, occupancy and grid selection: the same cells,
    the same picks in the same order (stable sorts break ties as
    lax.top_k and argmax do)."""
    rng = np.random.default_rng(6)
    img = np.asarray(j_img.clahe(j_img.gaussian_blur(
        jnp.asarray(rng.uniform(0, 1, (128, 96)).astype(np.float32)), 1.0)))
    resp_j = j_corners.shi_tomasi_response(jnp.asarray(img))
    resp_t = t_corners.shi_tomasi_response(_t(img))
    # The min-eigenvalue's sqrt(tr^2 - 4 det) cancels: 1e-6 on responses
    # of order 1e-3.
    np.testing.assert_allclose(resp_t.numpy(), np.asarray(resp_j),
                               atol=1e-6)
    pts = rng.uniform(0, [96, 128], (20, 2)).astype(np.float32)
    valid = rng.uniform(0, 1, 20) > 0.3
    occ_j = j_corners.occupancy_cells((128, 96), jnp.asarray(pts),
                                      jnp.asarray(valid), 8)
    occ_t = t_corners.occupancy_cells((128, 96), _t(pts), _t(valid), 8)
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    # Feed both selections the same response so the ordering is tested
    # on identical scores.
    pick_j = j_corners.select_corners_grid(resp_j, occ_j, 40, 8)
    pick_t = t_corners.select_corners_grid(_t(resp_j), occ_t, 40, 8)
    np.testing.assert_array_equal(pick_t.valid.numpy(),
                                  np.asarray(pick_j.valid))
    np.testing.assert_array_equal(pick_t.pts.numpy(), np.asarray(pick_j.pts))
    np.testing.assert_array_equal(pick_t.score.numpy(),
                                  np.asarray(pick_j.score))


def _jax_gumbel(key, n_hyps, N):
    """The noise ransac_fundamental draws from `key` (ransac.py:102-107)."""
    keys = jax.random.split(key, n_hyps)
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (N,)))(keys))


def test_ransac_fundamental_matches_jax_with_injected_noise():
    """Given JAX's Gumbel draws, the port picks the same minimal sets, the
    same winning hypothesis and the same inliers; the rank-2 model agrees
    up to sign (float32 QR and SVD: 1e-3 on the unit-norm matrix)."""
    rng = np.random.default_rng(7)
    N, n_hyps = 48, 64
    X = np.stack([rng.uniform(-2, 2, N), rng.uniform(-2, 2, N),
                  rng.uniform(4, 8, N)], -1)
    ang = 0.05
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    t = np.array([0.3, 0.05, 0.02])
    X2 = X @ R.T + t
    p1 = (X[:, :2] / X[:, 2:]).astype(np.float32)
    p2 = (X2[:, :2] / X2[:, 2:]).astype(np.float32)
    p2[:6] += rng.normal(size=(6, 2)).astype(np.float32) * 0.05  # outliers
    p2 += rng.normal(size=p2.shape).astype(np.float32) * 1e-4
    valid = rng.uniform(0, 1, N) > 0.15
    thresh = (1.0 / 460.0) ** 2
    key = jax.random.PRNGKey(11)
    ref = j_ransac.ransac_fundamental(jnp.asarray(p1), jnp.asarray(p2),
                                      jnp.asarray(valid), key, n_hyps,
                                      thresh)
    out = t_ransac.ransac_fundamental(
        _t(p1), _t(p2), _t(valid), n_hyps, thresh,
        gumbel=_t(_jax_gumbel(key, n_hyps, N)))
    np.testing.assert_array_equal(out.inliers.numpy(),
                                  np.asarray(ref.inliers))
    assert int(out.n_inliers) == int(ref.n_inliers) >= 30
    assert not out.inliers.numpy()[:6].any()
    a = out.model.numpy() / np.linalg.norm(out.model.numpy())
    b = np.asarray(ref.model) / np.linalg.norm(np.asarray(ref.model))
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) < 1e-3


def test_ransac_draws_from_a_generator_without_noise():
    """Without injected noise the port draws from a torch.Generator: the
    same seed gives the same result, and a clean scene keeps every
    valid point."""
    rng = np.random.default_rng(8)
    X = np.stack([rng.uniform(-2, 2, 40), rng.uniform(-2, 2, 40),
                  rng.uniform(4, 8, 40)], -1)
    p1 = _t((X[:, :2] / X[:, 2:]).astype(np.float32))
    X2 = X + np.array([0.2, 0.0, 0.05])
    p2 = _t((X2[:, :2] / X2[:, 2:]).astype(np.float32))
    valid = torch.ones(40, dtype=torch.bool)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        outs.append(t_ransac.ransac_fundamental(p1, p2, valid, 32, 1e-6,
                                                generator=gen))
    assert torch.equal(outs[0].inliers, outs[1].inliers)
    assert int(outs[0].n_inliers) == 40


# ---------------------------------------------------------------------------
# Tracker steps on rendered frames
# ---------------------------------------------------------------------------

_S = 0.4   # the default 480x640 camera scaled to 192x256
_CAM = dict(width=192, height=256, fx=526.600 * _S, fy=526.678 * _S,
            cx=243.481 * _S, cy=315.280 * _S)
_FE = dict(max_features=48, target_features=40, min_distance=16,
           klt_eps=0.0)
_WIN = dict(window_size=5, max_landmarks=64, max_imu_per_edge=8)


def test_tracker_steps_match_jax():
    """init_step then track_step (K1 forward and backward, K2, F-RANSAC
    with JAX's noise, top-up) over rendered frames: the same ids, the same
    live slots, points within 1e-3 px (eps = 0: the JAX CPU path)."""
    from vins_tpu.frontend import tracker as j_tr
    from vins_tpu_torch.frontend import tracker as t_tr

    cfg = j_config.VinsConfig(camera=j_config.CameraConfig(**_CAM),
                              frontend=j_config.FrontendConfig(**_FE),
                              window=j_config.WindowConfig(**_WIN))
    tcfg = t_config.VinsConfig(camera=t_config.CameraConfig(**_CAM),
                               frontend=t_config.FrontendConfig(**_FE),
                               window=t_config.WindowConfig(**_WIN))
    # The render test_torch_stream.py uses (shared through the disk cache).
    _, imgs = render_cached(cfg, n_frames=40, seed=5, frame_dt=1.0 / 30.0,
                            traj_kwargs=dict(w=0.7, bob=0.15),
                            imu_per_frame=2)
    M, n_hyps = cfg.frontend.max_features, cfg.frontend.f_ransac_hyps
    js = j_tr.fresh_state(cfg, 0)
    ts = t_tr.fresh_state(tcfg, 0)
    init = jax.jit(lambda s, i: j_tr.init_step(s, i, cfg))
    step = jax.jit(lambda s, i, top: j_tr.track_step(s, i, cfg, top),
                   static_argnums=2)
    key = jax.random.PRNGKey(0)
    for f in range(7):
        top = f % 3 == 0
        if f == 0:
            js, jo = init(js, jnp.asarray(imgs[0]))
            ts, to = t_tr.init_step(ts, _t(imgs[0]), tcfg)
        else:
            key, sub = jax.random.split(key)
            js, jo = step(js, jnp.asarray(imgs[f]), top)
            ts, to = t_tr.track_step(ts, _t(imgs[f]), tcfg, top,
                                     _t(_jax_gumbel(sub, n_hyps, M)))
        v = np.asarray(js.valid)
        assert v.sum() >= 20, f
        np.testing.assert_array_equal(ts.valid.numpy(), v, err_msg=str(f))
        np.testing.assert_array_equal(ts.ids.numpy(), np.asarray(js.ids))
        np.testing.assert_array_equal(to.ids.numpy(), np.asarray(jo.ids))
        assert int(ts.next_id) == int(js.next_id)
        np.testing.assert_allclose(ts.pts.numpy()[v], np.asarray(js.pts)[v],
                                   atol=1e-3)
        np.testing.assert_allclose(to.obs.numpy()[v],
                                   np.asarray(jo.obs)[v], atol=1e-5)


def test_interop_round_trip():
    """to_torch maps a JAX state tree, fetched as numpy, onto the port's
    NamedTuples field by field; to_numpy brings it back unchanged."""
    from vins_tpu.core.estimator import BackendState as JBackend
    from vins_tpu_torch.core.estimator import BackendState as TBackend

    cfg = j_config.VinsConfig(window=j_config.WindowConfig(**_WIN))
    tcfg = t_config.VinsConfig(window=t_config.WindowConfig(**_WIN))
    tree = jax.device_get(JBackend.fresh(cfg))
    like = TBackend.fresh(tcfg)
    port = interop.to_torch(tree, like)
    assert type(port) is TBackend
    back = interop.to_numpy(port)
    flat_j = jax.tree_util.tree_leaves(tree)
    flat_t = jax.tree_util.tree_leaves(back)
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(jax.tree_util.tree_leaves(like),
                    jax.tree_util.tree_leaves(port)):
        assert a.dtype == b.dtype and a.shape == b.shape


@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_rmse_matches_jax_package(with_scale):
    """The port's Umeyama-aligned ATE (what chip_smoke.py gates on) equals
    vins_tpu.io.evaluate's, the metric test_stream_parity.py bounds."""
    from vins_tpu.io import evaluate as j_eval
    from vins_tpu_torch.io import evaluate as t_eval

    rng = np.random.default_rng(10)
    gt = np.cumsum(rng.normal(size=(80, 3)) * 0.05, 0)
    ang = 0.3
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang),
                                                   np.cos(ang), 0],
                  [0, 0, 1]])
    est = 1.1 * gt @ R.T + np.array([0.5, -0.2, 0.1])
    est += rng.normal(size=est.shape) * 0.01
    a = t_eval.ate_rmse(est, gt, with_scale)
    b = j_eval.ate_rmse(est, gt, with_scale)
    for name in ("rmse", "mean", "median", "max", "s"):
        assert getattr(a, name) == pytest.approx(getattr(b, name), rel=1e-12)
    np.testing.assert_allclose(a.R, b.R, atol=1e-12)
    np.testing.assert_allclose(a.t, b.t, atol=1e-12)
