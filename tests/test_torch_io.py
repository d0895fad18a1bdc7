"""The port's dataset IO against the JAX package's, on the CPU: the ASL
reader and measurement alignment on trees written by either package's
fixture generator, the fixture writer itself, the distorted camera's ray
grid and the camera helpers, the trajectory metrics, IMU stream
alignment, the live-sensor StreamSync, and the recorder and checkpoint
round trips. Inputs come from numpy seeds or the generated trees."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vins_tpu.config import euroc_config as j_euroc_config
from vins_tpu.io import asl_fixture as j_fix
from vins_tpu.io import euroc as j_euroc
from vins_tpu.io import evaluate as j_eval
from vins_tpu.io import imu_sync as j_sync
from vins_tpu.io import replay as j_replay
from vins_tpu.io.native_runtime import StreamSync as JStreamSync
from vins_tpu.io.synthetic import camera_ray_grid as j_ray_grid
from vins_tpu.utils import camera as j_cam

from vins_tpu_torch import euroc_config as t_euroc_config
from vins_tpu_torch.core.estimator import BackendState
from vins_tpu_torch.frontend.tracker import FeatureTracker
from vins_tpu_torch.io import asl_fixture as t_fix
from vins_tpu_torch.io import euroc as t_euroc
from vins_tpu_torch.io import evaluate as t_eval
from vins_tpu_torch.io import imu_sync as t_sync
from vins_tpu_torch.io import replay as t_replay
from vins_tpu_torch.io.stream_sync import StreamSync as TStreamSync
from vins_tpu_torch.io.synthetic import camera_ray_grid as t_ray_grid
from vins_tpu_torch.utils import camera as t_cam

pytest_plugins = ["torch_watchdog"]

torch.set_num_threads(1)

JCFG, TCFG = j_euroc_config(), t_euroc_config()
N_FIX = 8


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One noise-free 8-frame tree from each package's generator, seed 3."""
    root = tmp_path_factory.mktemp("asl")
    kw = dict(n_frames=N_FIX, seed=3, image_noise=0.0)
    j_root, t_root = str(root / "jax"), str(root / "port")
    j_truth = j_fix.generate_asl_fixture(j_root, JCFG, **kw)
    t_truth = t_fix.generate_asl_fixture(t_root, TCFG, device="cpu", **kw)
    return j_root, t_root, j_truth, t_truth


def _same_index(a, b):
    np.testing.assert_array_equal(a.cam_ts, b.cam_ts)
    assert [os.path.basename(f) for f in a.cam_files] == \
        [os.path.basename(f) for f in b.cam_files]
    for name in ("imu_ts", "acc", "gyr", "gt_ts", "gt_p", "gt_q"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


def _same_frames(jframes, tframes):
    assert len(jframes) == len(tframes) == N_FIX - 1
    for fj, ft in zip(jframes, tframes):
        assert fj.t == ft.t
        assert fj.image_path == ft.image_path
        for name in ("dt", "acc", "gyr"):
            tv = getattr(ft.chunk, name)
            assert tv.device.type == "cpu" and tv.dtype == torch.float32
            np.testing.assert_array_equal(tv.numpy(),
                                          getattr(fj.chunk, name),
                                          err_msg=name)
        np.testing.assert_array_equal(ft.gt_p, fj.gt_p)
        np.testing.assert_array_equal(ft.gt_q, fj.gt_q)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_port_loader_matches_jax(trees, writer):
    """Both readers on one tree (written by either package): the same
    timestamps, IMU samples and ground truth, the same aligned chunks
    (dt, acc, gyr), bit for bit, and the same decoded frames."""
    root = trees[0] if writer == "jax" else trees[1]
    dj, dt = j_euroc.load_euroc(root), t_euroc.load_euroc(root)
    _same_index(dj, dt)
    fj = list(j_euroc.align_measurements(dj, JCFG))
    ft = list(t_euroc.align_measurements(dt, TCFG, device="cpu"))
    _same_frames(fj, ft)
    path = fj[0].image_path
    img = t_euroc._decode_png_gray8(path)
    assert img.shape == (TCFG.camera.height, TCFG.camera.width)
    np.testing.assert_array_equal(img, j_euroc._decode_png_gray8(path))
    np.testing.assert_array_equal(t_euroc.load_gray_png(path),
                                  j_euroc.load_gray_png(path))


def test_png_decoder_filters_match_jax(tmp_path):
    """Every PNG row filter (none, sub, up, average, Paeth) decodes as in
    the JAX package, on a seeded 37x23 image encoded with a filter per
    row."""
    import struct
    import zlib

    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (23, 37)).astype(np.uint8)
    H, W = img.shape
    rows, prev = [], np.zeros(W, np.int64)
    for y in range(H):
        ft, cur = y % 5, img[y].astype(np.int64)
        left = np.concatenate([[0], cur[:-1]])
        upleft = np.concatenate([[0], prev[:-1]])
        if ft == 0:
            pred = np.zeros(W, np.int64)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([ft]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = cur

    def chunk(ctype, payload):
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(ctype + payload)))

    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))
    out = t_euroc._decode_png_gray8(path)
    np.testing.assert_array_equal(out, j_euroc._decode_png_gray8(path))
    np.testing.assert_array_equal(out, img.astype(np.float32) / 255.0)


def test_fixture_writer_matches_jax(trees):
    """With image_noise=0 the port's generator writes the JAX one's csvs
    byte for byte and the same truth; its PNGs differ by at most one 8-bit
    level on at most 0.1% of the pixels (float32 renders that round to
    the neighbouring level)."""
    j_root, t_root, j_truth, t_truth = trees
    for rel in ("cam0/data.csv", "imu0/data.csv",
                "state_groundtruth_estimate0/data.csv"):
        with open(os.path.join(j_root, "mav0", rel), "rb") as f:
            a = f.read()
        with open(os.path.join(t_root, "mav0", rel), "rb") as f:
            assert f.read() == a, rel
    for name in ("cam_ts", "p", "q"):
        np.testing.assert_array_equal(getattr(t_truth, name),
                                      getattr(j_truth, name))
    names = sorted(os.listdir(os.path.join(j_root, "mav0", "cam0", "data")))
    assert len(names) == N_FIX
    n_diff = n_px = 0
    for name in names:
        a, b = (np.round(t_euroc._decode_png_gray8(os.path.join(
            r, "mav0", "cam0", "data", name)) * 255).astype(np.int64)
            for r in (j_root, t_root))
        assert np.abs(a - b).max() <= 1, name
        n_diff += int((a != b).sum())
        n_px += a.size
    assert n_diff <= 1e-3 * n_px, (n_diff, n_px)


def test_distorted_ray_grid_matches_jax():
    """camera_ray_grid through the radtan model, and without it, matches
    the JAX package's to 1e-6 (float32 fixed-point undistortion); the
    distortion bends the corner rays by more than 0.02 rad."""
    for distorted in (False, True):
        d_j = j_ray_grid(JCFG, distorted=distorted)
        d_t = t_ray_grid(TCFG, distorted=distorted)
        assert d_t.shape == (480, 752, 3)
        np.testing.assert_allclose(d_t, d_j, atol=1e-6, rtol=0)
    d_pin, d_rad = t_ray_grid(TCFG), t_ray_grid(TCFG, distorted=True)
    assert np.arccos(np.clip(np.sum(d_pin[2, 2] * d_rad[2, 2]), -1, 1)) > 0.02


def test_camera_helpers_match_jax():
    """normalized_to_pixel, pixel_to_normalized, project, in_border and
    intrinsics_matrix on seeded points, with the distorted EuRoC camera and
    the undistorted default one. normalized_to_pixel to 1e-3 px absolute
    and 1e-6 relative (float32 rounding at pixel coordinates up to about
    750, in a possibly different order); pixel_to_normalized to 1e-6;
    in_border and intrinsics_matrix exactly; project to 1e-6 relative."""
    rng = np.random.default_rng(11)
    xy = rng.uniform(-0.6, 0.6, (64, 2)).astype(np.float32)
    pc = rng.normal(size=(64, 3)).astype(np.float32)
    pc[:4, 2] = [0.0, 1e-9, -1e-9, 2.0]
    uv = rng.uniform(-5, 760, (64, 2)).astype(np.float32)
    from vins_tpu.config import default_config as j_default
    from vins_tpu_torch import default_config as t_default
    for jc, tc in ((JCFG.camera, TCFG.camera),
                   (j_default().camera, t_default().camera)):
        np.testing.assert_allclose(
            t_cam.normalized_to_pixel(tc, torch.as_tensor(xy)).numpy(),
            np.asarray(j_cam.normalized_to_pixel(jc, jnp.asarray(xy))),
            atol=1e-3, rtol=1e-6)
        np.testing.assert_allclose(
            t_cam.pixel_to_normalized(tc, torch.as_tensor(uv)).numpy(),
            np.asarray(j_cam.pixel_to_normalized(jc, jnp.asarray(uv))),
            atol=1e-6)
        np.testing.assert_array_equal(
            t_cam.in_border(tc, torch.as_tensor(uv), 3).numpy(),
            np.asarray(j_cam.in_border(jc, jnp.asarray(uv), 3)))
        np.testing.assert_array_equal(
            t_cam.intrinsics_matrix(tc).numpy(),
            np.asarray(j_cam.intrinsics_matrix(jc)))
    np.testing.assert_allclose(
        t_cam.project(torch.as_tensor(pc)).numpy(),
        np.asarray(j_cam.project(jnp.asarray(pc))), rtol=1e-6)


def test_trajectory_metrics_match_jax():
    """rpe (three deltas, one past the length), trajectory_length and the
    aligned ATE on a seeded noisy circle: equal to 1e-12 (both float64
    numpy)."""
    rng = np.random.default_rng(2)
    t = np.linspace(0, 6, 90)
    gt = np.stack([3 * np.cos(t), 3 * np.sin(t), 0.2 * np.sin(2 * t)], -1)
    est = gt + rng.normal(scale=0.05, size=gt.shape) + 0.01 * t[:, None]
    for delta in (1, 30, 200):
        np.testing.assert_allclose(t_eval.rpe(est, gt, delta),
                                   j_eval.rpe(est, gt, delta), rtol=1e-12)
    assert abs(t_eval.trajectory_length(est)
               - j_eval.trajectory_length(est)) < 1e-12
    assert abs(t_eval.ate_rmse(est, gt, True).rmse
               - j_eval.ate_rmse(est, gt, True).rmse) < 1e-12


def _async_streams(seed):
    """Seeded 100 Hz accel and 95 Hz gyro streams with jitter, and 10 Hz
    image stamps starting before the first IMU sample."""
    rng = np.random.default_rng(seed)
    ta = np.cumsum(rng.uniform(0.008, 0.012, 120)) + 5.0
    tg = np.cumsum(rng.uniform(0.009, 0.012, 115)) + 5.002
    acc = rng.normal(size=(len(ta), 3)) + [0, 0, 9.8]
    gyr = rng.normal(scale=0.1, size=(len(tg), 3))
    t_img = 5.0 + 0.1 * np.arange(13) - 0.05
    return ta, acc, tg, gyr, t_img


@pytest.mark.parametrize("max_per_edge", [16, 6])
def test_imu_sync_matches_jax(max_per_edge):
    """interpolate_imu, align_measurements and chunk_imu (with room for
    every sample, and with overflowing edges) give the JAX module's
    arrays exactly."""
    ta, acc, tg, gyr, t_img = _async_streams(0)
    fj = j_sync.interpolate_imu(tg, gyr, ta, acc)
    ft = t_sync.interpolate_imu(tg, gyr, ta, acc)
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(a, b)
    t, a, g = fj
    assert t_sync.align_measurements(t, t_img) == \
        j_sync.align_measurements(t, t_img)
    cj = j_sync.chunk_imu(t, a, g, t_img, max_per_edge)
    ct = t_sync.chunk_imu(t, a, g, t_img, max_per_edge, device="cpu")
    for name in ("dt", "acc", "gyr"):
        np.testing.assert_array_equal(getattr(ct, name).numpy(),
                                      getattr(cj, name), err_msg=name)


@pytest.mark.parametrize("max_per_edge", [16, 6])
def test_stream_sync_matches_jax(max_per_edge):
    """The live-sensor StreamSync fed the same interleaved accel, gyro and
    image pushes (out-of-order pushes included) returns the same
    acceptances, pending counts and polled chunks as the JAX package's
    pure-Python one."""
    ta, acc, tg, gyr, t_img = _async_streams(1)
    events = ([(t, 0, a) for t, a in zip(ta, acc)]
              + [(t, 1, g) for t, g in zip(tg, gyr)]
              + [(t, 2, k) for k, t in enumerate(t_img)])
    events.sort(key=lambda e: (e[0], e[1]))
    events.insert(20, (events[5][0], 0, acc[0]))      # stale accel
    events.insert(40, (events[30][0], 2, 99))          # stale image
    sj = JStreamSync(max_per_edge, img_capacity=8)
    st = TStreamSync(max_per_edge, img_capacity=8, device="cpu")
    polled = 0
    for t, kind, x in events:
        push = ("push_accel", "push_gyro", "push_image")[kind]
        assert getattr(st, push)(t, x) == getattr(sj, push)(t, x)
        assert st.pending() == sj.pending()
        while True:
            rj, rt = sj.poll(), st.poll()
            assert (rj is None) == (rt is None)
            if rj is None:
                break
            assert rt[:2] == rj[:2]
            for name in ("dt", "acc", "gyr"):
                np.testing.assert_array_equal(getattr(rt[2], name).numpy(),
                                              getattr(rj[2], name))
            polled += 1
    assert polled >= 8


def test_recorder_and_checkpoint_round_trip(tmp_path):
    """The Recorder's npz holds what was added, stacked (and reads back a
    JAX-written one); a checkpoint of the port's BackendState and
    TrackerState (its torch.Generator included) loads back equal, and the
    generator continues the same stream."""
    rng = np.random.default_rng(5)
    rows = [dict(t=float(k), p=rng.normal(size=3).astype(np.float32),
                 initialized=bool(k % 2)) for k in range(5)]
    rec_t, rec_j = t_replay.Recorder(), j_replay.Recorder()
    for r in rows:
        rec_t.add(**r)
        rec_j.add(**r)
    rec_t.save(str(tmp_path / "t.npz"))
    rec_j.save(str(tmp_path / "j.npz"))
    for path in ("t.npz", "j.npz"):
        got = t_replay.Recorder.load(str(tmp_path / path))
        np.testing.assert_array_equal(got["p"],
                                      np.stack([r["p"] for r in rows]))
        np.testing.assert_array_equal(got["initialized"],
                                      [r["initialized"] for r in rows])
    with pytest.raises(ValueError):
        t_replay.Recorder().save(str(tmp_path / "empty.npz"))

    from vins_tpu_torch import default_config
    cfg = default_config()
    est = BackendState.fresh(cfg, "cpu")
    est = est._replace(window=est.window._replace(
        p=torch.as_tensor(rng.normal(size=(cfg.window.num_frames, 3)),
                          dtype=torch.float32)))
    tracker = FeatureTracker(cfg, 3, "cpu")
    state = (est, tracker.state, [np.int64(7), "tag"])
    t_replay.save_checkpoint(str(tmp_path / "ck.pkl"), state)
    back = t_replay.load_checkpoint(str(tmp_path / "ck.pkl"))
    assert type(back[0]) is BackendState
    assert type(back[1]) is type(tracker.state)
    assert back[2] == [7, "tag"]

    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, tuple):
            return [l for v in x for l in leaves(v)]
        return []

    for a, b in zip(leaves(back[0]) + leaves(back[1]),
                    leaves(est) + leaves(tracker.state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    gen_a = tracker.state.gen
    gen_b = back[1].gen
    assert torch.equal(torch.rand(4, generator=gen_a),
                       torch.rand(4, generator=gen_b))
