"""Tracking held to exact geometry, on the CPU: the port's
ground_truth_correspondence (the renderer's ray cast) against the JAX
package's, and the port's FeatureTracker (the tracking kernels' plain
versions) over frames 0→1 of tests/test_frontend.py's fixture, held to
that test's bounds against the exact correspondence."""
import dataclasses

import numpy as np
import pytest
import torch

from vins_tpu.config import VinsConfig as JVinsConfig
from vins_tpu.io import synthetic as j_syn

from vins_tpu_torch import default_config
from vins_tpu_torch.frontend.tracker import FeatureTracker
from vins_tpu_torch.io import synthetic as t_syn

pytest_plugins = ["torch_watchdog"]

torch.set_num_threads(1)

# tests/test_frontend.py:24-37: 10 fps, so 4 pyramid levels.
CFG = default_config()
CFG = dataclasses.replace(
    CFG, frontend=dataclasses.replace(CFG.frontend, pyramid_levels=4))
TRAJ = dict(w=0.35, bob=0.15)


@pytest.mark.parametrize("frames", [(0, 1), (0, 7), (5, 2), (3, 3)])
def test_ground_truth_correspondence_matches_jax(frames):
    """64 seeded pixels, the port's sequence against the JAX one from the
    same seed: atol 1e-3 px. Numpy and tensor pixels give the same."""
    seq_j = j_syn.make_synthetic_sequence(JVinsConfig(), n_frames=8,
                                          n_landmarks=50, seed=9,
                                          traj_kwargs=TRAJ)
    seq_t = t_syn.make_synthetic_sequence(CFG, n_frames=8, n_landmarks=50,
                                          seed=9, traj_kwargs=TRAJ,
                                          device="cpu")
    rng = np.random.default_rng(64)
    cam = CFG.camera
    px = np.stack([rng.uniform(0, cam.width, 64),
                   rng.uniform(0, cam.height, 64)], -1).astype(np.float32)
    a, b = frames
    ref = j_syn.ground_truth_correspondence(seq_j, JVinsConfig(), px, a, b)
    got = t_syn.ground_truth_correspondence(seq_t, CFG, px, a, b)
    assert got.shape == (64, 2) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, atol=1e-3)
    np.testing.assert_array_equal(
        t_syn.ground_truth_correspondence(seq_t, CFG, torch.as_tensor(px),
                                          a, b), got)
    if a == b:
        np.testing.assert_allclose(got, px, atol=1e-3)


def test_tracker_flow_matches_geometry():
    """tests/test_frontend.py::test_tracker_flow_matches_geometry on the
    port: frames 0 and 1 of its fixture (make_synthetic_sequence seed 9,
    50 landmarks, 10 fps, 4 levels; the first two frames alone, which
    have the same poses), rendered by the port; at least 40 common ids,
    median error under 0.8 px and 90% under 2.5 px."""
    seq = t_syn.make_synthetic_sequence(CFG, n_frames=2, n_landmarks=50,
                                        seed=9, traj_kwargs=TRAJ,
                                        device="cpu")
    imgs = t_syn.render_sequence_images(seq, CFG, seed=9, device="cpu")
    tracker = FeatureTracker(CFG, device="cpu")
    out0 = tracker.process(imgs[0])
    assert int(out0.n_tracked) >= 50
    out1 = tracker.process(imgs[1])
    ids0, v0 = out0.ids.numpy(), out0.obs_valid.numpy()
    ids1, v1 = out1.ids.numpy(), out1.obs_valid.numpy()
    common, ia, ib = np.intersect1d(ids0[v0], ids1[v1], return_indices=True)
    assert len(common) >= 40, len(common)
    pa = out0.pts_px.numpy()[v0][ia]
    pb = out1.pts_px.numpy()[v1][ib]
    expect = t_syn.ground_truth_correspondence(seq, CFG, pa, 0, 1)
    err = np.linalg.norm(pb - expect, axis=-1)
    assert np.median(err) < 0.8, np.median(err)
    assert (err < 2.5).mean() > 0.9, (err < 2.5).mean()
