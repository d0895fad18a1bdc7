"""The streaming slice end to end: vins_tpu_torch against vins_tpu.

Both systems run VinsSystem(use_loop=False).process_stream from an
uninitialized state on the same rendered frames, bootstrap from ground
truth (the JAX side through a monkeypatched initializer, the port through
io.synthetic.ground_truth_initializer), and then stream two full blocks.
RANSAC noise is replayed from the JAX tracker's key chain into the port.
Both sides use klt_eps = 0: the JAX package's CPU path runs a fixed LK
iteration count, which the port's kernel semantics equal at eps = 0.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import render_cached
from vins_tpu.config import (CameraConfig, FrontendConfig, VinsConfig,
                             WindowConfig)

import vins_tpu_torch.config as tc
from vins_tpu_torch import pipeline as t_pipe
from vins_tpu_torch.io import synthetic as t_syn
from vins_tpu_torch.utils import lie as t_lie

torch.set_num_threads(1)

_S = 0.4   # 480x640 default camera scaled to 192x256
_CAM = dict(width=192, height=256, fx=526.600 * _S, fy=526.678 * _S,
            cx=243.481 * _S, cy=315.280 * _S)
_FE = dict(max_features=48, target_features=40, min_distance=16,
           klt_eps=0.0)
_WIN = dict(window_size=5, max_landmarks=64, max_imu_per_edge=8)
CFG = VinsConfig(camera=CameraConfig(**_CAM), frontend=FrontendConfig(**_FE),
                 window=WindowConfig(**_WIN))
TCFG = tc.VinsConfig(camera=tc.CameraConfig(**_CAM),
                     frontend=tc.FrontendConfig(**_FE),
                     window=tc.WindowConfig(**_WIN))
F = CFG.window.num_frames
BLOCK = 12
BOOT = CFG.freq * (F - 1) + 1          # frames until the boot window fills
N_FRAMES = BOOT + 2 * BLOCK
TRAJ = dict(w=0.7, bob=0.15)
SEED = 5


def jax_ransac_noise(seed, n_frames, n_hyps, M):
    """[n_frames, n_hyps, M] Gumbel noise the JAX tracker draws: frame f>=1
    splits the carried key and samples one gumbel(k, (M,)) per hypothesis
    key (frontend/tracker.py:177, ops/ransac.py:102-107)."""
    key = jax.random.PRNGKey(seed)
    out = np.zeros((n_frames, n_hyps, M), np.float32)
    draw = jax.jit(jax.vmap(lambda k: jax.random.gumbel(k, (M,))))
    for f in range(1, n_frames):
        key, sub = jax.random.split(key)
        out[f] = np.asarray(draw(jax.random.split(sub, n_hyps)))
    return out


def _rot_err(qa, qb):
    """Angle (rad) between two wxyz quaternions."""
    d = abs(float(np.dot(qa, qb)) / (np.linalg.norm(qa) * np.linalg.norm(qb)))
    return 2.0 * np.arccos(min(d, 1.0))


@pytest.fixture(scope="module")
def streams():
    from vins_tpu.core import feature_manager as j_fm
    from vins_tpu.core.initialization import InitResult, InitStatus
    from vins_tpu.core.state import WindowState as JWindow
    from vins_tpu import pipeline as j_pipe

    seq, imgs = render_cached(CFG, n_frames=N_FRAMES, seed=SEED,
                              frame_dt=1.0 / 30.0, traj_kwargs=TRAJ,
                              imu_per_frame=2)
    noise = jax_ransac_noise(0, N_FRAMES, CFG.frontend.f_ransac_hyps,
                             CFG.frontend.max_features)

    # --- JAX: ground-truth bootstrap through a patched initializer ------
    sys_j = j_pipe.VinsSystem(CFG, use_loop=False, ext=seq.ext)
    M = CFG.window.max_landmarks

    def gt_initialize(feats, chunks, ext, cfg):
        cur = sys_j.frame_idx - 1
        idx = np.array([cur - CFG.freq * (F - 1 - f) for f in range(F)])
        win = JWindow(p=seq.p[idx], q=seq.q[idx], v=seq.v[idx],
                      ba=jnp.zeros((F, 3)), bg=jnp.zeros((F, 3)),
                      inv_depth=jnp.zeros(M))
        return InitResult(j_fm.triangulate(win, feats, ext, cfg),
                          InitStatus.SUCCESS)

    mp = pytest.MonkeyPatch()
    mp.setattr(j_pipe.init_mod, "initialize", gt_initialize)
    sys_j._refine_init = lambda w, fe, ch: (w, 0.0)
    try:
        outs_j = sys_j.process_stream(
            jnp.asarray(imgs), seq.chunks, block=BLOCK,
            ts=np.asarray(seq.timestamps))
    finally:
        mp.undo()

    # --- port ------------------------------------------------------------
    tseq = t_syn.make_synthetic_sequence(
        TCFG, n_frames=N_FRAMES, n_landmarks=60, seed=SEED,
        frame_dt=1.0 / 30.0, traj_kwargs=TRAJ, imu_per_frame=2,
        device="cpu")
    sys_t = t_pipe.VinsSystem(
        TCFG, ext=tseq.ext, device="cpu", use_loop=False,
        initializer=t_syn.ground_truth_initializer(tseq, TCFG))
    outs_t = sys_t.process_stream(
        torch.as_tensor(imgs), tseq.chunks, block=BLOCK,
        ts=tseq.timestamps.numpy(), gumbel=torch.as_tensor(noise))
    return seq, outs_j, outs_t


def test_torch_stream_matches_jax_per_frame(streams):
    """Per-frame parity over the bootstrap and two full blocks.
    Tolerances: 5e-3 m / 5e-3 rad absorb fp32 solver round-off (the
    backend's conditioned LM solves agree to ~1e-4 m per step; the error
    accumulates over the window's solves); discrete decisions must match
    exactly; n_tracked may differ by 2 for a sub-pixel KLT or Sampson
    threshold that flips under reordered fp32 sums."""
    seq, outs_j, outs_t = streams
    assert len(outs_j) == len(outs_t) == N_FRAMES
    n_init = 0
    for k, (oj, ot) in enumerate(zip(outs_j, outs_t)):
        assert oj.initialized == ot.initialized, k
        assert oj.is_keyframe == ot.is_keyframe, k
        assert oj.status == ot.status, k
        assert abs(oj.n_tracked - ot.n_tracked) <= 2, (k, oj.n_tracked,
                                                      ot.n_tracked)
        if oj.initialized:
            n_init += 1
            np.testing.assert_allclose(ot.p, oj.p, atol=5e-3,
                                       err_msg=f"frame {k}")
            assert _rot_err(np.asarray(oj.q), np.asarray(ot.q)) < 5e-3, k
    assert n_init >= 2 * BLOCK + 1


def test_torch_stream_tracks_ground_truth(streams):
    """The port's streamed trajectory stays on the ground truth: every
    published pose after bootstrap is finite and the ATE RMSE is under
    the 0.15 m bound tests/test_stream_parity.py uses."""
    seq, _, outs_t = streams
    init_at = next(i for i, o in enumerate(outs_t) if o.initialized)
    est = np.stack([o.p for o in outs_t[init_at:]])
    assert np.all(np.isfinite(est))
    assert all(o.initialized for o in outs_t[init_at:])
    gt = np.asarray(seq.p[init_at:])
    rmse = float(np.sqrt(np.mean(np.sum((est - gt) ** 2, -1))))
    assert rmse < 0.15, rmse


def test_torch_render_matches_jax_noise_free():
    """The port's renderer equals the JAX ray-caster on noise-free frames
    (float32 trig over the same texture basis: atol 1e-4)."""
    from vins_tpu.io import synthetic as j_syn

    seq_j = j_syn.make_synthetic_sequence(
        CFG, n_frames=3, n_landmarks=20, seed=1, frame_dt=0.1,
        traj_kwargs=TRAJ, imu_per_frame=2)
    seq_t = t_syn.make_synthetic_sequence(
        TCFG, n_frames=3, n_landmarks=20, seed=1, frame_dt=0.1,
        traj_kwargs=TRAJ, imu_per_frame=2, device="cpu")
    for name in ("p", "q", "v", "ids", "obs", "obs_valid", "timestamps"):
        np.testing.assert_array_equal(getattr(seq_t, name).numpy(),
                                      np.asarray(getattr(seq_j, name)))
    for a, b in zip(seq_t.chunks, seq_j.chunks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    img_j = np.asarray(j_syn.render_sequence_images(seq_j, CFG, seed=2,
                                                    noise_sigma=0.0))
    img_t = t_syn.render_sequence_images(seq_t, TCFG, seed=2,
                                         noise_sigma=0.0,
                                         device="cpu").numpy()
    np.testing.assert_allclose(img_t, img_j, atol=1e-4)
    # Noisy renders keep the [0, 1] range and the noise scale.
    noisy = t_syn.render_sequence_images(seq_t, TCFG, seed=2,
                                         device="cpu").numpy()
    assert noisy.min() >= 0.0 and noisy.max() <= 1.0
    assert 0.002 < float(np.std(noisy - img_t)) < 0.008
