"""The streaming slice end to end: vins_tpu_torch against vins_tpu.

Both systems run VinsSystem(use_loop=False).process_stream from an
uninitialized state on the same rendered frames, bootstrap from ground
truth (the JAX side through a monkeypatched initializer, the port through
io.synthetic.ground_truth_initializer), and then stream two full blocks.
RANSAC noise is replayed from the JAX tracker's key chain into the port.
Both sides use klt_eps = 0: the JAX package's CPU path runs a fixed LK
iteration count, which the port's kernel semantics equal at eps = 0.

On this scene the bootstrap prior's weakest directions are float32
round-off in both packages: the Schur complement that both form with an
eigen-pseudo-inverse has a least eigenvalue that moves between -3 and
-45 under track changes of 2e-4 px, on both sides of the 100x ridge at
30.1 past which the reference's prior is NaN and the port's the eigen
fallback (test_bootstrap_schur_spreads_in_both_packages). At the shipped
klt_eps the reference's is NaN; test_torch_stream_shipped.py carries the
port's into it (carry_bootstrap_priors).
"""
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import render_cached
from vins_tpu.config import (CameraConfig, FrontendConfig, VinsConfig,
                             WindowConfig)

import vins_tpu_torch.config as tc
from vins_tpu_torch import interop
from vins_tpu_torch import pipeline as t_pipe
from vins_tpu_torch.core import marginalization as t_marg
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


def carry_bootstrap_priors(mp, j_pipe, carry=True):
    """Patch both packages' BackendState.bootstrap for one lockstep: each
    records the states it makes (the port its arguments too) and, with
    carry, the reference goes on with the port's prior of the same index
    (the port must bootstrap first). Returns {"t": [port states],
    "t_args": [...], "j": [reference states]}, each state as its own
    bootstrap made it."""
    rec = dict(t=[], t_args=[], j=[])
    t_boot = t_pipe.BackendState.bootstrap
    j_boot = j_pipe.BackendState.bootstrap

    def port(cfg, *args):
        est = t_boot(cfg, *args)
        rec["t"].append(est)
        rec["t_args"].append(args)
        return est

    def ref(cfg, *args):
        est = j_boot(cfg, *args)
        rec["j"].append(est)
        if carry:
            src = interop.to_numpy(rec["t"][len(rec["j"]) - 1].prior)
            est = est._replace(prior=type(est.prior)(
                *[jnp.asarray(x) for x in src]))
        return est

    mp.setattr(t_pipe.BackendState, "bootstrap", staticmethod(port))
    mp.setattr(j_pipe.BackendState, "bootstrap", staticmethod(ref))
    return rec


BRANCHES = ("ridge", "ridge_100x", "past_both")


def record_branches(mp, rec):
    """Record in rec["branches_j"] / ["branches_t"], call by call, the
    branch each package's prior factorization (_info_to_sqrt) takes:
    the ridge Cholesky, the 100x ridge, or neither (the reference's NaN,
    the port's eigen fallback). The JAX side decides it with its own
    Cholesky, through a host callback inside its jitted scan."""
    from vins_tpu.core import marginalization as j_marg

    rec.update(branches_j=[], branches_t=[])
    j_inner, t_inner = j_marg._info_to_sqrt, t_marg._info_to_sqrt
    name = lambda ok1, ok2: BRANCHES[0 if ok1 else 1 if ok2 else 2]

    def ref(H, g, eps, method="chol"):
        Hs = 0.5 * (H + H.T)
        I = jnp.eye(Hs.shape[0], dtype=Hs.dtype)
        ridge = eps + 1e-6 * jnp.max(jnp.abs(jnp.diagonal(Hs)))
        ok = [jnp.all(jnp.isfinite(jnp.linalg.cholesky(Hs + k * ridge * I)))
              for k in (1.0, 100.0)]
        jax.debug.callback(lambda a, b: rec["branches_j"].append(
            name(bool(a), bool(b))), *ok)
        return j_inner(H, g, eps, method)

    def port(H, g, eps, method="chol"):
        Hs = 0.5 * (H + H.T)
        I = torch.eye(Hs.shape[0], dtype=Hs.dtype)
        ridge = eps + 1e-6 * torch.max(torch.abs(torch.diagonal(Hs)))
        rec["branches_t"].append(name(*(
            int(torch.linalg.cholesky_ex(Hs + k * ridge * I)[1]) == 0
            for k in (1.0, 100.0))))
        return t_inner(H, g, eps, method)

    mp.setattr(j_marg, "_info_to_sqrt", ref)
    mp.setattr(t_marg, "_info_to_sqrt", port)


def run_port(tcfg, imgs, noise):
    """The port's outputs over the scene's frames (numpy, [n, H, W]) with
    the given RANSAC noise, bootstrapped from the ground truth."""
    n = len(imgs)
    tseq = t_syn.make_synthetic_sequence(
        tcfg, n_frames=n, n_landmarks=60, seed=SEED, frame_dt=1.0 / 30.0,
        traj_kwargs=TRAJ, imu_per_frame=2, device="cpu")
    sys_t = t_pipe.VinsSystem(
        tcfg, ext=tseq.ext, device="cpu", use_loop=False,
        initializer=t_syn.ground_truth_initializer(tseq, tcfg))
    return sys_t.process_stream(
        torch.as_tensor(imgs), tseq.chunks, block=BLOCK,
        ts=tseq.timestamps.numpy(), gumbel=torch.as_tensor(noise))


def run_streams(cfg, tcfg, tpu_branch=False, carry=False, branches=False):
    """(seq, outs_j, outs_t, rec): both systems over N_FRAMES of the
    scene, the port first; with carry the reference goes on from the
    port's bootstrap prior (rec: carry_bootstrap_priors'), with branches
    rec also holds record_branches'. tpu_branch runs the JAX package's TPU
    branch of the tracker (ops/klt.py's _on_tpu, the Pallas kernels in
    interpret mode), only while the JAX system runs."""
    from jax.experimental.pallas import tpu as pltpu
    from vins_tpu.core import feature_manager as j_fm
    from vins_tpu.core.initialization import InitResult, InitStatus
    from vins_tpu.core.state import WindowState as JWindow
    from vins_tpu import pipeline as j_pipe
    from vins_tpu.ops import klt as j_klt

    seq, imgs = render_cached(cfg, n_frames=N_FRAMES, seed=SEED,
                              frame_dt=1.0 / 30.0, traj_kwargs=TRAJ,
                              imu_per_frame=2)
    noise = jax_ransac_noise(0, N_FRAMES, cfg.frontend.f_ransac_hyps,
                             cfg.frontend.max_features)
    Fc = cfg.window.num_frames
    M = cfg.window.max_landmarks

    # --- JAX: ground-truth bootstrap through a patched initializer ------
    sys_j = j_pipe.VinsSystem(cfg, use_loop=False, ext=seq.ext)

    def gt_initialize(feats, chunks, ext, cfg_):
        cur = sys_j.frame_idx - 1
        idx = np.array([cur - cfg.freq * (Fc - 1 - f) for f in range(Fc)])
        win = JWindow(p=seq.p[idx], q=seq.q[idx], v=seq.v[idx],
                      ba=jnp.zeros((Fc, 3)), bg=jnp.zeros((Fc, 3)),
                      inv_depth=jnp.zeros(M))
        return InitResult(j_fm.triangulate(win, feats, ext, cfg_),
                          InitStatus.SUCCESS)

    mp = pytest.MonkeyPatch()
    rec = carry_bootstrap_priors(mp, j_pipe, carry)
    if branches:
        record_branches(mp, rec)
    try:
        outs_t = run_port(tcfg, imgs, noise)
        mp.setattr(j_pipe.init_mod, "initialize", gt_initialize)
        sys_j._refine_init = lambda w, fe, ch: (w, 0.0)
        mode = contextlib.nullcontext()
        if tpu_branch:
            mp.setattr(j_klt, "_on_tpu", lambda: True)
            mode = pltpu.force_tpu_interpret_mode()
        with mode:
            outs_j = sys_j.process_stream(
                jnp.asarray(imgs), seq.chunks, block=BLOCK,
                ts=np.asarray(seq.timestamps))
        jax.effects_barrier()
    finally:
        mp.undo()
    return seq, outs_j, outs_t, rec


def check_per_frame(outs_j, outs_t, min_init=2 * BLOCK + 1, upto=None):
    """Per-frame parity over the bootstrap and two full blocks, with at
    least min_init initialized frames; poses only on frames before upto
    (all by default), decisions on every frame.
    Tolerances: 5e-3 m / 5e-3 rad absorb fp32 solver round-off (the
    backend's conditioned LM solves agree to ~1e-4 m per step; the error
    accumulates over the window's solves); discrete decisions must match
    exactly; n_tracked may differ by 2 for a sub-pixel KLT or Sampson
    threshold that flips under reordered fp32 sums."""
    assert len(outs_j) == len(outs_t) == N_FRAMES
    n_init = 0
    for k, (oj, ot) in enumerate(zip(outs_j, outs_t)):
        assert oj.initialized == ot.initialized, k
        assert oj.is_keyframe == ot.is_keyframe, k
        assert oj.status == ot.status, k
        assert abs(oj.n_tracked - ot.n_tracked) <= 2, (k, oj.n_tracked,
                                                      ot.n_tracked)
        if oj.initialized and (upto is None or k < upto):
            n_init += 1
            np.testing.assert_allclose(ot.p, oj.p, atol=5e-3,
                                       err_msg=f"frame {k}")
            assert _rot_err(np.asarray(oj.q), np.asarray(ot.q)) < 5e-3, k
    assert n_init >= min_init


@pytest.fixture(scope="module")
def streams():
    return run_streams(CFG, TCFG)


def test_torch_stream_matches_jax_per_frame(streams):
    """Per-frame parity over the bootstrap and two full blocks
    (check_per_frame)."""
    _, outs_j, outs_t, _ = streams
    check_per_frame(outs_j, outs_t)


def test_bootstrap_prior_matches_jax_information(streams):
    """The port's bootstrap prior on this scene holds the reference's
    information: JᵀJ to 1e-3 of its largest entry and Jᵀr as
    tests/test_torch_backend.py's _same_information holds a prior; both
    took the 100x-ridge Cholesky."""
    _, _, _, rec = streams

    def normal_eqs(prior):
        J = np.asarray(prior.J, np.float64)
        return J.T @ J, J.T @ np.asarray(prior.r, np.float64)

    Hj, gj = normal_eqs(jax.device_get(rec["j"][0].prior))
    Ht, gt = normal_eqs(interop.to_numpy(rec["t"][0].prior))
    assert np.all(np.isfinite(Hj))
    assert np.abs(Ht - Hj).max() <= 1e-3 * np.abs(Hj).max()
    assert np.abs(gt - gj).max() <= 1e-2 * max(np.abs(gj).max(), 1e-3)


def test_bootstrap_schur_spreads_in_both_packages(streams):
    """A fault of the reference that the port keeps (ROADMAP Queue 3, the
    NaN marginalization prior): the bootstrap's Schur complement H_keep on
    this scene, from the port's bootstrap inputs with the observations
    moved by N(0, 1e-6) in normalized coordinates (2e-4 px, a tenth of
    what the LK early exit at klt_eps = 0.01 moves them). In both
    packages its least eigenvalue spreads over more than 10, and for some
    draw past minus the 100x ridge: there the reference's prior is NaN
    and the port's the eigen fallback, finite in every draw."""
    from vins_tpu.core import estimator as j_est
    from vins_tpu.core import marginalization as j_marg
    from vins_tpu.core.factors import Extrinsics as JExt
    from vins_tpu.core.preintegration import ImuChunk as JChunk
    from vins_tpu.core.state import FeatureTable as JFeats
    from vins_tpu.core.state import WindowState as JWindow
    from vins_tpu_torch.core import estimator as t_est

    _, _, _, rec = streams
    window, feats, chunks, ext, gravity = rec["t_args"][0]
    n = 15 * (F - 1)
    eps = CFG.solver.eig_eps
    sqrt_j, sqrt_t = j_marg._info_to_sqrt, t_marg._info_to_sqrt
    # Each package's prior factorization returns (H_keep, g_keep) as the
    # prior, read back from its top-left block.
    probe = lambda H, g, eps, method="chol": (H, g)
    as_j = lambda T, tree: T(*[jnp.asarray(x)
                               for x in interop.to_numpy(tree)])
    f_np = interop.to_numpy(feats)
    rng = np.random.default_rng(0)
    keeps = dict(j=[], t=[])
    mp = pytest.MonkeyPatch()
    mp.setattr(j_marg, "_info_to_sqrt", probe)
    mp.setattr(t_marg, "_info_to_sqrt", probe)
    try:
        boot_j = jax.jit(lambda w, f, c: j_est.BackendState.bootstrap(
            CFG, w, f, c, as_j(JExt, ext), jnp.asarray(gravity.numpy())))
        for k in range(6):
            obs = f_np.obs + (1e-6 * (k > 0) * rng.standard_normal(
                f_np.obs.shape)).astype(np.float32)
            pj = boot_j(as_j(JWindow, window),
                        JFeats(*[jnp.asarray(x)
                                 for x in f_np._replace(obs=obs)]),
                        as_j(JChunk, chunks)).prior
            pt = t_est.BackendState.bootstrap(
                TCFG, window, feats._replace(obs=torch.as_tensor(obs)),
                chunks, ext, gravity).prior
            keeps["j"].append((pj.J[:n, :n], pj.r[:n]))
            keeps["t"].append((pt.J[:n, :n], pt.r[:n]))
    finally:
        mp.undo()

    def least(H):
        Hs = 0.5 * (H + H.T)
        r100 = 100.0 * (eps + 1e-6 * np.abs(np.diag(Hs)).max())
        return np.linalg.eigvalsh(Hs)[0], r100

    ref = np.array([least(np.asarray(H, np.float64)) for H, _ in keeps["j"]])
    port = np.array([least(H.double().numpy()) for H, _ in keeps["t"]])
    for side in (ref, port):
        assert np.ptp(side[:, 0]) > 10.0, side
        assert np.any(side[:, 0] < -side[:, 1]), side
    past = int(np.argmax(ref[:, 0] < -ref[:, 1]))
    assert not np.all(np.isfinite(np.asarray(sqrt_j(*keeps["j"][past],
                                                    eps)[0])))
    for H, g in keeps["t"]:
        assert all(torch.all(torch.isfinite(x)) for x in sqrt_t(H, g, eps))


def test_torch_stream_tracks_ground_truth(streams):
    """The port's streamed trajectory stays on the ground truth: every
    published pose after bootstrap is finite and the ATE RMSE is under
    the 0.15 m bound tests/test_stream_parity.py uses."""
    seq, _, outs_t, _ = streams
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
