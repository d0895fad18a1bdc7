"""The streaming slice at the shipped settings on the card, held to the same
stream on the CPU: default_config() (640x480, window 10, the shipped
klt_eps of 0.01), 55 frames of the w = 0.35 circle rendered by the port's
own renderer, a ground-truth bootstrap, the same RANSAC noise on both
devices (Gumbel draws from one seeded torch generator), and
test_torch_stream.py's per-frame bounds. As in the lockstep at the
shipped setting (test_torch_stream_shipped.py), the card's stream goes
on from the CPU's bootstrap prior, and poses are compared up to the
first solve that uses a prior the two devices factorized on different
branches. Not on test_torch_stream.py's 192x256 window-5 scene: there the
eigen-form Schur complement that the port had until ROADMAP item 31 was
repaired moved the prior's weakest directions far enough to part an
H100's stream from the CPU's by 8.3e-3 m in 40 frames with every prior
on the same branch.
Imports no JAX: chip_smoke.py's phase 12 runs it on the card with the
other gpu cases (chip_smoke.CARD_TEST_FILES); elsewhere it skips.
test_bootstrap_schur_matches_float64 holds the bootstrap's Schur
complement to its float64 value, on the CPU and on the card."""
import os

import numpy as np
import pytest
import torch

import vins_tpu_torch.config as tc
from vins_tpu_torch import pipeline as t_pipe
from vins_tpu_torch.core import marginalization as t_marg
from vins_tpu_torch.io import synthetic as t_syn

pytest_plugins = ["torch_watchdog"]

TCFG = tc.default_config()
BLOCK = 12
BOOT = TCFG.freq * (TCFG.window.num_frames - 1) + 1
N_FRAMES = BOOT + 2 * BLOCK
TRAJ = dict(w=0.35, bob=0.15)
SEED = 7


def _rot_err(qa, qb):
    """Angle (rad) between two wxyz quaternions."""
    d = abs(float(np.dot(qa, qb)) / (np.linalg.norm(qa) * np.linalg.norm(qb)))
    return 2.0 * np.arccos(min(d, 1.0))


def _branch(H: torch.Tensor, eps: float) -> int:
    """0, 1 or 2: H's prior takes the ridge Cholesky, the 100x ridge or
    the eigen fallback in _info_to_sqrt."""
    Hs = 0.5 * (H + H.T)
    I = torch.eye(Hs.shape[0], dtype=Hs.dtype, device=Hs.device)
    ridge = eps + 1e-6 * torch.max(torch.abs(torch.diagonal(Hs)))
    for k, scale in enumerate((1.0, 100.0)):
        if int(torch.linalg.cholesky_ex(Hs + scale * ridge * I)[1]) == 0:
            return k
    return 2


def _stream(device, imgs, noise, prior=None):
    """(outputs, [bootstrap priors], [each prior's branch]) of the stream
    on `device`; with `prior` it goes on from that bootstrap prior instead
    of its own."""
    boot, sqrt = t_pipe.BackendState.bootstrap, t_marg._info_to_sqrt
    made, branches = [], []

    def recorded(H, g, eps, method="chol"):
        branches.append(_branch(H, eps))
        return sqrt(H, g, eps, method)

    def bootstrap(cfg, *args):
        est = boot(cfg, *args)
        made.append(est.prior)
        if prior is not None:
            est = est._replace(prior=type(prior)(
                *[x.to(est.prior.J.device) for x in prior]))
        return est

    seq = t_syn.make_synthetic_sequence(
        TCFG, n_frames=N_FRAMES, n_landmarks=300, seed=SEED,
        frame_dt=1.0 / 30.0, traj_kwargs=TRAJ, imu_per_frame=4,
        device=device)
    sys_ = t_pipe.VinsSystem(
        TCFG, ext=seq.ext, device=device, use_loop=False,
        initializer=t_syn.ground_truth_initializer(seq, TCFG))
    t_pipe.BackendState.bootstrap = staticmethod(bootstrap)
    t_marg._info_to_sqrt = recorded
    try:
        outs = sys_.process_stream(
            imgs.to(device), seq.chunks, block=BLOCK,
            ts=seq.timestamps.cpu().numpy(), gumbel=noise.to(device))
    finally:
        t_pipe.BackendState.bootstrap = staticmethod(boot)
        t_marg._info_to_sqrt = sqrt
    return outs, made, branches


@pytest.mark.gpu
def test_stream_on_card_matches_cpu():
    """klt_eps = 0.01 (FrontendConfig's default): the card's stream,
    tracking through the fused klt_fb_ncc kernel, against the CPU's
    through its plain version, from the CPU's bootstrap prior. Equal
    decisions and n_tracked within 2 on every frame; every pose within
    5e-3 m and 5e-3 rad up to the first solve that uses a prior the two
    devices factorized on different branches of _info_to_sqrt, at least
    the bootstrap and the first backend frame's block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tracking kernel has no CPU mode")
    assert TCFG.frontend.klt_eps == 0.01
    seq = t_syn.make_synthetic_sequence(
        TCFG, n_frames=N_FRAMES, n_landmarks=300, seed=SEED,
        frame_dt=1.0 / 30.0, traj_kwargs=TRAJ, imu_per_frame=4,
        device="cpu")
    imgs = t_syn.render_sequence_images(seq, TCFG, seed=SEED, device="cpu")
    gen = torch.Generator().manual_seed(0)
    u = torch.rand((N_FRAMES, TCFG.frontend.f_ransac_hyps,
                    TCFG.frontend.max_features), generator=gen)
    noise = -torch.log(-torch.log(u.clamp(1e-12, 1.0 - 1e-7)))
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    outs_c, made, br_c = _stream("cpu", imgs, noise)
    assert len(made) == 1
    outs_g, _, br_g = _stream(torch.device("cuda", 0), imgs, noise, made[0])
    assert len(outs_c) == len(outs_g) == N_FRAMES
    boot = next(k for k, o in enumerate(outs_c) if o.initialized)
    part = next((i for i in range(1, min(len(br_c), len(br_g)))
                 if br_c[i] != br_g[i]), None)
    upto = N_FRAMES if part is None else boot + TCFG.freq * (part + 1)
    dp, dr = [], []
    for k, (oc, og) in enumerate(zip(outs_c, outs_g)):
        assert (oc.initialized, oc.is_keyframe, oc.status) == \
            (og.initialized, og.is_keyframe, og.status), k
        assert abs(oc.n_tracked - og.n_tracked) <= 2, k
        if oc.initialized and k < upto:
            np.testing.assert_allclose(og.p, oc.p, atol=5e-3,
                                       err_msg=f"frame {k}")
            dr.append(_rot_err(np.asarray(oc.q), np.asarray(og.q)))
            assert dr[-1] < 5e-3, k
            dp.append(float(np.abs(og.p - oc.p).max()))
    assert len(dp) >= 2 * TCFG.freq
    print(f"card against CPU over {len(dp)} initialized frames (to frame "
          f"{upto}; prior branches CPU {br_c}, card {br_g}): largest "
          f"position difference {max(dp):.3g} m, rotation {max(dr):.3g} "
          f"rad")


def _phase9_window():
    """chip_smoke.py phase 9's first stream's window: make_synthetic_window
    at default_config(), seed 0, 300 landmarks, 0.3 px noise."""
    return t_syn.make_synthetic_window(TCFG, n_landmarks=300, seed=0,
                                       noise_px=0.3, device="cpu")


def _bootstrap_keep(device, dtype, obs):
    """The bootstrap's kept information H_keep (as _info_to_sqrt receives
    it, the hold included) of _phase9_window with its observations
    replaced by obs, on device in dtype, as float64 numpy."""
    from vins_tpu_torch.core.estimator import BackendState
    w = _phase9_window()
    cast = lambda t: type(t)(*[(x.to(dtype) if torch.is_floating_point(x)
                                else x).to(device) for x in t])
    feats = w.feats._replace(obs=obs)
    keep, sqrt = [], t_marg._info_to_sqrt
    t_marg._info_to_sqrt = lambda H, g, eps, method="chol": keep.append(
        H.detach().double().cpu().numpy()) or sqrt(H, g, eps, method)
    try:
        BackendState.bootstrap(TCFG, cast(w.state), cast(feats),
                               cast(w.chunks), cast(w.ext),
                               w.gravity.to(dtype).to(device))
    finally:
        t_marg._info_to_sqrt = sqrt
    return keep[0]


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_bootstrap_schur_matches_float64(device):
    """ROADMAP item 31: the bootstrap's Schur complement, formed through
    the Cholesky factor of the dropped block (marginalization._schur), in
    float32 on the device against the same inputs in float64 on the CPU,
    with the observations moved by N(0, 1e-6) in normalized coordinates
    (2e-4 px) in 8 draws: within 1e-3 of the float64 complement's largest
    entry, its least eigenvalue within the ridge of the float64 one (the
    reference's eigen pseudo-inverse spreads it by tens on such draws,
    tests/test_torch_stream.py::
    test_bootstrap_schur_spreads_in_both_packages)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device(device, 0) if device == "cuda" else device
    eps = TCFG.solver.eig_eps
    rng = np.random.default_rng(0)
    obs0 = _phase9_window().feats.obs
    least = lambda H: np.linalg.eigvalsh(0.5 * (H + H.T))[0]
    for k in range(8):
        obs = obs0 + torch.as_tensor(
            (1e-6 * (k > 0) * rng.standard_normal(obs0.shape)).astype(
                np.float32))
        H32 = _bootstrap_keep(dev, torch.float32, obs)
        H64 = _bootstrap_keep("cpu", torch.float64, obs)
        ridge = eps + 1e-6 * np.abs(np.diag(H64)).max()
        assert np.abs(H32 - H64).max() <= 1e-3 * np.abs(H64).max(), k
        assert abs(least(H32) - least(H64)) <= ridge, (k, least(H32),
                                                       least(H64), ridge)
