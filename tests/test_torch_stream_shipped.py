"""The streaming slice at the LK settings the system ships with:
test_torch_stream.py's scene, bootstrap, RANSAC-noise replay and
per-frame checks at FrontendConfig's klt_eps of 0.01 on both sides, the
JAX package on its TPU branch of the tracker (the Pallas kernels in
interpret mode, the early exit at klt_eps that its CPU branch lacks), at
the main path's window and depth (21, 3). The runtime-window point is in
test_torch_stream_shipped_window.py.

The reference goes on from the port's priors (test_torch_stream.
carry_priors): its own bootstrap prior is NaN here
(test_reference_bootstrap_prior_is_nan), its float32 Schur complement
indefinite beyond the 100x ridge, so without the carry every LM step it
takes after the bootstrap is rejected and it publishes its IMU guess
(ROADMAP item 31).

test_port_stream_continuous_in_klt_eps runs the port alone at klt_eps 0,
1e-6, 1e-4 and 0.001, whose tracks differ by under 0.02 px: its
bootstrap prior used to cross the ridge edges of _info_to_sqrt between
them (a fallback without the ridge moved the first backend pose 0.054 m;
the eigen-form Schur complement's round-off then parted the streams by
5.9e-3 m).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_watchdog
from conftest import render_cached
from test_torch_stream import (CFG, N_FRAMES, SEED, TCFG, TRAJ, _rot_err,
                               check_carried_priors, check_per_frame,
                               jax_ransac_noise, run_port, run_streams)
from vins_tpu.config import FrontendConfig

import vins_tpu_torch.config as tc

pytest_plugins = ["torch_watchdog"]

torch.set_num_threads(1)

KLT_EPS = FrontendConfig().klt_eps      # the shipped setting, 0.01


def shipped(win: int, levels: int, eps: float = KLT_EPS):
    """(JAX config, port config) of test_torch_stream.py at klt_eps =
    eps, window win and pyramid depth levels."""
    kw = dict(klt_eps=eps, klt_window=win, pyramid_levels=levels)
    return (dataclasses.replace(
                CFG, frontend=dataclasses.replace(CFG.frontend, **kw)),
            dataclasses.replace(
                TCFG, frontend=dataclasses.replace(TCFG.frontend, **kw)))


def reference_prior_is_nan(rec) -> bool:
    """Whether the reference's own first bootstrap prior has a non-finite
    entry."""
    return not np.all(np.isfinite(np.asarray(jax.device_get(
        rec["j"][0].prior.J))))


@pytest.fixture(scope="module")
def streams(request):
    """Both streams at (21, 3), built once per test run
    (torch_watchdog.once_per_run)."""
    assert KLT_EPS == tc.FrontendConfig().klt_eps == 0.01
    return torch_watchdog.once_per_run(
        request, lambda: run_streams(*shipped(21, 3), tpu_branch=True))


def test_shipped_stream_matches_jax_per_frame(streams):
    """test_torch_stream.py's per-frame checks and bounds (5e-3 m, 5e-3
    rad, equal decisions, n_tracked within 2) at the shipped klt_eps,
    against the JAX package's TPU branch, on every frame; every prior
    carried into the reference holds its own of the same inputs
    (check_carried_priors)."""
    _, outs_j, outs_t, rec = streams
    assert len(rec["t"]) == len(rec["j"]) == 1
    assert len(rec["branches_t"]) >= 9
    check_per_frame(outs_j, outs_t)
    check_carried_priors(rec)


def test_reference_bootstrap_prior_is_nan(streams):
    """The fault of the reference that the carried prior stands in for:
    at the shipped setting its bootstrap prior is NaN on this scene, the
    port's is finite."""
    _, _, _, rec = streams
    assert reference_prior_is_nan(rec)
    assert torch.all(torch.isfinite(rec["t"][0].prior.J))


def test_port_stream_continuous_in_klt_eps():
    """The port alone at klt_eps 0, 1e-6, 1e-4 and 0.001 (tracks under
    0.02 px apart): the same decisions, and each stream within 5e-3 m and
    5e-3 rad of the klt_eps 0 stream on every frame. Each bootstrap prior
    holds every direction (marginalize_old's bootstrap) and each later one
    is formed with the Cholesky-form Schur complement, so no round-off
    picks a branch of _info_to_sqrt: a fallback without the ridge put the
    first backend pose 0.054 m off at 0.001, and the eigen-form Schur
    complement parted the 0 and 1e-6 streams by 5.9e-3 m / 1.04e-2 rad
    (ROADMAP item 31)."""
    _, imgs = render_cached(CFG, n_frames=N_FRAMES, seed=SEED,
                            frame_dt=1.0 / 30.0, traj_kwargs=TRAJ,
                            imu_per_frame=2)
    noise = jax_ransac_noise(0, N_FRAMES, CFG.frontend.f_ransac_hyps,
                             CFG.frontend.max_features)
    runs = {eps: run_port(shipped(21, 3, eps)[1], imgs, noise)
            for eps in (0.0, 1e-6, 1e-4, 1e-3)}
    base = runs[0.0]
    live = [k for k, o in enumerate(base) if o.initialized]
    assert len(live) >= N_FRAMES - 16
    for eps in (1e-6, 1e-4, 1e-3):
        for k, (oa, ob) in enumerate(zip(base, runs[eps])):
            assert (oa.initialized, oa.is_keyframe, oa.status) == \
                (ob.initialized, ob.is_keyframe, ob.status), (eps, k)
        for k in live:
            dp = float(np.abs(runs[eps][k].p - base[k].p).max())
            dr = _rot_err(np.asarray(base[k].q), np.asarray(runs[eps][k].q))
            assert dp < 5e-3 and dr < 5e-3, (eps, k, dp, dr)
