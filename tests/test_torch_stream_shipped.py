"""The streaming slice at the LK settings the system ships with:
test_torch_stream.py's scene, bootstrap, RANSAC-noise replay and
per-frame checks at FrontendConfig's klt_eps of 0.01 on both sides, the
JAX package on its TPU branch of the tracker (the Pallas kernels in
interpret mode, the early exit at klt_eps that its CPU branch lacks), at
the main path's window and depth (21, 3). The runtime-window point is in
test_torch_stream_shipped_window.py.

The reference goes on from the port's bootstrap prior
(test_torch_stream.carry_bootstrap_priors): its own is NaN here
(test_reference_bootstrap_prior_is_nan), its float32 Schur complement
indefinite beyond the 100x ridge, so without the carry every LM step it
takes after the bootstrap is rejected and it publishes its IMU guess
(ROADMAP Queue 3, the NaN marginalization prior). The port's is the
eigen fallback of _info_to_sqrt there.

test_port_stream_continuous_in_klt_eps runs the port alone at klt_eps 0,
1e-6 and 0.001, whose tracks differ by under 0.02 px; the last crosses
into that fallback, which before it kept the 100x ridge moved the first
backend pose 0.054 m.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import render_cached
from test_torch_stream import (CFG, N_FRAMES, SEED, TCFG, TRAJ, _rot_err,
                               check_per_frame, jax_ransac_noise,
                               run_port, run_streams)
from vins_tpu.config import FrontendConfig

import vins_tpu_torch.config as tc

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


def parted_at(rec, outs):
    """The first frame whose solve uses a prior that the two packages
    factorized on different branches (test_torch_stream.record_branches),
    or None. The bootstrap prior (call 0) is the port's on both sides;
    call i >= 1 is formed at the i-th backend frame after the bootstrap
    and first used freq frames later."""
    bj, bt = rec["branches_j"], rec["branches_t"]
    boot = next(k for k, o in enumerate(outs) if o.initialized)
    part = next((i for i in range(1, min(len(bj), len(bt)))
                 if bj[i] != bt[i]), None)
    return None if part is None else boot + CFG.freq * (part + 1)


def reference_prior_is_nan(rec) -> bool:
    """Whether the reference's own first bootstrap prior has a non-finite
    entry."""
    return not np.all(np.isfinite(np.asarray(jax.device_get(
        rec["j"][0].prior.J))))


@pytest.fixture(scope="module")
def streams():
    assert KLT_EPS == tc.FrontendConfig().klt_eps == 0.01
    return run_streams(*shipped(21, 3), tpu_branch=True, carry=True,
                       branches=True)


def test_shipped_stream_matches_jax_per_frame(streams):
    """test_torch_stream.py's per-frame checks and bounds (5e-3 m, 5e-3
    rad, equal decisions, n_tracked within 2) at the shipped klt_eps,
    against the JAX package's TPU branch, on every frame: each later
    prior takes the same branch of its factorization in both packages."""
    _, outs_j, outs_t, rec = streams
    assert len(rec["t"]) == len(rec["j"]) == 1
    assert len(rec["branches_j"]) == len(rec["branches_t"]) >= 9
    assert parted_at(rec, outs_t) is None
    check_per_frame(outs_j, outs_t)


def test_reference_bootstrap_prior_is_nan(streams):
    """The fault of the reference that the carried prior stands in for:
    at the shipped setting its bootstrap prior is NaN on this scene, the
    port's is finite."""
    _, _, _, rec = streams
    assert reference_prior_is_nan(rec)
    assert torch.all(torch.isfinite(rec["t"][0].prior.J))


def test_port_stream_continuous_in_klt_eps():
    """The port alone at klt_eps 0, 1e-6 and 1e-4, where the bootstrap
    prior takes the 100x-ridge Cholesky, and 0.001, where it takes the
    eigen fallback (tracks under 0.02 px apart): the same decisions; the
    0.001 stream within 5e-3 m and 5e-3 rad of the 0 stream up to the
    second backend frame, while the bootstrap prior alone holds the
    solves (the fallback without the ridge put the first backend pose
    0.054 m off); and over every frame, crossing into the fallback (0
    against 0.001) moves the poses no more than the bootstrap Schur
    complement's float32 spread moves them on the Cholesky side (0
    against 1e-6 and 1e-4; that spread alone exceeds 5e-3 rad from the
    first backend frame on, test_torch_stream.py::
    test_bootstrap_schur_spreads_in_both_packages)."""
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
    second_backend = live[0] + 2 * CFG.freq

    def gaps(outs):
        """[(frame, position gap m, rotation gap rad)] against base."""
        for k, (oa, ob) in enumerate(zip(base, outs)):
            assert (oa.initialized, oa.is_keyframe, oa.status) == \
                (ob.initialized, ob.is_keyframe, ob.status), k
        return [(k, float(np.abs(outs[k].p - base[k].p).max()),
                 _rot_err(np.asarray(base[k].q), np.asarray(outs[k].q)))
                for k in live]

    near, fall = gaps(runs[1e-6]) + gaps(runs[1e-4]), gaps(runs[1e-3])
    for k, dp, dr in fall:
        if k < second_backend:
            assert dp < 5e-3 and dr < 5e-3, (k, dp, dr)
    assert max(g[1] for g in fall) <= max(g[1] for g in near)
    assert max(g[2] for g in fall) <= max(g[2] for g in near)
