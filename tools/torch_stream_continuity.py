"""The port's stream at several LK early-exit thresholds on
tests/test_torch_stream.py's scene, on the CPU: how far each run's poses
lie from the first's, and where the bootstrap prior's Schur complement
sits against the 100x ridge of its factorization.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/torch_stream_continuity.py \
        [--eps 0,1e-6,1e-3,1e-2] [--window 21 --levels 3] [--draws 8]

The scene is the test's: the JAX renderer's frames (192x256 camera, 40
frames of the w = 0.7 circle, seed 5), the JAX tracker's RANSAC noise,
a ground-truth bootstrap, torch on one thread. Prints one JSON line per
klt_eps (the bootstrap H_keep's least eigenvalue and the 100x ridge, the
branch each prior of the run took, and the largest per-frame position
and rotation difference from the first klt_eps's run and from the
ground truth), then with --draws N one line on the bootstrap's Schur
complement from the first run's bootstrap inputs with the observations
moved by N(0, 1e-6) (normalized coordinates) N-1 times: its least
eigenvalue in the JAX package (jitted) and in the port. Run it with
another tree first on PYTHONPATH to measure that tree's port.
"""
import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

from test_torch_stream import (CFG, N_FRAMES, SEED, TCFG, TRAJ,  # noqa: E402
                               _rot_err, jax_ransac_noise)
from vins_tpu.io import synthetic as j_syn  # noqa: E402

from vins_tpu_torch import interop  # noqa: E402
from vins_tpu_torch import pipeline as t_pipe  # noqa: E402
from vins_tpu_torch.core import estimator as t_est  # noqa: E402
from vins_tpu_torch.core import marginalization as t_marg  # noqa: E402
from vins_tpu_torch.io import synthetic as t_syn  # noqa: E402


def _least(H) -> tuple:
    """(least eigenvalue of the symmetric part, the 100x ridge)."""
    Hs = 0.5 * (H + H.T)
    return (float(np.linalg.eigvalsh(Hs)[0]),
            float(100.0 * (CFG.solver.eig_eps
                           + 1e-6 * np.abs(np.diag(Hs)).max())))


def _branch(H) -> str:
    Hs = 0.5 * (H + H.T)
    ridge = CFG.solver.eig_eps + 1e-6 * torch.max(torch.abs(
        torch.diagonal(Hs)))
    I = torch.eye(Hs.shape[0])
    for name, k in (("ridge", 1.0), ("ridge_100x", 100.0)):
        if int(torch.linalg.cholesky_ex(Hs + k * ridge * I)[1]) == 0:
            return name
    return "past_both"


def run(tcfg, imgs, noise):
    """(outputs, [H of each prior], bootstrap arguments) of one stream."""
    seq = t_syn.make_synthetic_sequence(
        tcfg, n_frames=len(imgs), n_landmarks=60, seed=SEED,
        frame_dt=1.0 / 30.0, traj_kwargs=TRAJ, imu_per_frame=2,
        device="cpu")
    priors, boot = [], []
    inner, t_boot = t_marg._info_to_sqrt, t_pipe.BackendState.bootstrap

    def probe(H, g, eps, method="chol"):
        priors.append(H.detach().clone())
        return inner(H, g, eps, method)

    def bootstrap(cfg, *args):
        boot.append(args)
        return t_boot(cfg, *args)

    t_marg._info_to_sqrt = probe
    t_pipe.BackendState.bootstrap = staticmethod(bootstrap)
    try:
        sys_ = t_pipe.VinsSystem(
            tcfg, ext=seq.ext, device="cpu", use_loop=False,
            initializer=t_syn.ground_truth_initializer(seq, tcfg))
        outs = sys_.process_stream(
            torch.as_tensor(imgs), seq.chunks, block=12,
            ts=seq.timestamps.numpy(), gumbel=torch.as_tensor(noise))
    finally:
        t_marg._info_to_sqrt = inner
        t_pipe.BackendState.bootstrap = staticmethod(t_boot)
    return outs, priors, boot[0]


def spread(boot, draws: int) -> dict:
    """The bootstrap's H_keep in both packages over draws of the
    observations (tests/test_torch_stream.py::
    test_bootstrap_schur_spreads_in_both_packages)."""
    from vins_tpu.core import estimator as j_est
    from vins_tpu.core import marginalization as j_marg
    from vins_tpu.core.factors import Extrinsics as JExt
    from vins_tpu.core.preintegration import ImuChunk as JChunk
    from vins_tpu.core.state import FeatureTable as JFeats
    from vins_tpu.core.state import WindowState as JWindow

    window, feats, chunks, ext, gravity = boot
    n = 15 * (CFG.window.num_frames - 1)
    as_j = lambda T, tree: T(*[jnp.asarray(x)
                               for x in interop.to_numpy(tree)])
    probe = lambda H, g, eps, method="chol": (H, g)
    j_inner, t_inner = j_marg._info_to_sqrt, t_marg._info_to_sqrt
    j_marg._info_to_sqrt = t_marg._info_to_sqrt = probe
    f_np = interop.to_numpy(feats)
    rng = np.random.default_rng(0)
    ref, port = [], []
    try:
        boot_j = jax.jit(lambda w, f, c: j_est.BackendState.bootstrap(
            CFG, w, f, c, as_j(JExt, ext), jnp.asarray(gravity.numpy())))
        for k in range(draws):
            obs = f_np.obs + (1e-6 * (k > 0) * rng.standard_normal(
                f_np.obs.shape)).astype(np.float32)
            est_j = boot_j(as_j(JWindow, window),
                           JFeats(*[jnp.asarray(x)
                                    for x in f_np._replace(obs=obs)]),
                           as_j(JChunk, chunks))
            est_t = t_est.BackendState.bootstrap(
                TCFG, window, feats._replace(obs=torch.as_tensor(obs)),
                chunks, ext, gravity)
            ref.append(_least(np.asarray(est_j.prior.J,
                                         np.float64)[:n, :n]))
            port.append(_least(est_t.prior.J.double().numpy()[:n, :n]))
    finally:
        j_marg._info_to_sqrt, t_marg._info_to_sqrt = j_inner, t_inner
    return dict(draws=draws, ridge_100x=ref[0][1],
                reference_least=[round(r[0], 4) for r in ref],
                port_least=[round(p[0], 4) for p in port])


def main(eps_list, window, levels, draws) -> None:
    import dataclasses
    torch.set_num_threads(1)
    seq = j_syn.make_synthetic_sequence(
        CFG, n_frames=N_FRAMES, n_landmarks=60, seed=SEED,
        frame_dt=1.0 / 30.0, traj_kwargs=TRAJ, imu_per_frame=2)
    imgs = np.asarray(j_syn.render_sequence_images(seq, CFG, seed=SEED))
    noise = jax_ransac_noise(0, N_FRAMES, CFG.frontend.f_ransac_hyps,
                             CFG.frontend.max_features)
    p_gt, q_gt = np.asarray(seq.p), np.asarray(seq.q)
    first, boot0 = None, None
    for eps in eps_list:
        tcfg = dataclasses.replace(TCFG, frontend=dataclasses.replace(
            TCFG.frontend, klt_eps=eps, klt_window=window,
            pyramid_levels=levels))
        outs, priors, boot = run(tcfg, imgs, noise)
        if first is None:
            first, boot0 = outs, boot
        live = [k for k, o in enumerate(outs) if o.initialized]
        same = [k for k in live if first[k].initialized]
        least, r100 = _least(priors[0].double().numpy())
        branches = [_branch(H) for H in priors]
        print(json.dumps(dict(
            klt_eps=eps, window=window, levels=levels,
            bootstrap_least=round(least, 4), ridge_100x=round(r100, 4),
            branches={b: branches.count(b) for b in sorted(set(branches))},
            bootstrap_branch=branches[0], initialized=len(live),
            dp_first_m=max(float(np.abs(outs[k].p - first[k].p).max())
                           for k in same),
            drot_first_rad=float(max(_rot_err(np.asarray(outs[k].q),
                                              np.asarray(first[k].q))
                                     for k in same)),
            dp_gt_m=max(float(np.abs(outs[k].p - p_gt[k]).max())
                        for k in live),
            drot_gt_rad=float(max(_rot_err(np.asarray(outs[k].q), q_gt[k])
                                  for k in live)))))
    if draws:
        print(json.dumps(spread(boot0, draws)))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--eps", default="0,1e-6,1e-3,1e-2")
    ap.add_argument("--window", type=int, default=21)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--draws", type=int, default=0)
    a = ap.parse_args()
    main([float(x) for x in a.eps.split(",")], a.window, a.levels, a.draws)
