"""chip_smoke.py's streamed runs on one set of frames for both packages, on
the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/reference_loop_ate.py \
        [jax|port] [N] [--window W --levels L] [--w RATE] [--no-loop] \
        [--tpu-branch] [--klt-eps EPS]

The JAX renderer draws the frames of the sequence chip_smoke.slice_phase
streams (default_config(), n_landmarks 300, seed 7, 30 Hz, 4 IMU samples
a frame; N frames, default 768) on a circle of RATE rad/s (default 0.7,
bench.py's; chip_smoke's loop-off and domain runs take 0.35). "jax" runs
vins_tpu's VinsSystem on them, "port" runs vins_tpu_torch's (device
"cpu"): loop closure on unless --no-loop, the system bootstrapping
itself, then blocks of 48. --window and --levels change only the
frontend's LK window and pyramid depth (chip_smoke.py's phase 11 runs 15
and 5 over 96 frames of the 0.35 circle, loop off), --klt-eps its LK
early-exit threshold (default FrontendConfig's 0.01). --tpu-branch runs
the JAX package's TPU branch of the tracker (ops/klt.py's _on_tpu, the
Pallas kernels in interpret mode), which exits LK early at klt_eps as the
port does; its CPU branch runs every iteration. The port replays the JAX
package's RANSAC noise: the tracker's from its key chain
(tests/test_torch_stream.py's jax_ransac_noise) and the initializer's
essential RANSAC's from its seed-0 key (tests/test_torch_interactive.py).
Prints one JSON line: the init frame, the aligned and raw ATE after it
with and without the drift correction, the pose-graph runs, and how many
marginalization priors took each branch of the prior's factorization
(the ridge Cholesky, the 100x ridge, and past both the port's eigen
fallback or the reference's NaN). On the same frames the two packages'
drift can be compared; the port's renderer draws other image noise, so
its runs on the card cannot.
"""
import argparse
import contextlib
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np

from vins_tpu.config import default_config
from vins_tpu.io import evaluate, synthetic

BRANCHES = ("ridge", "ridge_100x", "past_both")


def _result(outs, p_gt, n_frames, pose_graph_runs) -> dict:
    init_at = next(i for i, o in enumerate(outs) if o.initialized)
    gt = p_gt[init_at:]
    res = dict(frames=n_frames, init_at=init_at,
               statuses=sorted({o.status for o in outs if o.status}),
               pose_graph_runs=pose_graph_runs)
    for key, attr in (("", "p"), ("_uncorrected", "p_raw")):
        est = np.stack([np.asarray(getattr(o, attr))
                        for o in outs[init_at:]])
        res["ate_raw_rmse_m" + key] = float(
            np.sqrt(np.mean(np.sum((est - gt) ** 2, -1))))
        res["ate_rmse_m" + key] = float(evaluate.ate_rmse(est, gt).rmse)
    return res


def _frontend(cfg, window, levels, klt_eps):
    """cfg with only the frontend's LK window, pyramid depth and early
    exit changed (chip_smoke._with_window)."""
    fe = cfg.frontend
    return dataclasses.replace(cfg, frontend=dataclasses.replace(
        fe, klt_window=window or fe.klt_window,
        pyramid_levels=levels or fe.pyramid_levels,
        klt_eps=fe.klt_eps if klt_eps is None else klt_eps))


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


def _count_branches(mod, counts, xp):
    """Wrap mod._info_to_sqrt (either package's) so that each call counts
    the branch its H takes: the ridge Cholesky, the 100x ridge, or
    neither (xp: "jax" counts through a host callback inside the jitted
    scan, "torch" directly)."""
    inner = mod._info_to_sqrt

    def tally(ok1, ok2):
        counts[BRANCHES[0 if ok1 else 1 if ok2 else 2]] += 1

    def wrapped(H, g, eps, method="chol"):
        if xp == "jax":
            Hs = 0.5 * (H + H.T)
            I = jnp.eye(Hs.shape[0], dtype=Hs.dtype)
            ridge = eps + 1e-6 * jnp.max(jnp.abs(jnp.diagonal(Hs)))
            ok = [jnp.all(jnp.isfinite(jnp.linalg.cholesky(Hs + k * ridge
                                                           * I)))
                  for k in (1.0, 100.0)]
            jax.debug.callback(lambda a, b: tally(bool(a), bool(b)), *ok)
        else:
            import torch
            Hs = 0.5 * (H + H.T)
            I = torch.eye(Hs.shape[0], dtype=Hs.dtype)
            ridge = eps + 1e-6 * torch.max(torch.abs(torch.diagonal(Hs)))
            tally(*(int(torch.linalg.cholesky_ex(Hs + k * ridge * I)[1]) == 0
                    for k in (1.0, 100.0)))
        return inner(H, g, eps, method)

    mod._info_to_sqrt = wrapped


def main(which: str, n_frames: int, window=None, levels=None, rate=0.7,
         use_loop=True, tpu_branch=False, klt_eps=None) -> None:
    cfg = _frontend(default_config(), window, levels, klt_eps)
    traj = dict(w=rate, bob=0.15)
    seq = synthetic.make_synthetic_sequence(
        cfg, n_frames=n_frames, n_landmarks=300, seed=7,
        frame_dt=1.0 / 30.0, traj_kwargs=traj, imu_per_frame=4)
    imgs = np.asarray(synthetic.render_sequence_images(seq, cfg, seed=7))
    ts = np.asarray(seq.timestamps)
    counts = dict.fromkeys(BRANCHES, 0)
    if which == "jax":
        from jax.experimental.pallas import tpu as pltpu
        from vins_tpu.core import marginalization as j_marg
        from vins_tpu.ops import klt as j_klt
        from vins_tpu.pipeline import VinsSystem

        _count_branches(j_marg, counts, "jax")
        mode = contextlib.nullcontext()
        if tpu_branch:
            j_klt._on_tpu = lambda: True
            mode = pltpu.force_tpu_interpret_mode()
        sys_ = VinsSystem(cfg, use_loop=use_loop, ext=seq.ext)
        with mode:
            outs = sys_.process_stream(jnp.asarray(imgs), seq.chunks,
                                       block=48, ts=ts)
        jax.effects_barrier()
    else:
        import torch

        from vins_tpu_torch import default_config as t_default_config
        from vins_tpu_torch import pipeline as t_pipe
        from vins_tpu_torch.core import marginalization as t_marg
        from vins_tpu_torch.io import synthetic as t_synthetic

        _count_branches(t_marg, counts, "torch")
        tcfg = _frontend(t_default_config(), window, levels, klt_eps)
        tseq = t_synthetic.make_synthetic_sequence(
            tcfg, n_frames=n_frames, n_landmarks=300, seed=7,
            frame_dt=1.0 / 30.0, traj_kwargs=traj, imu_per_frame=4,
            device="cpu")
        fe = cfg.frontend
        noise = jax_ransac_noise(0, n_frames, fe.f_ransac_hyps,
                                 fe.max_features)
        keys = jax.random.split(jax.random.PRNGKey(0), fe.f_ransac_hyps)
        init_noise = torch.as_tensor(np.array(jax.vmap(
            lambda k: jax.random.gumbel(k, (cfg.window.max_landmarks,)))(
                keys)))
        t_pipe.init_mod.initialize = functools.partial(
            t_pipe.init_mod.initialize, gumbel=init_noise)
        sys_ = t_pipe.VinsSystem(tcfg, ext=tseq.ext, device="cpu",
                                 use_loop=use_loop)
        outs = sys_.process_stream(torch.as_tensor(imgs), tseq.chunks,
                                   block=48, ts=ts,
                                   gumbel=torch.as_tensor(noise))
    runs = sys_.loop.n_optimizes if sys_.loop is not None else None
    res = _result(outs, np.asarray(seq.p), n_frames, runs)
    print(json.dumps(dict(package=which, window=cfg.frontend.klt_window,
                          levels=cfg.frontend.pyramid_levels,
                          klt_eps=cfg.frontend.klt_eps,
                          tpu_branch=tpu_branch if which == "jax" else None,
                          w=rate, loop=use_loop, **res,
                          prior_branches=counts)))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="?", default="jax",
                    choices=("jax", "port"))
    ap.add_argument("frames", nargs="?", type=int, default=768)
    ap.add_argument("--window", type=int)
    ap.add_argument("--levels", type=int)
    ap.add_argument("--w", type=float, default=0.7)
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--tpu-branch", action="store_true")
    ap.add_argument("--klt-eps", type=float)
    a = ap.parse_args()
    main(a.which, a.frames, a.window, a.levels, a.w, not a.no_loop,
         a.tpu_branch, a.klt_eps)
