"""The streaming slice end to end: vins_tpu_torch against vins_tpu.

Both systems run VinsSystem(use_loop=False).process_stream from an
uninitialized state on the same rendered frames, bootstrap from ground
truth (the JAX side through a monkeypatched initializer, the port through
io.synthetic.ground_truth_initializer), and then stream two full blocks.
RANSAC noise is replayed from the JAX tracker's key chain into the port.
Both sides use klt_eps = 0: the JAX package's CPU path runs a fixed LK
iteration count, which the port's kernel semantics equal at eps = 0.

The reference goes on from the port's priors (carry_priors). Its own are
its float32 round-off's (ROADMAP item 31): the Schur complement that it
forms with an eigen pseudo-inverse has a bootstrap least eigenvalue that
moves between -5 and -45 under track changes of 2e-4 px, on both sides
of the 100x ridge at 30.1 past which its prior is NaN, and the host's
instruction set picks the side (tools/reference_host_spread.py: the 100x
ridge on an AVX-512 host, NaN with XLA capped at AVX2). The port forms
the complement through a Cholesky factor of the dropped block and holds
its bootstrap prior at the 100x ridge (marginalize_old), and every prior
it carries holds the reference's own of the same inputs, and its Schur
complement the float64 one (check_carried_priors).
"""
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_watchdog
from conftest import render_cached
from vins_tpu.config import (CameraConfig, FrontendConfig, VinsConfig,
                             WindowConfig)

import vins_tpu_torch.config as tc
from vins_tpu_torch import interop
from vins_tpu_torch import pipeline as t_pipe
from vins_tpu_torch.core import marginalization as t_marg
from vins_tpu_torch.io import synthetic as t_syn
from vins_tpu_torch.utils import lie as t_lie

pytest_plugins = ["torch_watchdog"]

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


def port_bootstrap(tcfg, args, boot, dtype=torch.float32):
    """The port's BackendState.bootstrap (boot, as it is before a patch)
    of the reference's bootstrap arguments (window, feats, chunks, ext,
    gravity), through numpy, every float tensor in dtype."""
    from vins_tpu_torch.core.factors import Extrinsics
    from vins_tpu_torch.core.preintegration import ImuChunk
    from vins_tpu_torch.core.state import FeatureTable, WindowState

    as_t = lambda T, tree: T(*[_as_dtype(torch.as_tensor(np.array(x)),
                                         dtype)
                               for x in jax.device_get(tree)])
    window, feats, chunks, ext, gravity = args
    return boot(tcfg, as_t(WindowState, window), as_t(FeatureTable, feats),
                as_t(ImuChunk, chunks), as_t(Extrinsics, ext),
                torch.as_tensor(np.array(gravity)).to(dtype))


def _as_dtype(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype) if torch.is_floating_point(x) else x


def _as_port(tree, dtype=torch.float32):
    """A reference NamedTuple tree (numpy leaves, None kept) as the port's
    types of the same names, every float tensor in dtype."""
    from vins_tpu_torch.core import factors, preintegration, solver, state
    kinds = {T.__name__: T for T in (
        solver.WindowProblem, solver.LoopProblem,
        preintegration.Preintegration, state.PriorFactor, state.FeatureTable,
        state.WindowState, factors.Extrinsics)}
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return kinds[type(tree).__name__](*[_as_port(x, dtype)
                                            for x in tree])
    return _as_dtype(torch.as_tensor(np.array(tree)), dtype)


def _information_gap(t_prior, j_prior) -> tuple:
    """(JᵀJ gap over the reference's largest entry, Jᵀr gap over its
    largest entry or 1e-3) of two priors in float64;
    tests/test_torch_backend.py's _same_information(rtol) holds a prior to
    rtol and 10 rtol of these."""
    Ht, gt = _normal_eqs(t_prior)
    Hj, gj = _normal_eqs(j_prior)
    if not (np.all(np.isfinite(Hj)) and np.all(np.isfinite(gj))):
        return float("nan"), float("nan")
    return (float(np.abs(Ht - Hj).max() / np.abs(Hj).max()),
            float(np.abs(gt - gj).max() / max(np.abs(gj).max(), 1e-3)))


def _np_schur(Arr, Arm, Amm, g_r, g_m):
    """marginalization._schur's complement from its definition, in float64
    numpy and by LU: the dropped block scaled to a unit diagonal and
    ridged at its first ridge there (SCHUR_RIDGES)."""
    Ams = 0.5 * (Amm + Amm.T)
    d = np.diag(Ams)
    s = np.where(d > 0, 1.0 / np.sqrt(np.maximum(d, 1e-300)), 1.0)
    As = Ams * np.outer(s, s) + t_marg.SCHUR_RIDGES[0] * np.eye(len(d))
    X = np.linalg.solve(As, np.concatenate([Arm.T, g_m[:, None]], 1)
                        * s[:, None])
    P = Arm * s[None, :]
    return Arr - P @ X[:, :-1], g_r - P @ X[:, -1]


def _schur_gap(form) -> tuple:
    """(prior, ΔH, ΔH_in, Δg). form(dtype) forms one port prior of the
    reference's inputs with every float in dtype; the float32 prior comes
    back, and its Schur complement (_schur's output) is held against
    _np_schur of the float64 run's _schur inputs: ΔH = max
    |D^-½ (H − H64) D^-½| with D the diagonal of that complement, ΔH_in
    the same with D that of the kept block before the elimination (Arr),
    and Δg = max |D^-½ (g − g64)| over max |D^-½ g64|. The float64 run
    shares the port's assembly of the information, not its elimination."""
    calls, inner = [], t_marg._schur

    def probe(*args):
        out = inner(*args)
        calls.append((args, out))
        return out

    t_marg._schur = probe
    try:
        prior = form(torch.float32)
        form(torch.float64)
    finally:
        t_marg._schur = inner
    (_, (H, g)), (args64, _) = calls
    args64 = [x.numpy() for x in args64]
    H64, g64 = _np_schur(*args64)
    dH, dg = H.double().numpy() - H64, g.double().numpy() - g64

    def scale(d):
        return 1.0 / np.sqrt(np.maximum(d, 1e-12 * d.max()))

    s, s_in = scale(np.diag(H64)), scale(np.diag(args64[0]))
    return (prior, float(np.abs(dH * np.outer(s, s)).max()),
            float(np.abs(dH * np.outer(s_in, s_in)).max()),
            float(np.abs(dg * s).max() / max(np.abs(g64 * s).max(), 1e-12)))


# True while the port forms a prior for the reference (carry_priors):
# record_branches records the port's own priors only.
_CARRYING = [False]


def carry_priors(mp, j_pipe, tcfg):
    """Patch both packages for one lockstep. Both BackendState.bootstraps
    record the states they make (the port its arguments too), and every
    prior the reference forms is the port's of the reference's own
    inputs, in whatever order the two systems run: its bootstrap
    (port_bootstrap) and each marginalization of its backend steps (the
    port's marginalize_old / marginalize_second_new through a host
    callback inside its jitted scan). The reference forms its own prior of
    the same inputs beside each, and rec["carried"] records, prior by
    prior, how far the carried one lies from it (_information_gap;
    check_carried_priors holds them), and whether the system discards it:
    formed in a backend step whose failure detection fired, or after one
    before the next bootstrap (a discarded block).

    Its own are its float32 round-off's (ROADMAP item 31;
    tools/reference_host_spread.py): its eigen-form Schur complement
    leaves the bootstrap's weakest directions anywhere from -5 to -54
    against a 100x ridge of 30, so the host decides whether that prior
    factorizes on the 100x ridge or comes out NaN (and every later one with
    it), and in the later priors it moves the information of the weakest
    (bias) directions enough to part the streams by more than the
    lockstep's bounds (5.7e-3 m 35 frames after test_torch_stream_depth2.
    py's state carry, 5.5e-4 m with the carry). Returns {"t": [port
    states], "t_args": [...], "j": [reference states as its own bootstrap
    made them], "c": [the bootstrap priors carried into it], "carried":
    [(kind, JᵀJ gap, Jᵀr gap, discarded) of every later prior], "schur":
    [(kind, ΔH, ΔH_in, Δg, discarded) of every carried prior, each
    bootstrap's included: its Schur complement against float64,
    _schur_gap]}."""
    from vins_tpu.core import estimator as j_est
    from vins_tpu.core import marginalization as j_marg

    rec = dict(t=[], t_args=[], j=[], c=[], carried=[], schur=[])
    # The failure flag of the backend step being traced, and whether the
    # reference has failed since its last bootstrap.
    fails, failed = [], [False]
    own_failure = j_est._failure_detection

    def failure(*args):
        fails.append(own_failure(*args))
        return fails[-1]

    t_boot = t_pipe.BackendState.bootstrap
    j_boot = j_pipe.BackendState.bootstrap
    own = dict(marginalize_old=j_marg.marginalize_old,
               marginalize_second_new=j_marg.marginalize_second_new)

    def port(cfg, *args):
        est = t_boot(cfg, *args)
        rec["t"].append(est)
        rec["t_args"].append(args)
        return est

    def ref(cfg, *args):
        carried = {k: getattr(j_marg, k) for k in own}
        for k, f in own.items():
            setattr(j_marg, k, f)
        try:
            est = j_boot(cfg, *args)
        finally:
            for k, f in carried.items():
                setattr(j_marg, k, f)
        rec["j"].append(est)
        failed[0] = False
        prior, *gaps = _schur_gap(
            lambda dtype: port_bootstrap(tcfg, args, t_boot, dtype).prior)
        rec["c"].append(prior)
        rec["schur"].append(("bootstrap", *gaps, False))
        return est._replace(prior=type(est.prior)(
            *[jnp.asarray(x) for x in interop.to_numpy(prior)]))

    def carried(kind):
        def marginalize(state, inputs, cfg):
            mine = own[kind](state, inputs, cfg)

            def host(state, inputs, mine, fail):
                _CARRYING[0] = True
                try:
                    prior, *gaps = _schur_gap(
                        lambda dtype: getattr(t_marg, kind)(
                            _as_port(state, dtype), _as_port(inputs, dtype),
                            tcfg))
                finally:
                    _CARRYING[0] = False
                prior = interop.to_numpy(prior)
                failed[0] = failed[0] or bool(fail)
                rec["carried"].append((kind, *_information_gap(prior, mine),
                                       failed[0]))
                rec["schur"].append((kind, *gaps, failed[0]))
                return tuple(prior)

            shapes = tuple(jax.ShapeDtypeStruct(x.shape, x.dtype)
                           for x in mine)
            return type(mine)(*jax.pure_callback(host, shapes, state,
                                                 inputs, mine, fails[-1]))
        return marginalize

    mp.setattr(t_pipe.BackendState, "bootstrap", staticmethod(port))
    mp.setattr(j_pipe.BackendState, "bootstrap", staticmethod(ref))
    mp.setattr(j_est, "_failure_detection", failure)
    for kind in own:
        mp.setattr(j_marg, kind, carried(kind))
    return rec


# The carried priors' Schur complements against float64 (_schur_gap's
# ΔH_in, ΔH, Δg). The largest readings over every lockstep scene, with XLA
# at its default and capped at AVX2 (tools/reference_host_spread.py):
# 2.8e-5, 0.19 and 5.8e-4; the reference's eigen form in _schur reads
# 2.3e-4 to 1.2e-3 ΔH_in and 0.28 to 0.73 ΔH on test_torch_stream.py's
# scene. ΔH is float32's resolution of the accelerometer bias direction:
# on that scene its information in the bootstrap complement, 60, is a
# difference of entries near 1e8 (the bias random walk), each known to 8
# (ΔH 0.13).
SCHUR_IN_TOL, SCHUR_TOL, SCHUR_G_TOL = 1e-4, 0.5, 5e-3


def check_carried_priors(rec):
    """Every later prior carried into the reference that the system keeps
    holds the reference's own prior of the same inputs as
    tests/test_torch_backend.py::test_backend_step_matches_jax holds the
    prior of one backend step (_same_information at 2e-3: JᵀJ to 2e-3 of
    the largest entry, Jᵀr to 2e-2; the largest readings 1.6e-3 and
    2.1e-3): the carry stands in for the reference's round-off, not for a
    fault of the port's marginalization. Priors the system discards (a
    failed step's, a discarded block's) are formed on the predicted,
    unsolved window and are not held to the reference's. The Schur
    complement of every carried prior, the bootstrap's and the discarded
    ones too, holds its float64 value from the same inputs (_schur_gap):
    to SCHUR_IN_TOL of the kept block's own information before the
    elimination, SCHUR_TOL of the complement's, and Jᵀr to SCHUR_G_TOL;
    this hold sees the weak (bias) directions that the information gap,
    relative to the largest entry, does not."""
    kept = [c for c in rec["carried"] if not c[3]]
    assert kept and all(np.isfinite(c[1]) for c in kept), rec["carried"]
    for kind, gap_h, gap_g, _ in kept:
        assert gap_h <= 2e-3 and gap_g <= 2e-2, (kind, gap_h, gap_g)
    assert len(rec["schur"]) == len(rec["carried"]) + len(rec["c"])
    for kind, gap_h, gap_in, gap_g, _ in rec["schur"]:
        assert (gap_in <= SCHUR_IN_TOL and gap_h <= SCHUR_TOL
                and gap_g <= SCHUR_G_TOL), (kind, gap_in, gap_h, gap_g)


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
        if _CARRYING[0]:
            return t_inner(H, g, eps, method)
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


def run_streams(cfg, tcfg, tpu_branch=False):
    """(seq, outs_j, outs_t, rec): both systems over N_FRAMES of the
    scene, the port first, the reference going on from the port's priors
    (rec: carry_priors' and record_branches'). tpu_branch runs the JAX
    package's TPU branch of the tracker (ops/klt.py's _on_tpu, the Pallas
    kernels in interpret mode), only while the JAX system runs."""
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
    rec = carry_priors(mp, j_pipe, tcfg)
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
def streams(request):
    """run_streams' record, built once per test run
    (torch_watchdog.once_per_run)."""
    return torch_watchdog.once_per_run(request,
                                       lambda: run_streams(CFG, TCFG))


def test_torch_stream_matches_jax_per_frame(streams):
    """Per-frame parity over the bootstrap and two full blocks
    (check_per_frame)."""
    _, outs_j, outs_t, rec = streams
    check_per_frame(outs_j, outs_t)
    check_carried_priors(rec)


def float64_bootstrap(tcfg, args):
    """The port's BackendState.bootstrap of the same (port) arguments with
    every float tensor in float64."""
    from vins_tpu_torch.core import estimator as t_est
    dbl = lambda t: type(t)(*[x.double() if torch.is_floating_point(x)
                              else x for x in t])
    window, feats, chunks, ext, gravity = args
    return t_est.BackendState.bootstrap(tcfg, dbl(window), dbl(feats),
                                        dbl(chunks), dbl(ext),
                                        gravity.double())


def _normal_eqs(prior):
    J = np.asarray(prior.J, np.float64)
    return J.T @ J, J.T @ np.asarray(prior.r, np.float64)


def test_bootstrap_prior_matches_jax_information(streams):
    """The port's bootstrap prior on this scene holds JᵀJ to 1e-3 of the
    largest entry and Jᵀr as tests/test_torch_backend.py's
    _same_information holds a prior: against the reference's own prior
    where that is finite and on the port's branch, the 100x ridge (the
    port holds every direction there, marginalize_old's bootstrap); else
    against the port's prior of the same inputs in float64, and the
    reference's took neither ridge and is NaN. Which the reference takes
    is its float32 round-off's: the 100x ridge on an AVX-512 host, NaN
    with XLA capped at AVX2 (tools/reference_host_spread.py)."""
    _, _, _, rec = streams
    Ht, gt = _normal_eqs(interop.to_numpy(rec["t"][0].prior))
    own_j = jax.device_get(rec["j"][0].prior)
    if rec["branches_j"][0] == "ridge_100x":
        Hj, gj = _normal_eqs(own_j)
    else:
        assert rec["branches_j"][0] == "past_both"
        assert not np.all(np.isfinite(np.asarray(own_j.J)))
        Hj, gj = _normal_eqs(interop.to_numpy(float64_bootstrap(
            TCFG, rec["t_args"][0]).prior))
    assert np.all(np.isfinite(Hj))
    assert np.abs(Ht - Hj).max() <= 1e-3 * np.abs(Hj).max()
    assert np.abs(gt - gj).max() <= 1e-2 * max(np.abs(gj).max(), 1e-3)


def test_bootstrap_schur_spreads_in_both_packages(streams):
    """ROADMAP item 31: the bootstrap's Schur complement H_keep on this
    scene, from the port's bootstrap inputs with the observations moved
    by N(0, 1e-6) in normalized coordinates (2e-4 px, a tenth of what the
    LK early exit at klt_eps = 0.01 moves them), 8 draws. The reference's
    eigen-pseudo-inverse form spreads its least eigenvalue over more than
    10, and for some draw past minus the 100x ridge, where its prior is
    NaN. The port's Cholesky form (with the bootstrap hold) stays within
    1e-3 of the largest entry of the same complement formed in float64,
    its least eigenvalue within the ridge of the float64 one, and its
    factorization finite in every draw."""
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
    keeps = dict(j=[], t=[], t64=[])
    mp = pytest.MonkeyPatch()
    mp.setattr(j_marg, "_info_to_sqrt", probe)
    mp.setattr(t_marg, "_info_to_sqrt", probe)
    try:
        boot_j = jax.jit(lambda w, f, c: j_est.BackendState.bootstrap(
            CFG, w, f, c, as_j(JExt, ext), jnp.asarray(gravity.numpy())))
        for k in range(8):
            obs = f_np.obs + (1e-6 * (k > 0) * rng.standard_normal(
                f_np.obs.shape)).astype(np.float32)
            pj = boot_j(as_j(JWindow, window),
                        JFeats(*[jnp.asarray(x)
                                 for x in f_np._replace(obs=obs)]),
                        as_j(JChunk, chunks)).prior
            args = (window, feats._replace(obs=torch.as_tensor(obs)),
                    chunks, ext, gravity)
            pt = t_est.BackendState.bootstrap(TCFG, *args).prior
            p64 = float64_bootstrap(TCFG, args).prior
            keeps["j"].append((pj.J[:n, :n], pj.r[:n]))
            keeps["t"].append((pt.J[:n, :n], pt.r[:n]))
            keeps["t64"].append(p64.J[:n, :n].numpy())
    finally:
        mp.undo()

    def least(H):
        Hs = 0.5 * (H + H.T)
        ridge = eps + 1e-6 * np.abs(np.diag(Hs)).max()
        return np.linalg.eigvalsh(Hs)[0], ridge

    ref = np.array([least(np.asarray(H, np.float64)) for H, _ in keeps["j"]])
    assert np.ptp(ref[:, 0]) > 10.0, ref
    assert np.any(ref[:, 0] < -100.0 * ref[:, 1]), ref
    past = int(np.argmax(ref[:, 0] < -100.0 * ref[:, 1]))
    assert not np.all(np.isfinite(np.asarray(sqrt_j(*keeps["j"][past],
                                                    eps)[0])))
    for (H, g), H64 in zip(keeps["t"], keeps["t64"]):
        H32 = H.double().numpy()
        assert np.abs(H32 - H64).max() <= 1e-3 * np.abs(H64).max()
        (l32, _), (l64, ridge) = least(H32), least(H64)
        assert abs(l32 - l64) <= ridge, (l32, l64, ridge)
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
