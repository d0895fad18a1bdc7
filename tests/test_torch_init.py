"""Visual-inertial initialization: vins_tpu_torch against vins_tpu.

Each stage is fed the reference's own inputs for that stage, recorded
while the JAX package's `initialize` runs on the SUCCESS window (spies on
its stage functions), so fp32 differences do not compound from stage to
stage. Then `initialize` end to end on three windows of
`make_synthetic_window` (SUCCESS, the low-excitation FAIL_IMU window of
tests/test_initialization.py and its planar scene), and
`refine_init_window`. The essential RANSAC's Gumbel noise is replayed
from the JAX key chain into the port.

The config is the smallest that initializes in the reference: window 10,
128 landmark slots, 8 IMU samples per edge (64 slots give
FAIL_PARALLAX).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vins_tpu.config import VinsConfig, WindowConfig
from vins_tpu.core import initialization as j_init
from vins_tpu.core import preintegration as j_pre
from vins_tpu.io.synthetic import make_synthetic_window
from vins_tpu.ops import ransac as j_ransac
from vins_tpu.utils import lie as j_lie

import vins_tpu_torch.config as tc
from vins_tpu_torch.core import initialization as t_init
from vins_tpu_torch.core import preintegration as t_pre
from vins_tpu_torch.core.factors import Extrinsics
from vins_tpu_torch.core.state import FeatureTable, WindowState
from vins_tpu_torch.ops import ransac as t_ransac

torch.set_num_threads(1)

_WIN = dict(window_size=10, max_landmarks=128, max_imu_per_edge=8)
CFG = VinsConfig(window=WindowConfig(**_WIN))
TCFG = tc.VinsConfig(window=tc.WindowConfig(**_WIN))
F = CFG.window.num_frames
M = CFG.window.max_landmarks


def _t(x, dtype=None):
    out = torch.as_tensor(np.array(x))
    return out if dtype is None else out.to(dtype)


def _tree(cls, tree, dtype=None):
    return cls(*[_t(x, dtype) for x in tree])


def _close(a, b, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol, err_msg=what)


def jax_init_noise(seed=0):
    """[n_hyps, M] Gumbel noise ransac_essential draws from
    PRNGKey(seed) inside initialize (ops/ransac.py:102-107)."""
    keys = jax.random.split(jax.random.PRNGKey(seed),
                            CFG.frontend.f_ransac_hyps)
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (M,)))(keys))


def _planar_feats(syn):
    """tests/test_initialization.py's planar scene: every landmark moved
    onto z = 0.5, the observations rebuilt."""
    lms = np.array(syn.landmarks)
    lms[:, 2] = 0.5
    Rwb = np.asarray(j_lie.quat_to_rotmat(syn.state.q))
    R_ic = np.asarray(j_lie.quat_to_rotmat(syn.ext.qic))
    t_ic = np.asarray(syn.ext.tic)
    obs = np.zeros((F, M, 2), np.float32)
    mask = np.zeros((F, M), bool)
    n = len(lms)
    for f in range(F):
        pb = (lms - np.asarray(syn.state.p[f])) @ Rwb[f]
        pc = (pb - t_ic) @ R_ic
        z = pc[:, 2]
        xy = pc[:, :2] / np.maximum(z[:, None], 1e-6)
        obs[f, :n] = xy
        mask[f, :n] = (z > 0.3) & (np.abs(xy) < 0.7).all(1)
    valid = mask.sum(0) >= 2
    return syn.feats._replace(
        obs=jnp.asarray(obs), mask=jnp.asarray(mask),
        anchor=jnp.asarray(np.argmax(mask, axis=0).astype(np.int32)),
        valid=jnp.asarray(valid),
        track_id=jnp.asarray(np.where(valid, np.arange(M), -1),
                             dtype=jnp.int32))


def _low_excitation_chunks(syn):
    """tests/test_initialization.py's constant-velocity IMU: +g only."""
    W, S = syn.chunks.dt.shape
    return j_pre.ImuChunk(
        dt=syn.chunks.dt,
        acc=jnp.tile(jnp.array([0.0, 0.0, CFG.imu.gravity]), (W, S, 1)),
        gyr=jnp.zeros((W, S, 3)))


@pytest.fixture(scope="module")
def ref():
    """The SUCCESS window, the JAX initialize on it with every stage's
    inputs and outputs recorded, and the reference's refined window."""
    syn = make_synthetic_window(CFG, n_landmarks=128, seed=11)
    rec = {}
    mp = pytest.MonkeyPatch()

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            rec[name] = (args, out)
            return out
        mp.setattr(mod, name, wrapped)

    for name in ("find_reference_frame", "_camera_relative_rotation",
                 "global_sfm", "_solve_gyro_bias_j", "_linear_alignment_j",
                 "_refine_gravity_j"):
        spy(j_init, name)
    for name in ("ransac_essential", "recover_pose"):
        spy(j_ransac, name)
    try:
        res = j_init.initialize(syn.feats, syn.chunks, syn.ext, CFG)
    finally:
        mp.undo()
    assert res.status == j_init.InitStatus.SUCCESS
    refined = j_init.refine_init_window(res.window, syn.feats, syn.chunks,
                                        syn.ext, CFG)
    return dict(syn=syn, rec=rec, res=res, refined=refined)


def _port_inputs(syn, feats=None, chunks=None):
    return (_tree(FeatureTable, syn.feats if feats is None else feats),
            _tree(t_pre.ImuChunk, syn.chunks if chunks is None else chunks),
            _tree(Extrinsics, syn.ext))


def test_find_reference_frame_and_excitation_match_jax(ref):
    """The reference frame and its gate exactly; the excitation statistic
    to 1e-5 relative (fp32 sums over 10 edges); the gyro's camera
    rotation l -> newest to 1e-6."""
    syn, rec = ref["syn"], ref["rec"]
    feats, chunks, ext = _port_inputs(syn)
    l_j, ok_j = rec["find_reference_frame"][1]
    assert t_init.find_reference_frame(feats, CFG.camera.focal) == (l_j,
                                                                    ok_j)
    assert ok_j
    _close(t_init.imu_excitation(chunks, TCFG),
           j_init.imu_excitation(syn.chunks, CFG), 0.0, 1e-5)
    low = _tree(t_pre.ImuChunk, _low_excitation_chunks(syn))
    assert t_init.imu_excitation(low, TCFG) < CFG.init_min_acc_var
    (dq, l, newest, ext_j), R_j = rec["_camera_relative_rotation"]
    R_t = t_init._camera_relative_rotation(_t(dq), int(l), int(newest), ext)
    _close(R_t.numpy(), R_j, 1e-6)


def test_essential_pose_and_known_rotation_match_jax(ref):
    """ransac_essential + recover_pose on the reference's pair with its
    noise: the same inliers and cheirality count, R and t to 1e-5 (unit
    quantities through float32 SVDs; compared as R and t, not U and V).
    translation_known_rotation with the gyro's rotation: the same count,
    t to 1e-5."""
    rec = ref["rec"]
    (p1, p2, valid, key, n_hyps, thresh), res_j = rec["ransac_essential"]
    keys = jax.random.split(key, n_hyps)
    noise = np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (p1.shape[0],)))(keys))
    res_t = t_ransac.ransac_essential(_t(p1), _t(p2), _t(valid), n_hyps,
                                      thresh, gumbel=_t(noise))
    np.testing.assert_array_equal(res_t.inliers.numpy(),
                                  np.asarray(res_j.inliers))
    assert int(res_t.n_inliers) == int(res_j.n_inliers) >= 12
    _close(res_t.model.numpy(), res_j.model, 1e-5)
    s = np.linalg.svd(res_t.model.numpy(), compute_uv=False)
    _close(s, [1.0, 1.0, 0.0], 1e-5)

    args, (R_j, t_j, n_j) = rec["recover_pose"]
    R_t, t_t, n_t = t_ransac.recover_pose(*[_t(a) for a in args])
    assert int(n_t) == int(n_j) >= 12
    _close(R_t.numpy(), R_j, 1e-5)
    _close(t_t.numpy(), t_j, 1e-5)

    R_g = rec["_camera_relative_rotation"][1]
    tk_j, nk_j = j_ransac.translation_known_rotation(R_g, *args[1:])
    tk_t, nk_t = t_ransac.translation_known_rotation(
        _t(R_g), *[_t(a) for a in args[1:]])
    assert int(nk_t) == int(nk_j) >= 12
    _close(tk_t.numpy(), tk_j, 1e-5)


def test_global_sfm_matches_jax(ref):
    """global_sfm on the reference's (feats, l, R_rel, t_rel): the same
    status and triangulated set; poses to 1e-5 and points to 1e-3 in SfM
    units (|t_rel| = 1; the points take the 10 LM steps' fp32 round-off,
    measured 9e-5)."""
    (feats_j, l, R_rel, t_rel, _), (sfm_j, st_j) = ref["rec"]["global_sfm"]
    sfm_t, st_t = t_init.global_sfm(_tree(FeatureTable, feats_j), l,
                                    _t(R_rel), _t(t_rel), TCFG)
    assert st_t.name == st_j.name == "SUCCESS"
    np.testing.assert_array_equal(sfm_t.pts_ok.numpy(),
                                  np.asarray(sfm_j.pts_ok))
    ok = np.asarray(sfm_j.pts_ok)
    assert ok.sum() >= 15
    _close(sfm_t.R_wc.numpy(), sfm_j.R_wc, 1e-5)
    _close(sfm_t.t_wc.numpy(), sfm_j.t_wc, 1e-5)
    _close(sfm_t.pts_w.numpy()[ok], np.asarray(sfm_j.pts_w)[ok], 1e-3)


def test_gyro_bias_matches_jax(ref):
    """solve_gyro_bias on the reference's body rotations and zero-bias
    preintegrations: 1e-6 rad/s. And on the window with a constant gyro
    bias, both recover it (tests/test_initialization.py's bound, 2e-3)."""
    syn = ref["syn"]
    (q_body, pre_j), bg_j = ref["rec"]["_solve_gyro_bias_j"]
    bg_t = t_init.solve_gyro_bias(_t(q_body),
                                  _tree(t_pre.Preintegration, pre_j))
    _close(bg_t.numpy(), bg_j, 1e-6)
    bias = np.array([0.02, -0.01, 0.015], np.float32)
    chunks = syn.chunks._replace(gyr=syn.chunks.gyr + bias[None, None])
    pre0 = jax.vmap(lambda c: j_pre.propagate(
        c, jnp.zeros(3), jnp.zeros(3), CFG.imu))(chunks)
    bg_j = j_init.solve_gyro_bias(syn.state.q, pre0)
    bg_t = t_init.solve_gyro_bias(_t(syn.state.q),
                                  _tree(t_pre.Preintegration, pre0))
    _close(bg_t.numpy(), bg_j, 1e-6)
    _close(bg_t.numpy(), bias, 2e-3)


def _alignment_args(ref, name, dtype=None):
    args, out = ref["rec"][name]
    p_cam, R_body, pre, tic, g_mag = args[:5]
    t_args = (_t(p_cam, dtype), _t(R_body, dtype),
              _tree(t_pre.Preintegration, pre, dtype), _t(tic, dtype), g_mag)
    return args, out, t_args


@pytest.mark.parametrize("name", ["_linear_alignment_j", "_refine_gravity_j"])
def test_alignment_matches_jax(ref, name):
    """linear_alignment and refine_gravity on the reference's inputs.
    In float64 on both sides the port equals the reference to 1e-8
    relative: the same system, the same solve. In float32 the normal
    matrix (1000x weights, the /100 scale column, a 1e-8 ridge below its
    resolution) is conditioned so that the reference's own float32
    solution lies 0.017 m/s (velocity) and 0.9% (scale) from its float64
    one; the port's must agree with the reference's within 0.05 m/s,
    0.05 m/s² and 2% of the scale, and pass the same gates."""
    args, out, t_args = _alignment_args(ref, name)
    fn_t = (t_init.linear_alignment if name == "_linear_alignment_j"
            else t_init.refine_gravity)
    fn_j = (j_init.linear_alignment if name == "_linear_alignment_j"
            else j_init.refine_gravity)
    extra = () if name == "_linear_alignment_j" else (_t(args[5]),)
    got = fn_t(*t_args, *extra)
    _close(got[0].numpy(), out[0], 0.05, what="velocity")
    _close(got[1].numpy(), out[1], 0.05, what="gravity")
    _close(float(got[2]), float(out[2]), 0.0, 0.02, what="scale")
    assert float(got[2]) > 0
    if name == "_linear_alignment_j":
        assert bool(got[3]) and bool(out[3])

    with jax.enable_x64(True):
        to64 = lambda x: jnp.asarray(np.asarray(x), jnp.float64)
        args64 = (to64(args[0]), to64(args[1]), jax.tree.map(to64, args[2]),
                  to64(args[3]), args[4])
        extra64 = () if not extra else (to64(args[5]),)
        ref64 = [np.asarray(x) for x in fn_j(*args64, *extra64)]
    _, _, t64 = _alignment_args(ref, name, torch.float64)
    extra_t64 = () if not extra else (_t(args[5], torch.float64),)
    got64 = fn_t(*t64, *extra_t64)
    for a, b in zip(got64[:3], ref64[:3]):
        _close(a.numpy(), b, 1e-8, 1e-8)


def test_initialize_success_matches_jax(ref):
    """initialize end to end on the SUCCESS window with the reference's
    RANSAC noise: SUCCESS on both sides; window poses to 1e-3 m and 1e-4,
    velocities to 2e-3 m/s, biases to 1e-6, depths to 5e-4 (the float32
    alignment's conditioning carried through the scale; measured 2e-4 m,
    7e-6, 2.4e-4 m/s, 1.7e-7, 5e-5)."""
    syn, res_j = ref["syn"], ref["res"]
    feats, chunks, ext = _port_inputs(syn)
    res_t = t_init.initialize(feats, chunks, ext, TCFG,
                              gumbel=_t(jax_init_noise()))
    assert res_t.status.name == "SUCCESS"
    wj, wt = res_j.window, res_t.window
    _close(wt.p.numpy(), wj.p, 1e-3, what="p")
    _close(wt.q.numpy(), wj.q, 1e-4, what="q")
    _close(wt.v.numpy(), wj.v, 2e-3, what="v")
    _close(wt.ba.numpy(), wj.ba, 1e-6, what="ba")
    _close(wt.bg.numpy(), wj.bg, 1e-6, what="bg")
    _close(wt.inv_depth.numpy(), wj.inv_depth, 5e-4, what="inv_depth")


@pytest.mark.parametrize("window", ["low_excitation", "planar"])
def test_initialize_outcome_matches_jax(ref, window):
    """The FAIL_IMU window and the planar scene: the same status on both
    sides; where the planar window initializes, the same window (the
    tolerances of the SUCCESS case) and a metric geometry under
    tests/test_initialization.py's bounds."""
    syn = ref["syn"]
    if window == "low_excitation":
        syn = make_synthetic_window(CFG, n_landmarks=128, seed=9)
        feats_j, chunks_j = syn.feats, _low_excitation_chunks(syn)
    else:
        syn = make_synthetic_window(CFG, n_landmarks=120, seed=31)
        feats_j, chunks_j = _planar_feats(syn), syn.chunks
    res_j = j_init.initialize(feats_j, chunks_j, syn.ext, CFG)
    feats, chunks, ext = _port_inputs(syn, feats_j, chunks_j)
    res_t = t_init.initialize(feats, chunks, ext, TCFG,
                              gumbel=_t(jax_init_noise()))
    assert res_t.status.name == res_j.status.name
    if window == "low_excitation":
        assert res_t.status.name == "FAIL_IMU"
    if res_t.status.name == "SUCCESS":
        _close(res_t.window.p.numpy(), res_j.window.p, 1e-3)
        _close(res_t.window.q.numpy(), res_j.window.q, 1e-4)
        from vins_tpu.io import evaluate
        a = evaluate.ate_rmse(res_t.window.p.numpy(),
                              np.asarray(syn.state.p))
        assert a.rmse < 0.1, a.rmse


def test_planar_window_takes_the_gyro_rotation(ref):
    """On the planar scene the visual rotation disagrees with the gyro's
    by more than init_max_gyro_visual_deg, in the reference and in the
    port, so both re-seed with translation_known_rotation."""
    syn = make_synthetic_window(CFG, n_landmarks=120, seed=31)
    feats_j = _planar_feats(syn)
    feats, chunks, ext = _port_inputs(syn, feats_j)
    l, ok = t_init.find_reference_frame(feats, CFG.camera.focal)
    assert (l, ok) == j_init.find_reference_frame(feats_j, CFG.camera.focal)
    newest = F - 1
    pair = feats.mask[l] & feats.mask[newest] & feats.valid
    res = t_ransac.ransac_essential(
        feats.obs[l], feats.obs[newest], pair, CFG.frontend.f_ransac_hyps,
        (1.0 / CFG.camera.focal) ** 2 * 9.0, gumbel=_t(jax_init_noise()))
    R_rel, _, _ = t_ransac.recover_pose(res.model, feats.obs[l],
                                        feats.obs[newest], res.inliers)
    pre0 = t_init._propagate_zero_bias(chunks, TCFG)
    R_gyro = t_init._camera_relative_rotation(pre0.dq, l, newest, ext)
    from vins_tpu_torch.utils import lie
    ang = float(torch.linalg.norm(lie.so3_log(lie.rotmat_to_quat(
        R_rel @ R_gyro.T))))
    assert ang > np.deg2rad(CFG.init_max_gyro_visual_deg), ang


def test_refine_init_window_matches_jax(ref):
    """refine_init_window from the reference's initialized window: three
    solve/re-triangulate rounds; the final cost to 1e-4 absolute (it is
    ~3e-6, fp32 round-off of a converged solve) and the window to 1e-3 m,
    1e-4, 2e-3 m/s, 1e-5 and 5e-4 (measured 2e-4 m, 6e-6, 1.9e-4 m/s,
    1.3e-6, 2.8e-5)."""
    syn, res_j = ref["syn"], ref["res"]
    wj, cost_j = ref["refined"]
    feats, chunks, ext = _port_inputs(syn)
    wt, cost_t = t_init.refine_init_window(
        _tree(WindowState, res_j.window), feats, chunks, ext, TCFG)
    assert float(cost_t) <= CFG.init_max_cost
    _close(float(cost_t), float(cost_j), 1e-4)
    _close(wt.p.numpy(), wj.p, 1e-3, what="p")
    _close(wt.q.numpy(), wj.q, 1e-4, what="q")
    _close(wt.v.numpy(), wj.v, 2e-3, what="v")
    _close(wt.ba.numpy(), wj.ba, 1e-5, what="ba")
    _close(wt.bg.numpy(), wj.bg, 1e-5, what="bg")
    _close(wt.inv_depth.numpy(), wj.inv_depth, 5e-4, what="inv_depth")
