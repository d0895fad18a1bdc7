"""Kernels K1 (pyramidal LK), K2 (patch NCC), K4 (one LK level) and the
fused forward–backward–NCC tracking kernel of vins_tpu_torch against the
JAX package, on the CPU.

The port's CPU path is each kernel's plain PyTorch version
(ops/klt_cuda.track_pyramid_plain, patch_ncc_plain, track_fb_plain). They
are held against the Pallas kernels they replace, run in interpret mode
(klt_pallas.track_pyramid_pallas, patch_ncc_pallas, track_level_pallas,
and the JAX package's TPU branch of klt.track_pyramid_fb that composes
them), at the main path's window (21), iteration count (10), early-exit
eps (0.01) and pyramid depth (3), with border points and dead slots;
tests/test_torch_klt_domain.py holds them at other windows and depths
(11, 15, 16, 31 and up to 5 levels). With eps = 0 the plain version also
equals the JAX package's CPU (XLA) path.
A 3-level pyramid at win 21 needs at least 128 rows at level 0: the
Pallas patch read loads 32 rows on every level (klt_pallas.py:47-48).

The CUDA kernels themselves run only on a card: test_kernels_on_card
compares them with the plain versions there and skips elsewhere.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vins_tpu.config import FrontendConfig
from vins_tpu.ops import image as j_img
from vins_tpu.ops import klt as j_klt
from vins_tpu.ops.klt_pallas import (patch_ncc_pallas, track_level_pallas,
                                     track_pyramid_pallas)

import vins_tpu_torch.config as tc
from vins_tpu_torch.ops import klt as t_klt
from vins_tpu_torch.ops import brief_cuda, klt_cuda

torch.set_num_threads(1)

H, W, L = 128, 160, 3
WIN, ITERS, EPS = 21, 10, 0.01
M = 24

# Flow and NCC agree to float32 round-off of differently ordered sums
# (about 1e-5 px over ten Gauss-Newton updates); 1e-3 px and 1e-4 leave
# room for a slot that stops one iteration apart at the eps test. err is
# a mean of 441 absolute differences: 1e-4.
FLOW_TOL, ERR_TOL, NCC_TOL = 1e-3, 1e-4, 1e-4


def _t(x):
    return torch.as_tensor(np.array(x))


def _make_scene():
    rng = np.random.default_rng(0)
    base = jnp.asarray(rng.uniform(0, 1, (H + 8, W + 8)).astype(np.float32))
    for _ in range(10):     # smooth enough for the coarsest level's basin
        base = j_img.gaussian_blur(base, 2.0)
    base = np.asarray(base)
    base = (base - base.min()) / (base.max() - base.min())
    img0 = base[4:H + 4, 4:W + 4]
    img1 = base[5:H + 5, 2:W + 2]               # shifted by (+2, -1) px
    pj0 = j_img.build_pyramid(jnp.asarray(img0), L)
    pj1 = j_img.build_pyramid(jnp.asarray(img1), L)
    gj0 = [j_img.sobel_gradients(p) for p in pj0]
    gj1 = [j_img.sobel_gradients(p) for p in pj1]
    pts = rng.uniform(0, [W, H], (M, 2)).astype(np.float32)
    pts[:4] = [[0.0, 0.0], [W - 1.0, H - 1.0], [1.5, H - 2.0],
               [W - 3.0, 2.2]]                  # border points
    valid = rng.uniform(0, 1, M) > 0.25
    valid[:4] = True
    valid[4] = False                            # at least one dead slot
    return dict(
        pj0=pj0, pj1=pj1, gj0=gj0, gj1=gj1, pts=pts, valid=valid,
        pt0=[_t(p) for p in pj0], pt1=[_t(p) for p in pj1],
        gt0=[(_t(a), _t(b)) for a, b in gj0],
        gt1=[(_t(a), _t(b)) for a, b in gj1])


@pytest.fixture(scope="module")
def scene():
    return _make_scene()


def _pallas_pyramid(s, direction, init_flow=None, pts=None, valid=None):
    prev, nxt, grads = ((s["pj0"], s["pj1"], s["gj0"]) if direction == "fwd"
                        else (s["pj1"], s["pj0"], s["gj1"]))
    with pltpu.force_tpu_interpret_mode():
        p, ok, err = track_pyramid_pallas(
            prev, grads, nxt, jnp.asarray(pts), jnp.asarray(valid), WIN,
            ITERS, EPS,
            None if init_flow is None else jnp.asarray(init_flow))
    return np.asarray(p), np.asarray(ok), np.asarray(err)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_k1_plain_matches_pallas_kernel(scene, direction):
    """K1's plain version equals _klt_pyramid_kernel: forward from zero
    flow, and the backward pass seeded with the negated forward flow and
    the forward status, as track_pyramid_fb runs them."""
    s = scene
    pts, valid, init = s["pts"], s["valid"], None
    if direction == "bwd":
        p_f, ok_f, _ = _pallas_pyramid(s, "fwd", pts=pts, valid=valid)
        pts, valid, init = p_f, ok_f & valid, s["pts"] - p_f
    p_ref, ok_ref, e_ref = _pallas_pyramid(s, direction, init, pts, valid)

    prev, nxt, grads = ((s["pt0"], s["pt1"], s["gt0"]) if direction == "fwd"
                        else (s["pt1"], s["pt0"], s["gt1"]))
    before = (klt_cuda.track_pyramid.launches, klt_cuda.patch_ncc.launches)
    args = (prev, grads, nxt, _t(pts), _t(valid), WIN, ITERS, EPS,
            None if init is None else _t(init))
    p, ok, err = klt_cuda.track_pyramid_plain(*args)
    # The dispatching wrapper takes the plain version for CPU tensors and
    # counts no kernel launch.
    p_w, ok_w, err_w = klt_cuda.track_pyramid(*args)
    assert torch.equal(p, p_w) and torch.equal(ok, ok_w)
    assert torch.equal(err, err_w)
    assert (klt_cuda.track_pyramid.launches,
            klt_cuda.patch_ncc.launches) == before

    assert np.array_equal(ok.numpy(), ok_ref & valid)
    live = valid
    np.testing.assert_allclose(p.numpy(), p_ref, atol=FLOW_TOL)
    np.testing.assert_allclose(err.numpy()[live], e_ref[live], atol=ERR_TOL)
    # Dead input slots skip every level's loop: they keep their seed flow
    # (doubled back up from the coarsest level) and err 0.
    seed = np.zeros_like(pts) if init is None else init
    np.testing.assert_array_equal(p.numpy()[~live], (pts + seed)[~live])
    assert np.all(err.numpy()[~live] == 0.0)
    assert ok.numpy().sum() >= 8   # the scene does track


def test_k2_plain_matches_pallas_kernel(scene):
    """K2's plain version equals _ncc_kernel on the forward result,
    including clamped border patches."""
    s = scene
    p_f, _, _ = _pallas_pyramid(s, "fwd", pts=s["pts"], valid=s["valid"])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(patch_ncc_pallas(s["pj0"][0], s["pj1"][0],
                                          jnp.asarray(s["pts"]),
                                          jnp.asarray(p_f), WIN))
    args = (s["pt0"][0], s["pt1"][0], _t(s["pts"]), _t(p_f), WIN)
    out = klt_cuda.patch_ncc_plain(*args)
    assert torch.equal(out, klt_cuda.patch_ncc(*args))
    np.testing.assert_allclose(out.numpy(), ref, atol=NCC_TOL)
    assert np.all(np.isfinite(out.numpy()))


def test_k1_plain_at_eps0_matches_xla_path(scene):
    """With eps = 0 every live slot runs all iterations, which is the JAX
    package's CPU path (klt._track_level's fixed fori_loop)."""
    s = scene
    cfg = FrontendConfig(klt_eps=0.0)
    ref = j_klt.track_pyramid(s["pj0"], s["pj1"], jnp.asarray(s["pts"]),
                              jnp.asarray(s["valid"]), cfg,
                              grads_prev=s["gj0"])
    tcfg = tc.FrontendConfig(klt_eps=0.0)
    out = t_klt.track_pyramid(s["pt0"], s["pt1"], _t(s["pts"]),
                              _t(s["valid"]), tcfg, grads_prev=s["gt0"])
    live = s["valid"]
    assert np.array_equal(out.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(out.pts.numpy()[live],
                               np.asarray(ref.pts)[live], atol=FLOW_TOL)
    np.testing.assert_allclose(out.err.numpy()[live],
                               np.asarray(ref.err)[live], atol=ERR_TOL)


def test_track_pyramid_fb_matches_jax(scene):
    """Forward-backward tracking with the NCC gate, end to end, against
    klt.track_pyramid_fb (JAX's CPU path, so eps = 0 on both sides)."""
    s = scene
    ref = j_klt.track_pyramid_fb(
        s["pj0"], s["pj1"], jnp.asarray(s["pts"]), jnp.asarray(s["valid"]),
        FrontendConfig(klt_eps=0.0), grads_prev=s["gj0"],
        grads_next=s["gj1"])
    out = t_klt.track_pyramid_fb(
        s["pt0"], s["pt1"], _t(s["pts"]), _t(s["valid"]),
        tc.FrontendConfig(klt_eps=0.0), grads_prev=s["gt0"],
        grads_next=s["gt1"])
    ok = np.asarray(ref.status)
    assert np.array_equal(out.status.numpy(), ok)
    assert ok.sum() >= 8
    np.testing.assert_allclose(out.pts.numpy()[ok], np.asarray(ref.pts)[ok],
                               atol=FLOW_TOL)
    # err is the round-trip distance, a difference of two tracked points.
    np.testing.assert_allclose(out.err.numpy()[ok], np.asarray(ref.err)[ok],
                               atol=2 * FLOW_TOL)


def test_track_fb_plain_matches_tpu_branch(scene, monkeypatch):
    """The fused kernel's plain version equals the JAX package's TPU
    branch of track_pyramid_fb (klt.py:171-203: track_pyramid_pallas
    forward, the post-filter of :147-154, the backward pass, then
    patch_ncc_pallas and the gate of :203), run in interpret mode at
    klt_eps = 0.01."""
    s = scene
    monkeypatch.setattr(j_klt, "_on_tpu", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        ref = j_klt.track_pyramid_fb(
            s["pj0"], s["pj1"], jnp.asarray(s["pts"]),
            jnp.asarray(s["valid"]), FrontendConfig(klt_eps=EPS),
            grads_prev=s["gj0"], grads_next=s["gj1"])
    args = (s["pt0"], s["gt0"], s["pt1"], s["gt1"], _t(s["pts"]),
            _t(s["valid"]), WIN, ITERS, EPS, 0.3, t_klt.NCC_MIN)
    pts, status, err, ncc = klt_cuda.track_fb_plain(*args)
    ok = np.asarray(ref.status)
    assert np.array_equal(status.numpy(), ok)
    assert ok.sum() >= 4
    np.testing.assert_allclose(pts.numpy(), np.asarray(ref.pts),
                               atol=FLOW_TOL)
    np.testing.assert_allclose(err.numpy()[ok], np.asarray(ref.err)[ok],
                               atol=2 * FLOW_TOL)
    assert np.all(np.isfinite(ncc.numpy()))
    # The dispatching wrapper takes the plain version for CPU tensors and
    # counts no launch.
    before = klt_cuda.track_fb.launches
    out = klt_cuda.track_fb(*args)
    for a, b in zip(out, (pts, status, err, ncc)):
        assert torch.equal(a, b)
    assert klt_cuda.track_fb.launches == before


@pytest.mark.parametrize("given_grads", [True, False])
def test_track_pyramid_fb_equals_old_composition(scene, given_grads):
    """ops/klt.track_pyramid_fb through the fused wrapper equals, bit for
    bit, the composition it ran before: K1 forward and backward through
    ops/klt.track_pyramid (post-filters included), K2 on the forward
    result, and the gate. Without gradients both compute them."""
    s = scene
    cfg = tc.FrontendConfig()
    pts, valid = _t(s["pts"]), _t(s["valid"])
    g0 = s["gt0"] if given_grads else None
    g1 = s["gt1"] if given_grads else None
    counts = lambda: (klt_cuda.track_fb.launches,
                      klt_cuda.track_pyramid.launches,
                      klt_cuda.patch_ncc.launches)
    before = counts()
    out = t_klt.track_pyramid_fb(s["pt0"], s["pt1"], pts, valid, cfg,
                                 grads_prev=g0, grads_next=g1)
    assert counts() == before
    fwd = t_klt.track_pyramid(s["pt0"], s["pt1"], pts, valid, cfg,
                              grads_prev=g0)
    bwd = t_klt.track_pyramid(s["pt1"], s["pt0"], fwd.pts, fwd.status, cfg,
                              init_flow=pts - fwd.pts, grads_prev=g1)
    d = bwd.pts - pts
    rt = torch.sqrt(torch.sum(d * d, -1))
    ncc = klt_cuda.patch_ncc(s["pt0"][0], s["pt1"][0], pts, fwd.pts, WIN)
    ok = fwd.status & bwd.status & (rt < 0.3) & (ncc > 0.5)
    assert torch.equal(out.pts, fwd.pts)
    assert torch.equal(out.status, ok)
    assert torch.equal(out.err, rt)
    assert int(ok.sum()) >= 4


def test_k4_is_k1_at_one_level(scene):
    """K4 (track_level_pallas: one level, arbitrary per-slot guess) is K1's
    computation at L = 1: the plain version's single-level entry point
    equals it, early exit and dead slots included."""
    s = scene
    rng = np.random.default_rng(1)
    guess = rng.uniform(-2, 2, (M, 2)).astype(np.float32)
    gx, gy = s["gj0"][0]
    with pltpu.force_tpu_interpret_mode():
        f_ref, ok_ref, e_ref = track_level_pallas(
            s["pj0"][0], gx, gy, s["pj1"][0], jnp.asarray(s["pts"]),
            jnp.asarray(guess), jnp.asarray(s["valid"]), WIN, ITERS, EPS)
    flow, ok, err = klt_cuda.track_level_plain(
        s["pt0"][0], s["gt0"][0][0], s["gt0"][0][1], s["pt1"][0],
        _t(s["pts"]), _t(guess), _t(s["valid"]), WIN, ITERS, EPS)
    live = s["valid"]
    assert np.array_equal(ok.numpy(), np.asarray(ok_ref))
    np.testing.assert_allclose(flow.numpy(), np.asarray(f_ref),
                               atol=FLOW_TOL)
    np.testing.assert_allclose(err.numpy()[live], np.asarray(e_ref)[live],
                               atol=ERR_TOL)
    # K4's wrapper takes that plain version for CPU tensors.
    out = klt_cuda.track_level(
        s["pt0"][0], s["gt0"][0][0], s["gt0"][0][1], s["pt1"][0],
        _t(s["pts"]), _t(guess), _t(s["valid"]), WIN, ITERS, EPS)
    for a, b in zip(out, (flow, ok, err)):
        assert torch.equal(a, b)


def test_wrappers_refuse_other_devices(scene):
    """Dispatch is on the tensor's device: CPU takes the plain version,
    CUDA the kernel, and any other device raises instead of falling
    back."""
    s = scene
    meta = lambda x: x.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        klt_cuda.track_pyramid(s["pt0"], s["gt0"], s["pt1"],
                               meta(_t(s["pts"])), meta(_t(s["valid"])),
                               WIN, ITERS, EPS)
    with pytest.raises(ValueError, match="unsupported device"):
        klt_cuda.patch_ncc(s["pt0"][0], s["pt1"][0], meta(_t(s["pts"])),
                           meta(_t(s["pts"])), WIN)
    pts = meta(_t(s["pts"]))
    with pytest.raises(ValueError, match="unsupported device"):
        klt_cuda.track_level(s["pt0"][0], s["gt0"][0][0], s["gt0"][0][1],
                             s["pt1"][0], pts, pts, meta(_t(s["valid"])),
                             WIN, ITERS, EPS)
    with pytest.raises(ValueError, match="unsupported device"):
        klt_cuda.track_fb(s["pt0"], s["gt0"], s["pt1"], s["gt1"], pts,
                          meta(_t(s["valid"])), WIN, ITERS, EPS, 0.3, 0.5)
    with pytest.raises(ValueError, match="unsupported device"):
        brief_cuda.extract_brief_words(s["pt0"][0], pts,
                                       meta(_t(s["valid"])),
                                       meta(torch.zeros((256, 4),
                                                        dtype=torch.int32)))


@pytest.mark.gpu
def test_kernels_on_card(scene):
    """On a CUDA card: the fused tracking kernel, K1, K2 and K4 launch,
    count their launches, and agree with their plain versions on the same
    device (chip_smoke.py runs the same check at the main path's full
    shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    s = scene
    dev = torch.device("cuda", 0)
    cu = lambda x: x.to(dev)
    prev = [cu(p) for p in s["pt0"]]
    nxt = [cu(p) for p in s["pt1"]]
    grads = [(cu(a), cu(b)) for a, b in s["gt0"]]
    pts, valid = cu(_t(s["pts"])), cu(_t(s["valid"]))
    n1, n2 = klt_cuda.track_pyramid.launches, klt_cuda.patch_ncc.launches
    p_k, ok_k, e_k = klt_cuda.track_pyramid(prev, grads, nxt, pts, valid,
                                            WIN, ITERS, EPS)
    ncc_k = klt_cuda.patch_ncc(prev[0], nxt[0], pts, p_k, WIN)
    torch.cuda.synchronize()
    assert klt_cuda.track_pyramid.launches == n1 + 1
    assert klt_cuda.patch_ncc.launches == n2 + 1
    p_p, ok_p, e_p = klt_cuda.track_pyramid_plain(prev, grads, nxt, pts,
                                                  valid, WIN, ITERS, EPS)
    ncc_p = klt_cuda.patch_ncc_plain(prev[0], nxt[0], pts, p_k, WIN)
    assert torch.equal(ok_k, ok_p)
    assert float((p_k - p_p).abs().max()) <= FLOW_TOL
    assert float((e_k - e_p).abs().max()) <= ERR_TOL
    assert float((ncc_k - ncc_p).abs().max()) <= NCC_TOL
    guess = (0.5 * (p_k - pts)).contiguous()
    lvl = (prev[0], grads[0][0], grads[0][1], nxt[0], pts, guess, valid,
           WIN, ITERS, EPS)
    n4 = klt_cuda.track_level.launches
    f_k, ok4_k, _ = klt_cuda.track_level(*lvl)
    torch.cuda.synchronize()
    assert klt_cuda.track_level.launches == n4 + 1
    f_p, ok4_p, _ = klt_cuda.track_level_plain(*lvl)
    assert torch.equal(ok4_k, ok4_p)
    both = ok4_k & ok4_p
    assert float((f_k - f_p)[both].abs().max()) <= FLOW_TOL
    grads1 = [(cu(a), cu(b)) for a, b in s["gt1"]]
    fb = (prev, grads, nxt, grads1, pts, valid, WIN, ITERS, EPS, 0.3, 0.5)
    n_fb = klt_cuda.track_fb.launches
    q_k, st_k, rt_k, ncc_fb_k = klt_cuda.track_fb(*fb)
    torch.cuda.synchronize()
    assert klt_cuda.track_fb.launches == n_fb + 1
    assert klt_cuda.track_pyramid.launches == n1 + 1
    assert klt_cuda.patch_ncc.launches == n2 + 1
    q_p, st_p, rt_p, ncc_fb_p = klt_cuda.track_fb_plain(*fb)
    assert torch.equal(st_k, st_p)
    kept = st_k & st_p
    assert float((q_k - q_p)[kept].abs().max()) <= FLOW_TOL
    assert float((rt_k - rt_p)[kept].abs().max()) <= 2 * FLOW_TOL
    assert float((ncc_fb_k - ncc_fb_p).abs().max()) <= NCC_TOL


def test_port_frontend_config_defaults_reach_the_kernel():
    """The main path calls K1 with the config's window, iterations and eps
    (the defaults: the 21x21 window the kernels' specialization is
    compiled for)."""
    fe = tc.FrontendConfig()
    assert (fe.klt_window, fe.klt_iters, fe.klt_eps) == (WIN, ITERS, EPS)
    assert fe.pyramid_levels == L
    assert dataclasses.asdict(fe) == dataclasses.asdict(FrontendConfig())
