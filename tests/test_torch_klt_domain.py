"""The tracking kernels at every window and depth the Pallas kernels take:
the plain versions of K1, K4, K2, the fused forward-backward-NCC kernel
and K3's patches against the Pallas kernels in interpret mode, on the CPU,
away from the main path's 21x21 window and 3 levels (tests/test_torch_klt
holds that point).

The Pallas read loads ((win+1+7)//8)*8 + 8 rows on every level
(klt_pallas.py:47-48), so 5 levels at win 15 need 384 rows at level 0;
the other points run on 96x128 frames. Points include border points and
dead slots. The CUDA wrappers take windows 1..128 and any depth whose
levels hold the window plus its bilinear border: their domain checks are
tested here as pure functions, the kernels themselves on a card
(test_runtime_window_kernels_on_card, skipped without one).
"""
import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vins_tpu_torch.ops import brief_cuda, klt, klt_cuda
from vins_tpu_torch.ops import image as t_img

pytest_plugins = ["torch_watchdog"]

torch.set_num_threads(1)

ITERS, EPS = 10, 0.01
M = 20
# (win, levels) points away from the main path's (21, 3), and the frame
# each needs.
POINTS = [(11, 2), (15, 5), (16, 2), (31, 2)]
SHAPE = {5: (384, 320), 2: (96, 128)}

# As tests/test_torch_klt.py: flow and NCC agree to float32 round-off of
# differently ordered sums; 1e-3 px and 1e-4 leave room for a slot that
# stops one iteration apart at the eps test; err is a mean of win^2
# absolute differences: 1e-4.
FLOW_TOL, ERR_TOL, NCC_TOL = 1e-3, 1e-4, 1e-4
# A slot that runs all ITERS updates at level 0 has not converged: the
# Pallas kernel and the port's plain version differ there by up to
# 1.16e-3 px (test_k1_unconverged_slots_spread_in_the_reference). Such
# slots are held to about four times that spread, the others to FLOW_TOL.
FLOW_TOL_UNCONVERGED = 5e-3
# The card's points past POINTS: the runtime-window variant's plan
# boundaries (template taps a thread 1 | 2 at win 16 | 17, 2 | 4 at
# 22 | 23, 4 | 8 at 32 | 33, 8 | 16 at 45 | 46, registers | shared memory
# at 64 | 65, every tap's template in shared memory | the taps past what
# fits blended from L2 at 113 | 114 with an H100's 227 KB), the
# windows beside the specialization's 21 at its 3 levels, and 21 at 5
# levels (past the specialization's 4), where slots do not converge.
CARD_POINTS = POINTS + [(1, 2), (63, 1), (128, 1), (16, 3), (17, 3),
                        (20, 3), (22, 3), (23, 2), (32, 2), (33, 2),
                        (45, 2), (46, 2), (64, 2), (65, 2), (112, 2),
                        (113, 2), (114, 2), (21, 5)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparisons. It is imported here, not
    with the module, so that the card's test collects and runs where JAX
    is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vins_tpu.config import FrontendConfig
    from vins_tpu.ops import image, klt as j_klt, klt_pallas
    return SimpleNamespace(jnp=jnp, pltpu=pltpu, FrontendConfig=FrontendConfig,
                           img=image, klt=j_klt, pallas=klt_pallas)


def _scene_images(H, W, seed, blur):
    """A smoothed random [H, W] frame, the same shifted by (+2, -1) px, M
    points (border points first) and their valid flags (a dead slot among
    them). blur: one package's gaussian_blur at sigma 2 on a float32
    numpy image."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (H + 8, W + 8)).astype(np.float32)
    for _ in range(10):     # smooth enough for the coarsest level's basin
        base = np.asarray(blur(base))
    base = (base - base.min()) / (base.max() - base.min())
    img0 = base[4:H + 4, 4:W + 4]
    img1 = base[5:H + 5, 2:W + 2]               # shifted by (+2, -1) px
    pts = rng.uniform(0, [W, H], (M, 2)).astype(np.float32)
    pts[:4] = [[0.0, 0.0], [W - 1.0, H - 1.0], [1.5, H - 2.0],
               [W - 3.0, 2.2]]                  # border points
    valid = rng.uniform(0, 1, M) > 0.25
    valid[:4] = True
    valid[4] = False                            # at least one dead slot
    return img0, img1, pts, valid


def _make_scene(jx, H, W, L, seed=0):
    """The scene built with the JAX package's image ops, as JAX arrays
    (pj*, gj*) and as tensors (pt*, gt*)."""
    jnp, j_img = jx.jnp, jx.img
    img0, img1, pts, valid = _scene_images(
        H, W, seed, lambda b: j_img.gaussian_blur(jnp.asarray(b), 2.0))
    pj0 = j_img.build_pyramid(jnp.asarray(img0), L)
    pj1 = j_img.build_pyramid(jnp.asarray(img1), L)
    gj0 = [j_img.sobel_gradients(p) for p in pj0]
    gj1 = [j_img.sobel_gradients(p) for p in pj1]
    return dict(
        pj0=pj0, pj1=pj1, gj0=gj0, gj1=gj1, pts=pts, valid=valid,
        pt0=[_t(p) for p in pj0], pt1=[_t(p) for p in pj1],
        gt0=[(_t(a), _t(b)) for a, b in gj0],
        gt1=[(_t(a), _t(b)) for a, b in gj1])


def _card_scene(H, W, L, seed, device):
    """The same kind of scene built with the port's image ops alone, on
    device: the card compares the kernels only with their plain versions,
    and the card's machine has no JAX."""
    img0, img1, pts, valid = _scene_images(
        H, W, seed, lambda b: t_img.gaussian_blur(torch.as_tensor(b), 2.0))
    pt0 = [p.to(device) for p in t_img.build_pyramid(_t(img0), L)]
    pt1 = [p.to(device) for p in t_img.build_pyramid(_t(img1), L)]
    return dict(pts=_t(pts).to(device), valid=_t(valid).to(device),
                pt0=pt0, pt1=pt1,
                gt0=[t_img.sobel_gradients(p) for p in pt0],
                gt1=[t_img.sobel_gradients(p) for p in pt1])


def _chip_smoke():
    """chip_smoke.py, the script at the repo's root, as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _held_flow_err(diff, iters_run, iters, held=None):
    """The largest flow difference [M, 2] over the held slots (all where
    held is None) whose plain pass stopped early at level 0 (iters_run:
    the plain version's per-level counts), and over those that ran all
    iters updates there."""
    host = lambda x: x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    conv = host(iters_run[-1]) < iters
    held = np.ones_like(conv) if held is None else host(held)
    d = np.abs(host(diff)).max(-1)
    return (float(d[held & conv].max(initial=0.0)),
            float(d[held & ~conv].max(initial=0.0)))


@pytest.fixture(scope="module")
def scenes(jx):
    return {L: _make_scene(jx, *SHAPE[L], L) for L in SHAPE}


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("win, L", POINTS)
def test_k1_plain_matches_pallas_at_window_and_depth(jx, scenes, win, L,
                                                     direction):
    """K1's plain version equals _klt_pyramid_kernel at (win, L): forward
    from zero flow, and backward from the forward result seeded with the
    negated forward flow, as track_pyramid_fb runs them."""
    s = scenes[L]
    pts, valid, init = s["pts"], s["valid"], None
    if direction == "bwd":
        p_f, ok_f, _ = klt_cuda.track_pyramid_plain(
            s["pt0"], s["gt0"], s["pt1"], _t(pts), _t(valid), win, ITERS,
            EPS)
        pts, valid = p_f.numpy(), (ok_f.numpy() & valid)
        init = s["pts"] - pts
    prev, nxt, grads = ((s["pj0"], s["pj1"], s["gj0"]) if direction == "fwd"
                        else (s["pj1"], s["pj0"], s["gj1"]))
    jnp = jx.jnp
    with jx.pltpu.force_tpu_interpret_mode():
        p_ref, ok_ref, e_ref = jx.pallas.track_pyramid_pallas(
            prev, grads, nxt, jnp.asarray(pts), jnp.asarray(valid), win,
            ITERS, EPS, None if init is None else jnp.asarray(init))
    tprev, tnxt, tgrads = ((s["pt0"], s["pt1"], s["gt0"])
                           if direction == "fwd"
                           else (s["pt1"], s["pt0"], s["gt1"]))
    args = (tprev, tgrads, tnxt, _t(pts), _t(valid), win, ITERS, EPS,
            None if init is None else _t(init))
    p, ok, err = klt_cuda.track_pyramid_plain(*args)
    # The wrapper takes the plain version for CPU tensors.
    for a, b in zip(klt_cuda.track_pyramid(*args), (p, ok, err)):
        assert torch.equal(a, b)
    assert np.array_equal(ok.numpy(), np.asarray(ok_ref) & valid)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=FLOW_TOL)
    np.testing.assert_allclose(err.numpy()[valid], np.asarray(e_ref)[valid],
                               atol=ERR_TOL)
    # Dead input slots keep their seed flow and err 0.
    seed = np.zeros_like(pts) if init is None else init
    np.testing.assert_array_equal(p.numpy()[~valid], (pts + seed)[~valid])
    assert np.all(err.numpy()[~valid] == 0.0)
    if direction == "fwd":
        assert ok.numpy().sum() >= 6   # the scene does track


@pytest.mark.parametrize("win, L", POINTS)
def test_k4_plain_matches_pallas_at_window(jx, scenes, win, L):
    """K4's plain version (one level, per-slot guess) equals _klt_kernel
    at window win on the pyramid's coarsest level, dead slots included."""
    s = scenes[L]
    lvl = L - 1
    rng = np.random.default_rng(win)
    pts = (s["pts"] / 2.0 ** lvl).astype(np.float32)
    guess = rng.uniform(-1, 1, (M, 2)).astype(np.float32)
    gx, gy = s["gj0"][lvl]
    jnp = jx.jnp
    with jx.pltpu.force_tpu_interpret_mode():
        f_ref, ok_ref, e_ref = jx.pallas.track_level_pallas(
            s["pj0"][lvl], gx, gy, s["pj1"][lvl], jnp.asarray(pts),
            jnp.asarray(guess), jnp.asarray(s["valid"]), win, ITERS, EPS)
    args = (s["pt0"][lvl], s["gt0"][lvl][0], s["gt0"][lvl][1],
            s["pt1"][lvl], _t(pts), _t(guess), _t(s["valid"]), win, ITERS,
            EPS)
    flow, ok, err = klt_cuda.track_level_plain(*args)
    for a, b in zip(klt_cuda.track_level(*args), (flow, ok, err)):
        assert torch.equal(a, b)
    live = s["valid"]
    assert np.array_equal(ok.numpy(), np.asarray(ok_ref))
    np.testing.assert_allclose(flow.numpy(), np.asarray(f_ref),
                               atol=FLOW_TOL)
    np.testing.assert_allclose(err.numpy()[live], np.asarray(e_ref)[live],
                               atol=ERR_TOL)


@pytest.mark.parametrize("win", [11, 16])
def test_k2_plain_matches_pallas_at_window(jx, scenes, win):
    """K2's plain version equals _ncc_kernel at an odd and an even
    window, on the forward result, border patches included."""
    s = scenes[2]
    p_f, _, _ = klt_cuda.track_pyramid_plain(
        s["pt0"], s["gt0"], s["pt1"], _t(s["pts"]), _t(s["valid"]), win,
        ITERS, EPS)
    jnp = jx.jnp
    with jx.pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jx.pallas.patch_ncc_pallas(
            s["pj0"][0], s["pj1"][0], jnp.asarray(s["pts"]),
            jnp.asarray(p_f.numpy()), win))
    args = (s["pt0"][0], s["pt1"][0], _t(s["pts"]), p_f, win)
    out = klt_cuda.patch_ncc_plain(*args)
    assert torch.equal(out, klt_cuda.patch_ncc(*args))
    np.testing.assert_allclose(out.numpy(), ref, atol=NCC_TOL)
    assert np.all(np.isfinite(out.numpy()))


@pytest.mark.parametrize("win", [11, 49])
def test_k3_patches_plain_matches_pallas(jx, scenes, win):
    """extract_patches (here its plain version) equals _patches_kernel's
    [N, win, win] output to float32 round-off (1e-6: the Pallas blend and
    the plain one round in the same order), border keypoints included."""
    s = scenes[2]
    img = s["pj0"][0]
    H, W = img.shape
    pts = np.concatenate([s["pts"], [[0.0, 0.0], [W - 1.0, H - 1.0],
                                     [W / 2, 0.5], [0.25, H / 2]]])
    pts = pts.astype(np.float32)
    with jx.pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jx.pallas.extract_patches_pallas(
            img, jx.jnp.asarray(pts), win))
    out = brief_cuda.extract_patches(_t(img), _t(pts), win)
    assert out.shape == (len(pts), win, win)
    assert torch.equal(out, brief_cuda.extract_patches_plain(_t(img),
                                                             _t(pts), win))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


def test_track_fb_plain_matches_tpu_branch_at_15_5(jx, scenes,
                                                   monkeypatch):
    """The fused kernel's plain version equals the JAX package's TPU branch
    of track_pyramid_fb (track_pyramid_pallas forward and backward, the
    post-filters, patch_ncc_pallas and the gate) at klt_window = 15 and 5
    pyramid levels, in interpret mode."""
    s = scenes[5]
    jnp = jx.jnp
    monkeypatch.setattr(jx.klt, "_on_tpu", lambda: True)
    cfg = jx.FrontendConfig(klt_window=15, pyramid_levels=5, klt_eps=EPS)
    with jx.pltpu.force_tpu_interpret_mode():
        ref = jx.klt.track_pyramid_fb(
            s["pj0"], s["pj1"], jnp.asarray(s["pts"]),
            jnp.asarray(s["valid"]), cfg, grads_prev=s["gj0"],
            grads_next=s["gj1"])
    args = (s["pt0"], s["gt0"], s["pt1"], s["gt1"], _t(s["pts"]),
            _t(s["valid"]), 15, ITERS, EPS, 0.3, klt.NCC_MIN)
    pts, status, err, ncc = klt_cuda.track_fb_plain(*args)
    ok = np.asarray(ref.status)
    assert np.array_equal(status.numpy(), ok)
    assert ok.sum() >= 4
    np.testing.assert_allclose(pts.numpy(), np.asarray(ref.pts),
                               atol=FLOW_TOL)
    np.testing.assert_allclose(err.numpy()[ok], np.asarray(ref.err)[ok],
                               atol=2 * FLOW_TOL)
    assert np.all(np.isfinite(ncc.numpy()))
    for a, b in zip(klt_cuda.track_fb(*args), (pts, status, err, ncc)):
        assert torch.equal(a, b)


def test_patch_parity_at_borders(jx, rng):
    """tests/test_klt_pallas.py's border case against the port: clamped
    border reads of track_level_plain equal track_level_pallas's."""
    H, W = 64, 128
    img = rng.uniform(0, 1, (H, W)).astype(np.float32)
    win = 11
    corner_pts = np.asarray([[0.0, 0.0], [W - 1.0, H - 1.0], [0.0, H - 1.0],
                             [W - 1.0, 0.0], [5.3, 60.7], [120.9, 2.2]],
                            np.float32)
    jnp = jx.jnp
    gx, gy = jx.img.sobel_gradients(jnp.asarray(img))
    valid = np.ones(len(corner_pts), bool)
    guess = np.zeros_like(corner_pts)
    with jx.pltpu.force_tpu_interpret_mode():
        f_pal, ok_pal, _ = jx.pallas.track_level_pallas(
            jnp.asarray(img), gx, gy, jnp.asarray(img),
            jnp.asarray(corner_pts), jnp.asarray(guess), jnp.asarray(valid),
            win, 3)
    f, ok, _ = klt_cuda.track_level_plain(
        _t(img), _t(gx), _t(gy), _t(img), _t(corner_pts), _t(guess),
        _t(valid), win, 3)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_pal), atol=1e-4)
    assert np.array_equal(ok.numpy(), np.asarray(ok_pal))


def test_wrappers_take_every_window_on_the_cpu():
    """Every window from 1 to 128 passes the CUDA path's window check and
    runs through the wrappers on CPU tensors (their plain versions), with
    the output shapes of the Pallas kernels."""
    rng = np.random.default_rng(3)
    img = _t(rng.uniform(0, 1, (130, 132)).astype(np.float32))
    pts = _t(np.array([[0.0, 0.0], [65.5, 64.25], [131.0, 129.0]],
                      np.float32))
    valid = torch.tensor([True, True, False])
    for win in range(1, klt_cuda.MAX_WIN + 1):
        klt_cuda._check_win(win)
        klt_cuda._check_level_shape(0, win + 2, win + 2, win)
        assert brief_cuda.extract_patches(img, pts, win).shape == (3, win,
                                                                   win)
        assert klt_cuda.patch_ncc(img, img, pts, pts, win).shape == (3,)
    for win in (1, 2, 64, 127, 128):
        flow, ok, err = klt_cuda.track_level(img, img, img, img, pts,
                                             torch.zeros_like(pts), valid,
                                             win, 2)
        assert flow.shape == (3, 2) and ok.shape == err.shape == (3,)
        out = klt_cuda.track_fb([img], [(img, img)], [img], [(img, img)],
                                pts, valid, win, 2, EPS, 0.3, 0.5)
        assert out[0].shape == (3, 2)


def test_cuda_path_checks_name_the_domain():
    """The CUDA path's checks refuse only what no kernel can compute: a
    window past 128 (or below 1), a level smaller than the window plus its
    bilinear border, more levels than a launch carries."""
    for win in (0, 129, 200):
        with pytest.raises(ValueError, match="1x1 to 128x128"):
            klt_cuda._check_win(win)
    for H, W in ((16, 40), (40, 16)):
        with pytest.raises(ValueError, match="at least 17x17"):
            klt_cuda._check_level_shape(4, H, W, 15)
    klt_cuda._check_level_shape(4, 17, 17, 15)
    for L in (1, 5, klt_cuda.MAX_LEVELS):
        klt_cuda._check_levels(L)
    for L in (0, klt_cuda.MAX_LEVELS + 1):
        with pytest.raises(ValueError, match="pyramid levels"):
            klt_cuda._check_levels(L)


@pytest.mark.parametrize("win, L, departs, n_unconverged",
                         [(21, 5, True, 20), (46, 2, False, 10)])
def test_k1_unconverged_slots_spread_in_the_reference(jx, win, L, departs,
                                                      n_unconverged):
    """A departure on purpose: a K1 slot that runs all ITERS updates at
    level 0 has not converged, and its position carries the rounding of
    every update. On chip_smoke.py's frame pair (the port's renderer, here
    on the CPU), the Pallas kernel in interpret mode and the port's plain
    version agree to FLOW_TOL on the converged slots (measured 3.05e-5 px
    at both points) but at window 21 and 5 levels differ by more on such a
    slot on one host (measured 1.16e-3 px), by less on another (5.95e-4
    px on an AVX-512 host): the size of that spread is the host's
    rounding, so the card's tests hold those slots to
    FLOW_TOL_UNCONVERGED, the others to FLOW_TOL. What makes it a spread
    of float32 and not a fault of either side: there, each lies within
    FLOW_TOL_UNCONVERGED of the plain version run in float64 on the same
    inputs. At window 46 and 2 levels (the first window of 16 template
    taps a thread in the runtime-window variant) the two differ by
    1.22e-4 px there."""
    from vins_tpu_torch import default_config
    c = _chip_smoke()
    pyr0, g0, pyr1, _, pts, valid, _ = c.frame_pair(
        c._with_window(default_config(), win, L), "cpu")
    runs = []
    p, ok, _ = klt_cuda.track_pyramid_plain(pyr0, g0, pyr1, pts, valid, win,
                                            ITERS, EPS, iters_run=runs)
    j = lambda x: jx.jnp.asarray(x.numpy())
    with jx.pltpu.force_tpu_interpret_mode():
        p_ref, ok_ref, _ = jx.pallas.track_pyramid_pallas(
            [j(x) for x in pyr0], [(j(a), j(b)) for a, b in g0],
            [j(x) for x in pyr1], j(pts), j(valid), win, ITERS, EPS)
    assert np.array_equal(ok.numpy(), np.asarray(ok_ref))
    conv, unconv = _held_flow_err(p.numpy() - np.asarray(p_ref), runs,
                                  ITERS, ok)
    assert int((ok & (runs[-1] == ITERS)).sum()) >= n_unconverged
    assert conv <= FLOW_TOL
    if departs:
        assert unconv <= FLOW_TOL_UNCONVERGED
        f64 = lambda xs: [x.double() for x in xs]
        p64, _, _ = klt_cuda.track_pyramid_plain(
            f64(pyr0), [tuple(f64(g)) for g in g0], f64(pyr1), pts.double(),
            valid, win, ITERS, EPS)
        for flow in (p.numpy(), np.asarray(p_ref)):
            _, to64 = _held_flow_err(flow - p64.numpy(), runs, ITERS, ok)
            assert 0.0 < to64 <= FLOW_TOL_UNCONVERGED
    else:
        assert unconv <= FLOW_TOL


def test_k1_window_1_gated_slots_diverge_in_the_reference(jx):
    """At window 1 the structure tensor of every slot is rank 1: every
    slot is gated and still iterates on the inverse of a singular tensor
    (det <= 1e-12 leaves 1 / 1 in its place), which amplifies rounding.
    On chip_smoke.py's frame pair (here on the CPU) the Pallas kernel in
    interpret mode and the plain version agree on the gate but not on the
    flow (measured 53.7 px apart); on the card test's own scene a one-ulp
    move of the points moves the plain version's flow by far more than
    FLOW_TOL (measured 3.92 px). So the card's test compares the flow at
    window 1 on the slots both sides keep only."""
    from vins_tpu_torch import default_config
    c = _chip_smoke()
    win, L = 1, 2
    pyr0, g0, pyr1, _, pts, valid, _ = c.frame_pair(
        c._with_window(default_config(), win, L), "cpu")
    p, ok, _ = klt_cuda.track_pyramid_plain(pyr0, g0, pyr1, pts, valid, win,
                                            ITERS, EPS)
    j = lambda x: jx.jnp.asarray(x.numpy())
    with jx.pltpu.force_tpu_interpret_mode():
        p_ref, ok_ref, _ = jx.pallas.track_pyramid_pallas(
            [j(x) for x in pyr0], [(j(a), j(b)) for a, b in g0],
            [j(x) for x in pyr1], j(pts), j(valid), win, ITERS, EPS)
    assert np.array_equal(ok.numpy(), np.asarray(ok_ref))
    assert not ok.any()
    d = np.abs(p.numpy() - np.asarray(p_ref)).max(-1)
    assert float(d[valid.numpy()].max()) > 100 * FLOW_TOL
    s = _card_scene(max(SHAPE[5][0], 130 << (L - 1)),
                    max(320, (win + 2) << (L - 1)), L, win, "cpu")
    run = lambda q: klt_cuda.track_pyramid_plain(
        s["pt0"], s["gt0"], s["pt1"], q, s["valid"], win, ITERS, EPS)
    moved = torch.nextafter(s["pts"], torch.full_like(s["pts"], 1e9))
    (p, ok, _), (q, ok_q, _) = run(s["pts"]), run(moved)
    assert torch.equal(ok, ok_q) and not ok.any()
    assert float((p - q).abs().max()) > 100 * FLOW_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("win, L", CARD_POINTS)
def test_runtime_window_kernels_on_card(win, L):
    """On a CUDA card: the fused kernel, K1, K4, K2 and K3's patch entry at
    (win, L) launch, count their launches, and agree with their plain
    versions on the same device (flow 1e-3 px, or FLOW_TOL_UNCONVERGED on
    a slot whose plain pass ran all ITERS updates at level 0; K2's NCC
    1e-5; patches bit for bit); chip_smoke.py runs the same checks at
    640x480."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    s = _card_scene(max(SHAPE[5][0], 130 << (L - 1)),
                    max(320, (win + 2) << (L - 1)), L, win, dev)
    prev, nxt, g0, g1 = s["pt0"], s["pt1"], s["gt0"], s["gt1"]
    pts, valid = s["pts"], s["valid"]
    fb = (prev, g0, nxt, g1, pts, valid, win, ITERS, EPS, 0.3, 0.5)
    counts = lambda: (klt_cuda.track_fb.launches,
                      klt_cuda.track_pyramid.launches,
                      klt_cuda.track_level.launches,
                      klt_cuda.patch_ncc.launches,
                      brief_cuda.extract_patches.launches)
    before = counts()
    q_k, st_k, rt_k, ncc_k = klt_cuda.track_fb(*fb)
    p_k, ok_k, _ = klt_cuda.track_pyramid(prev, g0, nxt, pts, valid, win,
                                          ITERS, EPS)
    guess = (0.5 * (p_k - pts)).contiguous()
    lvl = (prev[0], g0[0][0], g0[0][1], nxt[0], pts, guess, valid, win,
           ITERS, EPS)
    f_k, ok4_k, _ = klt_cuda.track_level(*lvl)
    n_k = klt_cuda.patch_ncc(prev[0], nxt[0], pts, p_k, win)
    pa_k = brief_cuda.extract_patches(prev[0], pts, win)
    torch.cuda.synchronize()
    assert counts() == tuple(b + 1 for b in before)
    runs = []
    p_p, ok_p, _ = klt_cuda.track_pyramid_plain(prev, g0, nxt, pts, valid,
                                                win, ITERS, EPS,
                                                iters_run=runs)
    q_p, st_p, rt_p, ncc_p = klt_cuda.track_fb_plain(*fb)
    assert torch.equal(st_k, st_p)
    # The fused kernel's forward pass is K1's: the same slots converge.
    conv, unconv = _held_flow_err(q_k - q_p, runs, ITERS, st_k & st_p)
    assert conv <= FLOW_TOL and unconv <= FLOW_TOL_UNCONVERGED
    assert float((ncc_k - ncc_p).abs().max()) <= NCC_TOL
    # At the kernel's own tracked points (the plain version's lie up to
    # the flow tolerance away) the NCC agrees to 1e-5.
    ncc_q = klt_cuda.patch_ncc_plain(prev[0], nxt[0], pts, q_k, win)
    assert float((ncc_k - ncc_q).abs().max()) <= 1e-5
    # Flow on every slot, gated ones included. At window 1 every slot is
    # gated (its structure tensor is rank 1) and iterates on the inverse
    # of a singular tensor, which amplifies any difference in rounding
    # (test_k1_window_1_gated_slots_diverge_in_the_reference): there only
    # the slots both sides keep (none) are compared.
    assert torch.equal(ok_k, ok_p)
    held = (ok_k & ok_p) if win == 1 else None
    conv, unconv = _held_flow_err(p_k - p_p, runs, ITERS, held)
    assert conv <= FLOW_TOL and unconv <= FLOW_TOL_UNCONVERGED
    runs4 = []
    f_p, ok4_p, _ = klt_cuda.track_level_plain(*lvl, iters_run=runs4)
    assert torch.equal(ok4_k, ok4_p)
    held = (ok4_k & ok4_p) if win == 1 else None
    conv, unconv = _held_flow_err(f_k - f_p, runs4, ITERS, held)
    assert conv <= FLOW_TOL and unconv <= FLOW_TOL_UNCONVERGED
    n_p = klt_cuda.patch_ncc_plain(prev[0], nxt[0], pts, p_k, win)
    assert float((n_k - n_p).abs().max()) <= 1e-5
    assert torch.equal(pa_k, brief_cuda.extract_patches_plain(prev[0], pts,
                                                              win))
