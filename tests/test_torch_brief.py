"""BRIEF on kernel K3, the FAST score and Hamming matching: vins_tpu_torch
against vins_tpu.

The port follows the TPU semantics of extract_brief on every device: each
keypoint's 49x49 patch corner is clamped once (klt_pallas._bilinear_patch)
and the taps are read inside that patch. The JAX package's CPU branch
clamps each tap alone instead; the two agree inside the border. So the
port's words are held bit for bit against the Pallas patch kernel in
interpret mode composed with the TPU branch's one-hot product at every
keypoint, and against the JAX CPU branch for keypoints inside the border.
From the raw frame, extract_brief runs the kernel's raw-frame entry
(the blur fused in); its plain version is held against the JAX TPU
branch from the same raw frame. K3's patch entry: its library yardstick
(one grid_sample call) against the plain patches on the CPU, and the
entry against its plain version across its window domain on the card.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vins_tpu_torch import interop
from vins_tpu_torch.ops import brief as t_brief
from vins_tpu_torch.ops import brief_cuda
from vins_tpu_torch.ops import corners as t_corners
from vins_tpu_torch.ops import image as t_img

pytest_plugins = ["torch_watchdog"]

torch.set_num_threads(1)

H, W = 96, 128
N = 24
_S = 0.4   # the 480x640 default camera scaled to 192x256
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparisons. It is imported here, not
    with the module, so that the card's tests collect and run where JAX is
    not installed."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from conftest import render_cached
    from jax.experimental.pallas import tpu as pltpu

    from vins_tpu.config import CameraConfig, VinsConfig
    from vins_tpu.ops import brief, corners, image
    from vins_tpu.ops.klt_pallas import extract_patches_pallas
    cfg = VinsConfig(camera=CameraConfig(
        width=192, height=256, fx=526.600 * _S, fy=526.678 * _S,
        cx=243.481 * _S, cy=315.280 * _S))
    return SimpleNamespace(
        jax=jax, jnp=jnp, pltpu=pltpu, brief=brief, corners=corners,
        img=image, extract_patches_pallas=extract_patches_pallas,
        render_cached=render_cached, cfg=cfg,
        blur=lambda x: image.gaussian_blur(jnp.asarray(x), 2.0))


def _port_blur(x):
    return t_img.gaussian_blur(torch.as_tensor(x), 2.0)


def _scene(seed, blur):
    """A random image, the same blurred with `blur` (one package's
    gaussian_blur at sigma 2) and N keypoints, the first six on or near
    the border (within 25 px, where the patch clamp shifts every tap)."""
    rng = np.random.default_rng(seed)
    raw = rng.uniform(0, 1, (H, W)).astype(np.float32)
    blurred = np.asarray(blur(raw))
    pts = rng.uniform(0, [W, H], (N, 2)).astype(np.float32)
    pts[:6] = [[0, 0], [W - 1, H - 1], [3.5, H - 2], [W - 5, 2.25],
               [24.5, H / 2], [W / 2, H - 24.75]]
    valid = rng.uniform(0, 1, N) > 0.3
    return raw, blurred, pts, valid


def _inside(pts):
    b = t_brief.PATCH_HALF + 1
    return ((pts[:, 0] >= b) & (pts[:, 0] < W - b - 1)
            & (pts[:, 1] >= b) & (pts[:, 1] < H - b - 1))


def _bits(words):
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8))


def _port_words(blurred, pts, valid):
    return brief_cuda.extract_brief_words(
        torch.as_tensor(blurred), torch.as_tensor(pts),
        torch.as_tensor(valid), t_brief.pattern_tensor(CPU)).numpy()


def test_brief_pattern_matches_jax(jx):
    np.testing.assert_array_equal(t_brief.make_pattern(), jx.brief._PATTERN)


def test_plain_patches_match_pallas_interpret(jx):
    """The plain patch cut (the taps K3's plain version reads) equals
    extract_patches_pallas in interpret mode, border keypoints included
    (taps within 1e-6)."""
    jnp = jx.jnp
    _, blurred, pts, _ = _scene(0, jx.blur)
    with jx.pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jx.extract_patches_pallas(
            jnp.asarray(blurred), jnp.asarray(pts), brief_cuda.PATCH_WIN))
    got = brief_cuda.extract_patches_plain(
        torch.as_tensor(blurred), torch.as_tensor(pts)).numpy()
    assert got.shape == ref.shape == (N, 49, 49)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("win", [11, 49, 128])
def test_grid_sample_patches_match_plain(win):
    """The patch entry's library yardstick, one F.grid_sample call on
    patch_grid's points, computes the patches of extract_patches_plain:
    within 1e-5 on a blurred frame, border keypoints and a NaN keypoint
    included. grid_sample unnormalizes the sample point from 2x/(W-1) - 1
    and weighs the four pixels at once, so the two differ in rounding
    only."""
    rng = np.random.default_rng(40 + win)
    h, w = 160, 200
    img = _port_blur(rng.uniform(0, 1, (h, w)).astype(np.float32))
    pts = rng.uniform(0, [w, h], (N, 2)).astype(np.float32)
    pts[:7] = [[0, 0], [w - 1, h - 1], [3.5, h - 2], [w - 5, 2.25],
               [24.5, h / 2], [w / 2, h - 24.75], [np.nan, 40]]
    pts = torch.as_tensor(pts)
    ref = brief_cuda.extract_patches_plain(img, pts, win)
    got = brief_cuda.extract_patches_grid_sample(img, pts, win)
    assert got.shape == ref.shape == (N, win, win)
    assert float((got - ref).abs().max()) <= 1e-5


def test_brief_words_match_tpu_branch_bit_for_bit(jx):
    """K3's plain version equals the TPU branch of extract_brief composed
    on the CPU (Pallas patches in interpret mode, the one-hot difference
    product at HIGHEST precision, _pack_bits) at every keypoint, border
    keypoints included."""
    jnp = jx.jnp
    _, blurred, pts, valid = _scene(1, jx.blur)
    with jx.pltpu.force_tpu_interpret_mode():
        patches = jx.extract_patches_pallas(jnp.asarray(blurred),
                                            jnp.asarray(pts),
                                            brief_cuda.PATCH_WIN)
    diff = jnp.dot(patches.reshape(N, -1), jnp.asarray(jx.brief._CMP_W),
                   precision=jx.jax.lax.Precision.HIGHEST)
    ref = np.asarray(jx.brief._pack_bits((diff > 0).astype(jnp.uint32)))
    ref = np.where(valid[:, None], ref, 0).astype(np.uint32)
    got = _port_words(blurred, pts, valid)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.uint32), ref)


def test_brief_words_match_jax_cpu_inside_the_border(jx, monkeypatch):
    """Fed the same blurred image, the port's words equal the JAX CPU
    branch of extract_brief (per-tap gather) bit for bit at keypoints
    inside the border."""
    jnp = jx.jnp
    _, blurred, _, _ = _scene(2, jx.blur)
    rng = np.random.default_rng(3)
    pts = rng.uniform([30, 30], [W - 30, H - 30], (N, 2)).astype(np.float32)
    assert _inside(pts).all()
    valid = np.ones(N, bool)
    monkeypatch.setattr(jx.brief.image_mod, "gaussian_blur",
                        lambda img, sigma: img)
    ref = np.asarray(jx.brief.extract_brief(
        jnp.asarray(blurred), jnp.asarray(pts), jnp.asarray(valid)))
    got = _port_words(blurred, pts, valid)
    np.testing.assert_array_equal(got.view(np.uint32), ref)


def test_extract_brief_from_a_rendered_frame_matches_jax(jx):
    """From the raw rendered frame, the port's blur and the JAX blur round
    differently in the last bit, which can flip an exact near-tie: at
    most 0.1% of the bits of in-border keypoints may differ (measured:
    0 of 9216, 36 keypoints)."""
    jnp = jx.jnp
    _, imgs = jx.render_cached(jx.cfg, n_frames=2, seed=4,
                               frame_dt=1.0 / 30.0,
                               traj_kwargs=dict(w=0.7, bob=0.15),
                               imu_per_frame=2)
    raw = np.asarray(imgs[1], np.float32)
    Hr, Wr = raw.shape
    pick = jx.corners.select_corners_grid(
        jx.corners.fast_score(jnp.asarray(raw)),
        jnp.zeros((Hr // 8, Wr // 8), bool), 48, 8)
    pts = np.asarray(pick.pts)
    b = t_brief.PATCH_HALF + 4
    inb = ((pts[:, 0] >= b) & (pts[:, 0] < Wr - b) & (pts[:, 1] >= b)
           & (pts[:, 1] < Hr - b) & np.asarray(pick.valid))
    assert inb.sum() >= 20
    ref = np.asarray(jx.brief.extract_brief(jnp.asarray(raw),
                                            jnp.asarray(pts),
                                            jnp.asarray(inb)))
    got = t_brief.extract_brief(torch.as_tensor(raw), torch.as_tensor(pts),
                                torch.as_tensor(inb)).numpy()
    n_diff = int(np.sum(_bits(got.view(np.uint32)[inb]) != _bits(ref[inb])))
    assert n_diff <= 1e-3 * inb.sum() * 256, n_diff


def test_gaussian_taps_are_the_blur_taps(jx):
    """gaussian_taps(2.0, 2) are the float32 taps gaussian_blur computed
    inline before they were factored out, and the interior row of the
    JAX band matrix that vins_tpu.ops.image.gaussian_blur multiplies by."""
    x = np.arange(-2, 3, dtype=np.float64)
    k = np.exp(-0.5 * (x / 2.0) ** 2)
    k = k / np.sum(k)
    before = tuple(float(np.float32(v)) for v in k)
    taps = t_img.gaussian_taps(2.0, 2)
    assert taps == before
    band = jx.img._band_np(16, tuple(float(v) for v in k))
    np.testing.assert_array_equal(np.asarray(taps, np.float32), band[8, 6:11])


def test_extract_brief_is_blur_then_words_bit_for_bit():
    """On the CPU, extract_brief (the raw-frame entry's plain version)
    gives the words of gaussian_blur(raw, 2.0) followed by
    extract_brief_words_plain, bit for bit, border keypoints and invalid
    rows included."""
    raw, _, pts, valid = _scene(11, _port_blur)
    r, p, v = (torch.as_tensor(raw), torch.as_tensor(pts),
               torch.as_tensor(valid))
    got = t_brief.extract_brief(r, p, v)
    ref = brief_cuda.extract_brief_words_plain(
        t_img.gaussian_blur(r, 2.0), p, v, t_brief.pattern_tensor(CPU))
    assert got.dtype == torch.int32 and got.shape == (N, 8)
    assert torch.equal(got, ref)
    assert torch.equal(got, brief_cuda.extract_brief_raw_plain(
        r, p, v, t_brief.pattern_tensor(CPU), t_img.gaussian_taps(2.0)))


def test_extract_brief_raw_matches_tpu_branch_from_raw(jx):
    """From a raw rendered frame, the raw-frame entry's plain version
    against the JAX package's TPU branch composed on the CPU: the band-
    matmul blur, extract_patches_pallas in interpret mode, the one-hot
    product at HIGHEST precision, _pack_bits. Border keypoints (all four
    borders and corners) and invalid rows included. The band-matmul blur
    and the port's gather blur round differently in the last bit, also
    where two reflect-101 taps coincide at a border, which can flip an
    exact near-tie: at most 0.1% of the valid keypoints' bits may differ
    (measured: 0 of 10240, 40 valid keypoints)."""
    jnp = jx.jnp
    _, imgs = jx.render_cached(jx.cfg, n_frames=2, seed=4,
                               frame_dt=1.0 / 30.0,
                               traj_kwargs=dict(w=0.7, bob=0.15),
                               imu_per_frame=2)
    raw = np.asarray(imgs[1], np.float32)
    Hr, Wr = raw.shape
    pick = jx.corners.select_corners_grid(
        jx.corners.fast_score(jnp.asarray(raw)),
        jnp.zeros((Hr // 8, Wr // 8), bool), 48, 8)
    pts = np.array(pick.pts, np.float32)
    pts[:8] = [[0, 0], [Wr - 1, Hr - 1], [1.5, Hr - 2.25], [Wr - 3, 0.75],
               [24.5, Hr / 2], [Wr / 2, 2.5], [Wr - 1.25, 130.6],
               [Wr / 3, Hr - 24.9]]
    valid = np.asarray(pick.valid).copy()
    valid[:8] = True
    valid[8::5] = False
    n = pts.shape[0]
    blurred = jx.img.gaussian_blur(jnp.asarray(raw), 2.0)
    with jx.pltpu.force_tpu_interpret_mode():
        patches = jx.extract_patches_pallas(blurred, jnp.asarray(pts),
                                            brief_cuda.PATCH_WIN)
    diff = jnp.dot(patches.reshape(n, -1), jnp.asarray(jx.brief._CMP_W),
                   precision=jx.jax.lax.Precision.HIGHEST)
    ref = np.asarray(jx.brief._pack_bits((diff > 0).astype(jnp.uint32)))
    ref = np.where(valid[:, None], ref, 0).astype(np.uint32)
    got = brief_cuda.extract_brief_raw(
        torch.as_tensor(raw), torch.as_tensor(pts), torch.as_tensor(valid),
        t_brief.pattern_tensor(CPU), t_img.gaussian_taps(2.0)).numpy()
    assert valid.sum() >= 30
    assert not got[~valid].any()
    n_diff = int(np.sum(_bits(got.view(np.uint32)[valid])
                        != _bits(ref[valid])))
    assert n_diff <= 1e-3 * valid.sum() * 256, n_diff


def test_extract_brief_raw_refuses_other_devices():
    """Dispatch is on the tensor's device: a tensor on any device but the
    CPU or a CUDA card raises instead of falling back."""
    raw, _, pts, valid = _scene(12, _port_blur)
    meta = lambda x: torch.as_tensor(x).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        brief_cuda.extract_brief_raw(
            meta(raw), meta(pts), meta(valid),
            meta(t_brief.pattern_tensor(CPU)), t_img.gaussian_taps(2.0))


def test_fast_score_matches_jax(jx):
    jnp = jx.jnp
    _, blurred, _, _ = _scene(5, jx.blur)
    img = np.asarray(jx.img.gaussian_blur(jnp.asarray(blurred), 1.0))
    ref = np.asarray(jx.corners.fast_score(jnp.asarray(img)))
    got = t_corners.fast_score(torch.as_tensor(img)).numpy()
    assert (ref > 0).sum() > 100
    np.testing.assert_array_equal(got, ref)


def _random_words(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)


def test_hamming_matrix_matches_jax(jx):
    jnp = jx.jnp
    rng = np.random.default_rng(6)
    a, b = _random_words(rng, 40), _random_words(rng, 33)
    b[:5] = a[:5] ^ np.uint32(0x80000001)     # words >= 2**31, near pairs
    ref = np.asarray(jx.brief.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = t_brief.hamming_matrix(torch.as_tensor(a.view(np.int32)),
                                 torch.as_tensor(b.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ratio", [1.0, 0.85])
def test_match_descriptors_matches_jax(jx, ratio):
    jnp = jx.jnp
    rng = np.random.default_rng(7)
    a, b = _random_words(rng, 64), _random_words(rng, 80)
    # Noisy copies so that some pairs pass the distance gate.
    flips = (rng.uniform(size=(30, 256)) < 0.1).astype(np.uint8)
    bits = np.unpackbits(a[:30].view(np.uint8), axis=1) ^ flips
    b[10:40] = np.packbits(bits, axis=1).view(np.uint32)
    av, bv = rng.uniform(size=64) > 0.1, rng.uniform(size=80) > 0.1
    ref = jx.brief.match_descriptors(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(av), jnp.asarray(bv),
                                    max_dist=80, ratio=ratio)
    got = t_brief.match_descriptors(
        torch.as_tensor(a.view(np.int32)), torch.as_tensor(b.view(np.int32)),
        torch.as_tensor(av), torch.as_tensor(bv), max_dist=80, ratio=ratio)
    assert int(np.sum(np.asarray(ref.ok))) >= 10
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))


def test_global_descriptor_matches_jax(jx):
    jnp = jx.jnp
    rng = np.random.default_rng(8)
    d = _random_words(rng, 50)
    pts = rng.uniform(0, [W, H], (50, 2)).astype(np.float32)
    valid = rng.uniform(size=50) > 0.2
    ref = np.asarray(jx.brief.global_descriptor(
        jnp.asarray(d), jnp.asarray(valid), jnp.asarray(pts), (H, W)))
    got = t_brief.global_descriptor(
        torch.as_tensor(d.view(np.int32)), torch.as_tensor(valid),
        torch.as_tensor(pts), (H, W)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        t_brief.unpack_bits(torch.as_tensor(d.view(np.int32))).numpy(),
        np.asarray(jx.brief._unpack_bits(jnp.asarray(d))))


def test_interop_carries_brief_words_bit_for_bit(jx):
    """A JAX LoopAnchor's uint32 words (many >= 2**31) cross into the
    port's int32 words as bit patterns, and back."""
    jnp = jx.jnp
    from vins_tpu.stream import LoopAnchor as JAnchor
    from vins_tpu_torch.stream import LoopAnchor as TAnchor

    rng = np.random.default_rng(9)
    words = _random_words(rng, 16)
    assert (words >= 2 ** 31).any()
    tree = jx.jax.device_get(JAnchor.inactive(16)._replace(
        desc_old=jnp.asarray(words)))
    port = interop.to_torch(tree, TAnchor.inactive(16, device="cpu"))
    assert port.desc_old.dtype == torch.int32
    np.testing.assert_array_equal(port.desc_old.numpy().view(np.uint32),
                                  words)
    back = interop.to_numpy(port, like=tree)
    assert back.desc_old.dtype == np.uint32
    np.testing.assert_array_equal(back.desc_old, words)


@pytest.mark.gpu
def test_brief_kernel_on_card():
    """On a CUDA card: K3 launches, counts its launch, and equals its plain
    version bit for bit (chip_smoke.py runs the same check at N = 512 and
    N = 128 on a 640x480 frame)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    _, blurred, pts, valid = _scene(10, _port_blur)
    args = (torch.as_tensor(blurred, device=dev),
            torch.as_tensor(pts, device=dev),
            torch.as_tensor(valid, device=dev), t_brief.pattern_tensor(dev))
    n0 = brief_cuda.extract_brief_words.launches
    got = brief_cuda.extract_brief_words(*args)
    torch.cuda.synchronize()
    assert brief_cuda.extract_brief_words.launches == n0 + 1
    assert torch.equal(got, brief_cuda.extract_brief_words_plain(*args))


@pytest.mark.gpu
def test_brief_raw_kernel_on_card():
    """On a CUDA card: the raw-frame entry launches once, counts its
    launch, and equals its plain version bit for bit, on a frame whose
    base is 16-byte aligned and on one that is not (a storage offset of
    one float), with keypoints at all four borders; the blurred-input
    entry does not launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    raw, _, pts, valid = _scene(13, _port_blur)
    pts[6:10] = [[1.0, H / 2], [W - 1.5, H / 3], [W / 2, 0.25],
                 [W / 3, H - 1.0]]
    valid[6:10] = True
    flat = torch.empty(H * W + 1, device=dev)
    shifted = flat[1:].view(H, W).copy_(torch.as_tensor(raw))
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    rest = (torch.as_tensor(pts, device=dev),
            torch.as_tensor(valid, device=dev), t_brief.pattern_tensor(dev),
            t_img.gaussian_taps(2.0))
    for img in (torch.as_tensor(raw, device=dev), shifted):
        n0 = brief_cuda.extract_brief_raw.launches
        w0 = brief_cuda.extract_brief_words.launches
        got = brief_cuda.extract_brief_raw(img, *rest)
        torch.cuda.synchronize()
        assert brief_cuda.extract_brief_raw.launches == n0 + 1
        assert brief_cuda.extract_brief_words.launches == w0
        assert torch.equal(got, brief_cuda.extract_brief_raw_plain(img,
                                                                   *rest))


# The card's patch-entry windows: every 16-byte phase of a row and of
# win * win around the widths where a warp or a 32-byte sector of a row
# fills; both sides of each edge between the entry's two bodies (40 / 41,
# 87 / 88 / 89) and of the strips' bands (64 / 65); the direct body's odd
# windows up to its last (41 ... 87); the BRIEF patch and the largest
# window.
PATCH_CARD_WINS = (1, 2, 3, 4, 11, 16, 17, 31, 32, 33, 40, 41, 49, 63, 64,
                   65, 77, 87, 88, 89, 113, 127, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("win", PATCH_CARD_WINS)
def test_patches_kernel_on_card(win):
    """On a CUDA card: K3's patch entry equals extract_patches_plain bit
    for bit at window win, for N = 0, 1, 3 and 512 keypoints (border
    keypoints and a NaN one among the first eight), on a frame whose width
    is a multiple of 4, one whose width is not, and one whose base is only
    4-byte aligned (a contiguous view at storage offset 1); each call with
    N > 0 counts one launch, N = 0 none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(win)
    h, w4 = win + 18, (win + 40) // 4 * 4
    frame = lambda w: torch.as_tensor(
        rng.uniform(0, 1, (h, w)).astype(np.float32), device=dev)
    flat = torch.empty(h * w4 + 1, device=dev)
    shifted = flat[1:].view(h, w4).copy_(frame(w4))
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    for img in (frame(w4), frame(w4 + 3), shifted):
        H, W = img.shape
        pts = rng.uniform(0, [W, H], (512, 2)).astype(np.float32)
        pts[:8] = [[0, 0], [W - 1, H - 1], [np.nan, H / 2], [3.25, H - 2.5],
                   [W - 20.5, 4.75], [W - 1.0, H / 3], [0.5, H - 24.9],
                   [W / 2, 2.25]]
        for n in (0, 1, 3, 512):
            p = torch.as_tensor(pts[:n], device=dev)
            n0 = brief_cuda.extract_patches.launches
            got = brief_cuda.extract_patches(img, p, win)
            torch.cuda.synchronize()
            assert brief_cuda.extract_patches.launches == n0 + (n > 0)
            assert got.shape == (n, win, win)
            assert torch.equal(got, brief_cuda.extract_patches_plain(
                img, p, win)), (W, n)
