"""The tracking kernels across their domain on one CUDA card.

    python3 tools/torch_klt_domain_sweep.py        (from the repo root)

Three parts, each point held against the plain versions with
chip_smoke.py's tolerances (fails otherwise; K1's flow on the slots whose
plain pass converged at level 0, its largest difference over every kept
slot reported beside it), one JSON line a point:
  * points chip_smoke.py does not run, on its 640x480 frame pair with 128
    slots: windows 1, 11, 16, 21 (5 levels: past the specialization's 4),
    31 (4 levels) and 128;
  * the ring's refill and the L2 mode, on a smoothed random frame pair
    with 128 random points: window 63 at 4 levels on 1024x768 (3 of 4
    levels fit in shared memory), 100 and 112 at 2 levels (1 of 2) and
    113 at 2 levels (none: templates read from L2) on 512x512;
  * the runtime-window variant beside the specialization at nearly the
    same point: klt_fb_ncc at windows 20 and 22 (variant) and 21
    (specialization), 3 levels, device times in turns.
Device time: chip_smoke._device_ms (20 calls in a CUDA graph, one replay
timed with CUDA events). Needs a card; imports nothing of JAX.
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as c  # noqa: E402
from vins_tpu_torch import default_config  # noqa: E402
from vins_tpu_torch.ops import brief_cuda, image, klt, klt_cuda  # noqa: E402
from vins_tpu_torch.ops import native  # noqa: E402

ITERS, EPS = 10, 0.01
FRAME_POINTS = ((1, 3), (11, 2), (16, 2), (21, 5), (31, 4), (128, 1))
REFILL_POINTS = ((63, 4, 1024, 768), (100, 2, 512, 512),
                 (112, 2, 512, 512), (113, 2, 512, 512))
TURNS = (21, 20, 22, 21, 22, 20, 21)


def _random_pair(win, L, H, W, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.rand(H + 8, W + 8, generator=g, device=dev)
    for _ in range(6):
        base = image.gaussian_blur(base, 2.0)
    base = (base - base.min()) / (base.max() - base.min())
    pyr = [[p.contiguous() for p in image.build_pyramid(
        base[dy:H + dy, dx:W + dx].contiguous(), L)]
        for dy, dx in ((4, 4), (5, 2))]
    grads = [[tuple(x.contiguous() for x in image.sobel_gradients(p))
              for p in levels] for levels in pyr]
    M = 128
    pts = (torch.rand(M, 2, generator=g, device=dev)
           * torch.tensor([W, H], device=dev)).contiguous()
    valid = torch.rand(M, generator=g, device=dev) > 0.3
    return pyr[0], grads[0], pyr[1], grads[1], pts, valid


def _point(part, win, L, pair):
    pyr0, g0, pyr1, g1, pts, valid = pair
    fb = (pyr0, g0, pyr1, g1, pts, valid, win, ITERS, EPS, c.FB_THRESH,
          klt.NCC_MIN)
    tag = f"@{win}x{win},L{L}"
    r = c._check_fb(fb, "klt_fb_ncc" + tag, ncc_tol=c.NCC_TOL_DOMAIN)
    k = c._k1_k4_k2(pyr0, g0, pyr1, g1, pts, valid, win, ITERS, EPS, tag,
                    ncc_tol=c.NCC_TOL_DOMAIN, converged_only=True)
    patches = brief_cuda.extract_patches(pyr0[0], pts, win)
    if not torch.equal(patches, brief_cuda.extract_patches_plain(
            pyr0[0], pts, win)):
        c._fail(f"K3 patches{tag} differ from the plain version")
    ring, smem = klt_cuda.generic_plan(win, L)
    print(json.dumps(dict(
        part=part, win=win, levels=L, shape=list(pyr0[0].shape),
        ring_levels=ring, smem_bytes=smem,
        specialization=win == 21 and L <= 4,
        fb_ms=c._device_ms(lambda: klt_cuda.track_fb(*fb)),
        k1_ms=k["t_k1"]["ms"], k4_ms=k["t_k4"]["ms"], k2_ms=k["t_k2"]["ms"],
        fb_pts_err=r["pts_err"], fb_ncc_at_points_err=r["ncc_at_points_err"],
        k1_flow_err_converged=k["flow_err"],
        k1_flow_err_all=k["flow_err_all"], k4_flow_err=k["k4_err"],
        k2_err=k["ncc_err"], status_agree=r["agree"], kept=r["kept"])),
        flush=True)


def main():
    if not torch.cuda.is_available():
        c._fail("needs a CUDA card")
    native.library()
    dev = torch.device("cuda", 0)
    card = c._card_line()
    print(card)
    cfg = default_config()
    for win, L in FRAME_POINTS:
        _point("frame_pair", win, L,
               c.frame_pair(c._with_window(cfg, win, L), dev)[:6])
    for win, L, H, W in REFILL_POINTS:
        _point("refill", win, L, _random_pair(win, L, H, W, dev))
    fb = {}
    for win in sorted(set(TURNS)):
        pair = c.frame_pair(c._with_window(cfg, win, 3), dev)[:6]
        fb[win] = pair + (win, ITERS, EPS, c.FB_THRESH, klt.NCC_MIN)
        c._check_fb(fb[win], f"klt_fb_ncc@{win}x{win},L3")
    times = {win: [] for win in fb}
    for win in TURNS:
        times[win].append(c._device_ms(lambda: klt_cuda.track_fb(*fb[win])))
    print(json.dumps(dict(part="same_point_turns", order=list(TURNS),
                          fb_ms={str(w): t for w, t in times.items()},
                          card=card)))


if __name__ == "__main__":
    main()
