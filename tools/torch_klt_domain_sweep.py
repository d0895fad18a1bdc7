"""The tracking kernels across their domain on one CUDA card.

    python3 tools/torch_klt_domain_sweep.py [--witness]   (from the repo root)

Three parts, each point held against the plain versions with
chip_smoke.py's tolerances (fails otherwise; flow to FLOW_TOL on the slots
whose plain pass converged at level 0 and to FLOW_TOL_UNCONVERGED on the
others, both reported), one JSON line a point with the runtime-window
plan (template taps a thread, staged levels, shared memory):
  * points chip_smoke.py does not run, on its 640x480 frame pair with 128
    slots: window 1, 11, the plan's boundaries 16 | 17, 22 | 23, 32 | 33,
    45 | 46 (template taps a thread 1 | 2 | 4 | 8 | 16) and 64 | 65
    (registers | shared memory), 21 at 5 levels (past the
    specialization's 4), 31 at 4 levels and 128;
  * the ring's refill and the wide windows, on a smoothed random frame
    pair with 128 random points: window 63 at 4 levels on 1024x768 (3 of
    4 levels staged at a time), 100, 112 and 113 at 2 levels (every
    tap's template in shared memory) and 114 at 2 levels (the taps that
    do not fit blended from L2) on 512x512;
  * the runtime-window variant beside the specialization at nearly the
    same point: klt_fb_ncc at windows 20 and 22 (variant) and 21
    (specialization), 3 levels, device times in turns.
With --witness it runs only a fourth part, on the frame pair at the
first part's points: K1's forward flow from the kernel, from its plain
version on the card, from the plain version on the CPU and from the plain
version in float64 on the CPU (the same inputs), each float32 result's
largest distance to the float64 one over the kept slots whose plain pass
converged at level 0, the kept slots that did not, and the gated slots,
and the kernel's largest distance to the card's plain version there,
with the slots farthest from float64: whether a difference between the
kernel and its plain version lies in the kernel or in the rounding every
float32 version carries.
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
FRAME_POINTS = ((1, 3), (11, 2), (16, 2), (17, 2), (21, 5), (22, 2),
                (23, 2), (31, 4), (32, 2), (33, 2), (45, 2), (46, 2),
                (64, 2), (65, 2), (128, 1))
REFILL_POINTS = ((63, 4, 1024, 768), (100, 2, 512, 512),
                 (112, 2, 512, 512), (113, 2, 512, 512), (114, 2, 512, 512))
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
                    ncc_tol=c.NCC_TOL_DOMAIN)
    patches = brief_cuda.extract_patches(pyr0[0], pts, win)
    if not torch.equal(patches, brief_cuda.extract_patches_plain(
            pyr0[0], pts, win)):
        c._fail(f"K3 patches{tag} differ from the plain version")
    plan = klt_cuda.generic_plan(win, L)
    print(json.dumps(dict(
        part=part, win=win, levels=L, shape=list(pyr0[0].shape),
        **plan._asdict(), specialization=win == 21 and L <= 4,
        fb_ms=c._device_ms(lambda: klt_cuda.track_fb(*fb)),
        k1_ms=k["t_k1"]["ms"], k4_ms=k["t_k4"]["ms"], k2_ms=k["t_k2"]["ms"],
        fb_pts_err=r["pts_err"],
        fb_pts_err_unconverged=r["pts_err_unconverged"],
        fb_ncc_err=r["ncc_err"],
        fb_ncc_err_unconverged=r["ncc_err_unconverged"],
        fb_ncc_at_points_err=r["ncc_at_points_err"],
        k1_flow_err=k["flow_err"],
        k1_flow_err_unconverged=k["flow_err_unconverged"],
        k1_unconverged_slots=k["n_unconverged"], k4_flow_err=k["k4_err"],
        k4_flow_err_unconverged=k["k4_err_unconverged"],
        k2_err=k["ncc_err"], status_agree=r["agree"], kept=r["kept"])),
        flush=True)


def _witness(win, L, pair):
    pyr0, g0, pyr1, _, pts, valid = pair
    runs = []
    p_k, ok_k, _ = klt_cuda.track_pyramid(pyr0, g0, pyr1, pts, valid, win,
                                          ITERS, EPS)
    p_p, ok_p, _ = klt_cuda.track_pyramid_plain(
        pyr0, g0, pyr1, pts, valid, win, ITERS, EPS, iters_run=runs)
    on = lambda xs, f: [f(x) for x in xs]
    cpu = lambda x: x.cpu()
    f64 = lambda x: x.cpu().double()
    p_c, ok_c, _ = klt_cuda.track_pyramid_plain(
        on(pyr0, cpu), [on(g, cpu) for g in g0], on(pyr1, cpu), cpu(pts),
        cpu(valid), win, ITERS, EPS)
    p_64, ok_64, _ = klt_cuda.track_pyramid_plain(
        on(pyr0, f64), [on(g, f64) for g in g0], on(pyr1, f64), f64(pts),
        cpu(valid), win, ITERS, EPS)
    dist = lambda a, b: (a.cpu().double() - b.cpu().double()).abs().amax(-1)
    ok = ok_p.cpu()
    conv = runs[-1].cpu() < ITERS
    sets = dict(kept_converged=ok & conv, kept_unconverged=ok & ~conv,
                gated=~ok & valid.cpu())
    top = lambda d, m: float(d[m].max()) if bool(m.any()) else 0.0
    to64 = dict(kernel=dist(p_k, p_64), card_plain=dist(p_p, p_64),
                cpu_plain=dist(p_c, p_64))
    far = torch.argsort(-to64["kernel"] * sets["kept_unconverged"])[:4]
    print(json.dumps(dict(
        part="witness", win=win, levels=L,
        ok_agree=[bool(torch.equal(ok_k.cpu(), ok)),
                  bool(torch.equal(ok_c, ok)), bool(torch.equal(ok_64, ok))],
        n={k: int(m.sum()) for k, m in sets.items()},
        to_float64={v: {k: top(d, m) for k, m in sets.items()}
                    for v, d in to64.items()},
        kernel_to_card_plain={k: top(dist(p_k, p_p), m)
                              for k, m in sets.items()},
        farthest=[dict(slot=int(i), iters=[int(r[i]) for r in runs],
                       **{v: float(d[i]) for v, d in to64.items()})
                  for i in far])), flush=True)


def main():
    if not torch.cuda.is_available():
        c._fail("needs a CUDA card")
    native.library()
    dev = torch.device("cuda", 0)
    card = c._card_line()
    print(card)
    cfg = default_config()
    if sys.argv[1:] == ["--witness"]:
        for win, L in FRAME_POINTS:
            _witness(win, L, c.frame_pair(c._with_window(cfg, win, L),
                                          dev)[:6])
        return
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
