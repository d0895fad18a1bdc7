"""Where the time of the port's LK kernels goes, on one NVIDIA GPU.

    python3 tools/torch_klt_ablation.py [--source PATH]   (from the repo root)

On chip_smoke.py's frame pair at the main path's shapes (640x480, 128
slots, 3 levels), it prints:
  1. how many LK iterations the slots run (the plain version's count, eps
     0.01): the kernel waits for its slowest slot;
  2. the device time of K1 (vins_tpu_torch/csrc/klt.cu) and of the fused
     klt_fb_ncc at 0 and 10 iterations a level (eps 0, so every live slot
     runs them all), and of K1 with 1 and 128 slots: the slope is the cost
     of one LK iteration;
  3. the same slope for variants of klt.cu built beside the real one, each
     with one part of the specialization's iteration cut out: the
     cross-warp exchange of the sums, the corner arithmetic, the tile
     taps;
  4. the runtime-window variant against the specialization: klt_fb_ncc at
     window 22 (the variant) and 21 (the specialization), 3 levels, 0 and
     10 iterations a level, in turns, for the source as it is and for
     variants with one part of the runtime-window code cut out (the fused
     NCC, the runtime geometry, the per-tap predicate, the next-frame tile
     staging, the wait for the staged templates, the cross-warp exchange).
     A cut that does not apply to the source is reported as such.
A variant's results are wrong by design; only its time means anything.
--source takes another klt.cu (e.g. a parent commit's, unpacked with git
archive into a git-ignored directory) for parts 3 and 4; the library the
program builds serves parts 1 and 2. Device times are chip_smoke._device_ms
(20 calls in a CUDA graph, one replay timed with CUDA events). The
variants are built with nvcc into smoke_out/ (git-ignored). Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

OUT = os.path.join(ROOT, "smoke_out")
WIN = 21
WIN_R = 22      # the variant's window beside the specialization's
LEVELS = 3
TURNS = 2       # rounds of (variant, specialization) per library

# The runtime-window code's parts, each as alternatives of (text, what
# replaces it): the first whose text the source holds is cut. Texts of
# the variant before its Hopper redesign and after it.
VARIANT_CUTS = {
    "fused NCC": [
        ("  const float ncc = ncc_r(g, red, fwd.tmpl[0], fwd.next[0], H, W, "
         "px, py,\n                          qx, qy);\n",
         "  const float ncc = 1.0f;\n"),
        ("  const float ncc = fused_ncc_r<KT>(",
         "  const float ncc = 1.0f; (void)("),
    ],
    "runtime geometry": [("const GeomR g(win);", "const GeomR g(22);")],
    "per-tap predicate": [
        ("        if (crow[k] < g.win) {\n", "        {\n"),
        ("        if (k < nk) {  // iteration tap\n", "        {\n"),
    ],
    "tile staging": [
        ("      sm[row * g.ts + col] = __ldg(plane + (size_t)(oy + row) * W "
         "+ ox + col);\n", "      sm[row * g.ts + col] = 0.5f;\n"),
        ("            ? __ldg(plane + (size_t)(oy + row) * W + (ox + col))\n"
         "            : 0.0f;  // runtime tile\n",
         "            ? 0.5f\n            : 0.0f;  // runtime tile\n"),
    ],
    "template wait": [
        ("    if (R > 0) wait_templates(min(R - 1, lvl));\n", "\n"),
        ("    wait_templates(min(R - 1, lvl));  // runtime ring\n", "\n"),
    ],
}


def _fixed_iterations(src: str) -> str:
    """The source with the eps exit removed from every LK loop, so that a
    wrong result cannot end a loop early."""
    loop = "    while (it < iters && d2 > eps2) {\n"
    assert src.count(loop) >= 1
    return src.replace(loop, "    while (it < iters) {\n")


def _exchange_cut(src: str):
    """The Reducer's cross-warp exchange (shared by both routes)."""
    head = "    float* buf = red[parity];\n"
    i = src.index(head)
    j = src.index("  }\n};", i)
    return (src[i:j], "#pragma unroll\n    for (int i = 0; i < N; ++i) "
            "v[i] = k;\n")


def _specialization_variants(src: str) -> dict:
    """klt.cu with a fixed iteration count and one part of the
    specialization's iteration cut out."""
    src = _fixed_iterations(src)
    corner = ("      corner(plx + flx - r, ply + fly - r, hx, hy, ix, iy, fx, "
              "fy);\n      if (!tile.holds(ix, iy))")
    cuts = {
        "none": ("", ""),
        "cross-warp exchange": _exchange_cut(src),
        "corner arithmetic": (corner, "      fx = 0.25f + 1e-9f * flx; fy = "
                              "0.5f + 1e-9f * fly;\n      ix = tile.ox + 2; "
                              "iy = tile.oy + 2;\n"
                              "      if (!tile.holds(ix, iy))"),
        "tile taps": ("blend(base + taps.tile[k], G::kTS, fx, fy)",
                      "(fx * 0.5f + fy)"),
    }
    out = {}
    for name, (a, b) in cuts.items():
        assert not a or src.count(a) == 1, name
        out[name] = src.replace(a, b) if a else src
    return out


def _variant_variants(src: str) -> tuple:
    """klt.cu with a fixed iteration count and one part of the
    runtime-window code cut out; and the names of the cuts the source
    does not hold."""
    src = _fixed_iterations(src)
    out = {"none": src,
           "cross-warp exchange": src.replace(*_exchange_cut(src))}
    missing = []
    for name, alternatives in VARIANT_CUTS.items():
        for a, b in alternatives:
            if a in src:
                out[name] = src.replace(a, b)
                break
        else:
            missing.append(name)
    return out, missing


def _build(variants: dict, tag: str) -> dict:
    from vins_tpu_torch.ops import native
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for k, (name, src) in enumerate(variants.items()):
        cu = os.path.join(OUT, f"klt_{tag}{k}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(OUT, f"libklt_{tag}{k}.so")
        procs[name] = (so, subprocess.Popen(
            [native._nvcc()] + native.ARCH_FLAGS
            + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", so, cu]))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the variant '{name}'")
        lib = ctypes.CDLL(so)
        for fn, argtypes in native._ARGTYPES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        if hasattr(lib, "vins_klt_init"):
            native.check(lib.vins_klt_init(), "vins_klt_init")
        libs[name] = lib
    return libs


def main() -> None:
    import torch
    from vins_tpu_torch import default_config
    from vins_tpu_torch.ops import klt_cuda, native

    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=os.path.join(
        ROOT, "vins_tpu_torch", "csrc", "klt.cu"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    card = chip_smoke._card_line()
    print(card)
    native.library()
    dev = torch.device("cuda", 0)
    cfg = default_config()
    pairs = {w: chip_smoke.frame_pair(chip_smoke._with_window(cfg, w, LEVELS),
                                      dev)[:6] for w in (WIN, WIN_R)}
    pyr0, g0, pyr1, g1, pts, valid = pairs[WIN]
    ms = chip_smoke._device_ms

    runs = []
    klt_cuda.track_pyramid_plain(pyr0, g0, pyr1, pts, valid, WIN, 10, 0.01,
                                 iters_run=runs)
    total = sum(runs)[valid]
    mean = float(total.float().mean())
    print(f"LK iterations a live slot runs over the 3 levels (forward, eps "
          f"0.01): max {int(total.max())}, mean {mean:.2f}, "
          f"{int((total == 30).sum())} of {int(valid.sum())} slots run all 30")

    def k1(iters, m=None):
        p, v = (pts, valid) if m is None else (pts[:m], valid[:m])
        return lambda: klt_cuda.track_pyramid(pyr0, g0, pyr1, p, v, WIN,
                                              iters, 0.0)

    def fused(iters, win=WIN):
        a, ga, b, gb, p, v = pairs[win]
        return lambda: klt_cuda.track_fb(a, ga, b, gb, p, v, win, iters, 0.0,
                                         0.3, 0.5)

    t = {n: (ms(k1(n)), ms(fused(n))) for n in (0, 10)}
    print(f"K1: {t[0][0]:.4f} ms at 0 iterations, {t[10][0]:.4f} ms at 10 a "
          f"level: {(t[10][0] - t[0][0]) / 30 * 1e3:.3f} us an iteration")
    print(f"klt_fb_ncc: {t[0][1]:.4f} ms at 0 iterations, {t[10][1]:.4f} ms "
          f"at 10 a level: {(t[10][1] - t[0][1]) / 60 * 1e3:.3f} us an "
          f"iteration")
    print(f"K1 at 10 iterations a level with 1 slot {ms(k1(10, 1)):.4f} ms, "
          f"with 128 slots {ms(k1(10)):.4f} ms")

    with open(args.source) as f:
        src = f.read()
    print(f"parts 3 and 4 cut from {os.path.relpath(args.source, ROOT)}")
    real = native._lib
    try:
        for name, lib in _build(_specialization_variants(src),
                                "cut").items():
            native._lib = lib
            a, b = ms(k1(0)), ms(k1(10))
            print(f"K1 with {name} cut out: {a:.4f} ms at 0 iterations, "
                  f"{b:.4f} ms at 10: {(b - a) / 30 * 1e3:.3f} us an "
                  f"iteration")
        variants, missing = _variant_variants(src)
        if missing:
            print(f"cuts the source does not hold: {', '.join(missing)}")
        rows = {}
        for name, lib in _build(variants, "var").items():
            native._lib = lib
            times = {key: [] for key in ("r0", "r10", "s0", "s10")}
            for _ in range(TURNS):
                for key, fn in (("r10", fused(10, WIN_R)),
                                ("s10", fused(10)), ("r0", fused(0, WIN_R)),
                                ("s0", fused(0))):
                    times[key].append(ms(fn))
            rows[name] = {k: sum(v) / len(v) for k, v in times.items()}
        base = rows["none"]
        for name, r in rows.items():
            print(f"klt_fb_ncc with {name} cut out: window {WIN_R} "
                  f"(variant) {r['r0']:.4f} / {r['r10']:.4f} ms at 0 / 10 "
                  f"iterations, window {WIN} (specialization) "
                  f"{r['s0']:.4f} / {r['s10']:.4f}; the cut saves "
                  f"{(base['r10'] - r['r10']) * 1e3:.2f} us of the "
                  f"variant, {(base['s10'] - r['s10']) * 1e3:.2f} us of "
                  f"the specialization; variant / specialization "
                  f"{r['r10'] / r['s10']:.3f}")
    finally:
        native._lib = real
    print(card)


if __name__ == "__main__":
    main()
