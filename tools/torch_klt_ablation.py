"""Where the time of the port's LK kernels goes, on one NVIDIA GPU.

    python3 tools/torch_klt_ablation.py        (from the repo root)

On chip_smoke.py's frame pair at the main path's shapes (640x480, 128
slots, 3 levels, win 21), it prints:
  1. how many LK iterations the slots run (the plain version's count, eps
     0.01): the kernel waits for its slowest slot;
  2. the device time of K1 (vins_tpu_torch/csrc/klt.cu) and of the fused
     klt_fb_ncc at 0 and 10 iterations a level (eps 0, so every live slot
     runs them all), and of K1 with 1 and 128 slots: the slope is the cost
     of one LK iteration;
  3. the same slope for variants of klt.cu built beside the real one, each
     with one part of the iteration cut out: the cross-warp exchange of
     the sums, the corner arithmetic, the tile taps. A variant's results
     are wrong by design; only its time means anything.
Device times are chip_smoke._device_ms (20 calls in a CUDA graph, one
replay timed with CUDA events). The variants are built with nvcc into
smoke_out/ (git-ignored). Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

OUT = os.path.join(ROOT, "smoke_out")
WIN = 21


def _variants(src: str) -> dict:
    """klt.cu with a fixed iteration count (the eps exit removed, so that
    a wrong result cannot end the loop early) and one part cut out."""
    loop = "    while (it < iters && d2 > eps2) {\n"
    assert src.count(loop) == 1
    src = src.replace(loop, "    while (it < iters) {\n")
    head = "    float* buf = red[parity];\n"
    i = src.index(head)
    j = src.index("  }\n};", i)
    corner = ("      corner(plx + flx - r, ply + fly - r, hx, hy, ix, iy, fx, "
              "fy);\n      if (!tile.holds")
    cuts = {
        "none": ("", ""),
        "cross-warp exchange": (src[i:j], "#pragma unroll\n    for (int i = 0;"
                                " i < N; ++i) v[i] = k;\n"),
        "corner arithmetic": (corner, "      fx = 0.25f + 1e-9f * flx; fy = "
                              "0.5f + 1e-9f * fly;\n      ix = tile.ox + 2; "
                              "iy = tile.oy + 2;\n      if (!tile.holds"),
        "tile taps": ("blend(base + taps.tile[k], G::kTS, fx, fy)",
                      "(fx * 0.5f + fy)"),
    }
    out = {}
    for name, (a, b) in cuts.items():
        assert not a or src.count(a) == 1, name
        out[name] = src.replace(a, b) if a else src
    return out


def _build(variants: dict) -> dict:
    from vins_tpu_torch.ops import native
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for k, (name, src) in enumerate(variants.items()):
        cu = os.path.join(OUT, f"klt_cut{k}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(OUT, f"libklt_cut{k}.so")
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
        libs[name] = lib
    return libs


def main() -> None:
    import torch
    from vins_tpu_torch import default_config
    from vins_tpu_torch.ops import klt_cuda, native

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    print(chip_smoke._card_line())
    native.library()
    dev = torch.device("cuda", 0)
    pyr0, g0, pyr1, g1, pts, valid, _ = chip_smoke.frame_pair(
        default_config(), dev)
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

    def fused(iters):
        return lambda: klt_cuda.track_fb(pyr0, g0, pyr1, g1, pts, valid, WIN,
                                         iters, 0.0, 0.3, 0.5)

    t = {n: (ms(k1(n)), ms(fused(n))) for n in (0, 10)}
    print(f"K1: {t[0][0]:.4f} ms at 0 iterations, {t[10][0]:.4f} ms at 10 a "
          f"level: {(t[10][0] - t[0][0]) / 30 * 1e3:.3f} us an iteration")
    print(f"klt_fb_ncc: {t[0][1]:.4f} ms at 0 iterations, {t[10][1]:.4f} ms "
          f"at 10 a level: {(t[10][1] - t[0][1]) / 60 * 1e3:.3f} us an "
          f"iteration")
    print(f"K1 at 10 iterations a level with 1 slot {ms(k1(10, 1)):.4f} ms, "
          f"with 128 slots {ms(k1(10)):.4f} ms")

    with open(os.path.join(ROOT, "vins_tpu_torch", "csrc", "klt.cu")) as f:
        libs = _build(_variants(f.read()))
    real = native._lib
    try:
        for name, lib in libs.items():
            native._lib = lib
            a, b = ms(k1(0)), ms(k1(10))
            print(f"K1 with {name} cut out: {a:.4f} ms at 0 iterations, "
                  f"{b:.4f} ms at 10: {(b - a) / 30 * 1e3:.3f} us an "
                  f"iteration")
    finally:
        native._lib = real
    print(chip_smoke._card_line())


if __name__ == "__main__":
    main()
