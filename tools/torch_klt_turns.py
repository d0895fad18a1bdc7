"""The tracking kernels and K3 of two source trees, timed in turns on one
card.

    python3 tools/torch_klt_turns.py DIR_A DIR_B     (from the repo root)

DIR_A and DIR_B each hold a checkout of the repo (e.g. a parent commit
and this one, unpacked with git archive into git-ignored directories).
Each tree runs in a process of its own, in the order A B B A, with its
own vins_tpu_torch (built there at first use) and its own chip_smoke.py:
on chip_smoke.frame_pair's 640x480 frames and 128 slots it takes the
device ms (chip_smoke._device_ms: 20 calls in a CUDA graph, one replay
timed with CUDA events) of klt_fb_ncc, K1, K4 and K2 at chip_smoke's
DOMAIN_POINTS (the runtime-window variant), of klt_fb_ncc at windows 20,
21 (the specialization) and 22 at 3 levels, and of klt_fb_ncc, K1, K4 and
K2 at the main path's (21, 3), and of klt_fb_ncc and K1 at windows 114
(2 levels) and 128 (1 level), whose templates pass what shared memory
holds beside the tile; and, on chip_smoke.brief_inputs' 640x480 frame at
N = 512 keypoints, of K3's patch entry (`extract_patches`) at windows
PATCH_WINS and of the main path's BRIEF entry from the raw frame
(`brief_raw_words`). Prints one JSON line a turn and then the mean of each
tree's two turns and B / A. Needs a card; imports nothing of JAX.
"""
import json
import os
import subprocess
import sys

ITERS, EPS = 10, 0.01
SAME_POINT = (20, 21, 22)
# Windows past 64 with templates past what shared memory holds beside the
# tile: klt_fb_ncc and K1 only.
WIDE_POINTS = ((114, 2), (128, 1))
PATCH_WINS = (11, 49, 128)


def _measure(tree: str) -> dict:
    """The device ms of the kernels of the tree this process imports."""
    import torch

    import chip_smoke as c
    from vins_tpu_torch import default_config
    from vins_tpu_torch.ops import brief, brief_cuda, image, klt, klt_cuda
    from vins_tpu_torch.ops import native

    native.library()
    dev = torch.device("cuda", 0)
    cfg = default_config()
    out = {}
    points = (list(c.DOMAIN_POINTS) + [(w, 3) for w in SAME_POINT]
              + list(WIDE_POINTS))
    for win, L in points:
        pyr0, g0, pyr1, g1, pts, valid, _ = c.frame_pair(
            c._with_window(cfg, win, L), dev)
        fb = (pyr0, g0, pyr1, g1, pts, valid, win, ITERS, EPS, c.FB_THRESH,
              klt.NCC_MIN)
        tag = f"{win},{L}"
        out["klt_fb_ncc@" + tag] = c._device_ms(
            lambda: klt_cuda.track_fb(*fb))
        if (win, L) in WIDE_POINTS:
            out["klt_pyramid@" + tag] = c._device_ms(
                lambda: klt_cuda.track_pyramid(pyr0, g0, pyr1, pts, valid,
                                               win, ITERS, EPS))
        if (win, L) in c.DOMAIN_POINTS or (win, L) == (21, 3):
            p_k = klt_cuda.track_pyramid(pyr0, g0, pyr1, pts, valid, win,
                                         ITERS, EPS)[0]
            guess = (0.5 * (p_k - pts)).contiguous()
            out["klt_pyramid@" + tag] = c._device_ms(
                lambda: klt_cuda.track_pyramid(pyr0, g0, pyr1, pts, valid,
                                               win, ITERS, EPS))
            out["klt_level@" + tag] = c._device_ms(
                lambda: klt_cuda.track_level(pyr0[0], g0[0][0], g0[0][1],
                                             pyr1[0], pts, guess, valid,
                                             win, ITERS, EPS))
            out["patch_ncc@" + tag] = c._device_ms(
                lambda: klt_cuda.patch_ncc(pyr0[0], pyr1[0], pts, p_k, win))
    raw = c.frame_pair(cfg, dev)[-1]
    blurred, kp, kv = c.brief_inputs(raw, c.N_PATCHES, dev)
    for win in PATCH_WINS:
        out[f"extract_patches@{win}"] = c._device_ms(
            lambda: brief_cuda.extract_patches(blurred, kp, win))
    pattern, taps = brief.pattern_tensor(dev), image.gaussian_taps(2.0)
    out[f"brief_raw_words@{c.N_PATCHES}"] = c._device_ms(
        lambda: brief_cuda.extract_brief_raw(raw, kp, kv, pattern, taps))
    return dict(tree=tree, card=c._card_line(), ms=out)


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        tree = os.path.abspath(sys.argv[2])
        sys.path.insert(0, tree)
        os.chdir(tree)
        print(json.dumps(_measure(tree)), flush=True)
        return
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    a, b = (os.path.abspath(d) for d in sys.argv[1:])
    runs = []
    for tree in (a, b, b, a):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree],
            capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=tree))
        if proc.returncode != 0:
            sys.exit(f"the turn in {tree} failed:\n{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    mean = {t: {k: 0.5 * (runs[i]["ms"][k] + runs[j]["ms"][k])
                for k in runs[i]["ms"]}
            for t, (i, j) in ((a, (0, 3)), (b, (1, 2)))}
    print(json.dumps(dict(
        mean_a=mean[a], mean_b=mean[b],
        b_over_a={k: mean[b][k] / mean[a][k] for k in mean[a]},
        card=runs[0]["card"])))


if __name__ == "__main__":
    main()
