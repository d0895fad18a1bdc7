"""The revisit lockstep's BRIEF words against float64, on the CPU: the
readout of tests/torch_brief_check.py's check_brief on
tests/test_torch_interactive_revisit.py's record, and
how far each package's float32 pair margins lie from their float64
values.

    JAX_PLATFORMS=cpu python tools/torch_brief_margins.py

It runs the lockstep (build_revisit, about 5 minutes with 8 cores) and
prints
check_brief's readout (every bit where the two packages' words differ,
with its row, frame, keypoint, positions, pattern pair, bits and float64
margins) or its failure, then one JSON line: per keyframe row its insert
frame, the smallest float64 margin of a kept keypoint's pair in ulps of
the pair's larger float32 tap, and, at the reference's stored keypoints,
the largest distance in those ulps between the float64 margin at the
exact tap positions and each package's float32 one: the reference's
(vins_tpu.ops.image.gaussian_blur and bilinear_sample, as its CPU
branch of extract_brief computes them: each tap's position rounded to
float32 on its own) and the port's (ops/image.py's blur, one fraction
for every tap from the patch corner, the bilinear blend in the order of
brief_cuda.extract_brief_words_plain). The largest of those readings is
what ULP_BOUND in tests/torch_brief_check.py is measured against.
"""
import json
import os
import sys

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def _port_margins(raw, pts, pat):
    """The port's float32 margins at pts [N, 2]: its blur, then each tap
    read as extract_brief_words_plain reads it: one fraction from the
    patch corner pts - PATCH_HALF for every tap, the taps blended in its
    order (no corner clamp: the stored keypoints lie inside the insert
    border)."""
    import torch
    from vins_tpu_torch.ops import image as t_image
    from vins_tpu_torch.ops.brief import PATCH_HALF

    img = t_image._sep_filter(torch.as_tensor(raw),
                              t_image.gaussian_taps(2.0))
    c = torch.as_tensor(pts, dtype=torch.float32) - PATCH_HALF
    fl = torch.floor(c)
    fx, fy = (c - fl)[:, :1], (c - fl)[:, 1:]
    gx, gy = 1 - fx, 1 - fy
    ix = fl[:, :1].long() + PATCH_HALF
    iy = fl[:, 1:].long() + PATCH_HALF
    p = torch.as_tensor(pat).long()

    def tap(ox, oy):
        x, y = ix + ox[None, :], iy + oy[None, :]
        a, b = img[y, x], img[y, x + 1]
        c_, d = img[y + 1, x], img[y + 1, x + 1]
        return gy * (gx * a + fx * b) + fy * (gx * c_ + fx * d)

    ia, ib = tap(p[:, 0], p[:, 1]), tap(p[:, 2], p[:, 3])
    return ib.double().numpy() - ia.double().numpy()


def _reference_margins(raw, pts, pat):
    """The reference's float32 margins at pts, as its CPU extract_brief
    samples them."""
    import jax.numpy as jnp
    from vins_tpu.ops import image as j_image

    img = j_image.gaussian_blur(jnp.asarray(raw), 2.0)
    n = pts.shape[0]

    def tap(ox, oy):
        q = np.stack(np.broadcast_arrays(pts[:, :1] + ox, pts[:, 1:] + oy),
                     -1).reshape(-1, 2).astype(np.float32)
        return np.asarray(j_image.bilinear_sample(img, jnp.asarray(q)),
                          np.float64).reshape(n, -1)

    return tap(pat[:, 2], pat[:, 3]) - tap(pat[:, 0], pat[:, 1])


def main() -> None:
    import conftest  # noqa: F401  (JAX on the CPU, as the tests run it)
    import test_torch_interactive_revisit as tr
    import torch_brief_check as bc

    rec = tr.build_revisit()
    try:
        print("\n".join(bc.check_brief(rec)))
    except AssertionError as e:
        print(e)
    dj = rec["db_j"]
    pat = tr.t_brief.make_pattern()
    rows = []
    for r in range(dj["count"]):
        frame = dict(rec["rows_j"])[r]
        raw = rec["frames"][frame]
        pts = dj["kp_px"][r][dj["kp_ok"][r]]
        m64, ulp = bc.margins64(bc.blur64(raw), pts)
        rows.append(dict(
            row=r, frame=frame, keypoints=int(len(pts)),
            least_margin_ulp=float(np.min(np.abs(m64) / ulp)),
            port_error_ulp=float(np.max(np.abs(
                _port_margins(raw, pts, pat) - m64) / ulp)),
            reference_error_ulp=float(np.max(np.abs(
                _reference_margins(raw, pts, pat) - m64) / ulp))))
    print(json.dumps(dict(
        rows=rows, ulp_bound=bc.ULP_BOUND, kp_tol=bc.KP_TOL,
        largest_error_ulp=max(max(r["port_error_ulp"],
                                  r["reference_error_ulp"]) for r in rows),
        least_margin_ulp=min(r["least_margin_ulp"] for r in rows))))


if __name__ == "__main__":
    main()
