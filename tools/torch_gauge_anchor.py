"""Where the bootstrap prior of chip_smoke.py's phase-9 streams sits
against the ridges of its factorization, and how far a vmapped backend
step parts from the single-stream step, on the CPU (ROADMAP Queue 3).

    PYTHONPATH=. python tools/torch_gauge_anchor.py [--streams 4] \
        [--vmap 1,3]

For each of the first N of chip_smoke._stream_sequences' streams
(default_config(), make_synthetic_window seeds 0.., 10 / 50 Hz): the
least eigenvalues of the bootstrap's Schur complement H_keep against the
ridge and the 100x ridge of _info_to_sqrt, one JSON line each; then for
the streams given to --vmap, the largest pose difference per step
between make_batched_sequence_runner over that one stream and
run_sequence_scan (a vmap of one stream: the CPU's batched LU hangs from
two streams at this size). Put another tree first on PYTHONPATH to
measure its port.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.append(os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from vins_tpu_torch import default_config  # noqa: E402
from vins_tpu_torch.core import marginalization as marg  # noqa: E402
from vins_tpu_torch.core.estimator import run_sequence_scan  # noqa: E402
from vins_tpu_torch.parallel import (make_batched_sequence_runner,  # noqa
                                     stack_inputs, stack_states)


def main(n_streams: int, vmapped) -> None:
    torch.set_num_threads(4)
    cfg = default_config()
    chip_smoke.N_STREAMS = n_streams
    keeps, inner = [], marg._info_to_sqrt

    def probe(H, g, eps, method="chol"):
        keeps.append((H.detach().double().numpy(), eps))
        return inner(H, g, eps, method)

    marg._info_to_sqrt = probe
    try:
        states, seqs, ext, gravity = chip_smoke._stream_sequences(cfg, "cpu")
    finally:
        marg._info_to_sqrt = inner
    for s, (H, eps) in enumerate(keeps[:n_streams]):
        Hs = 0.5 * (H + H.T)
        ridge = eps + 1e-6 * np.abs(np.diag(Hs)).max()
        print(json.dumps(dict(
            stream=s, least=[round(float(w), 3)
                             for w in np.linalg.eigvalsh(Hs)[:4]],
            ridge=round(float(ridge), 3),
            ridge_100x=round(float(100 * ridge), 2))))
    for s in vmapped:
        run = make_batched_sequence_runner(cfg, ext, gravity)
        _, out_b = run(stack_states([states[s]]), stack_inputs([seqs[s]]))
        _, out = run_sequence_scan(states[s], seqs[s], cfg, ext, gravity)
        err = torch.abs(out_b.pose_p[0] - out.pose_p).amax(-1)
        print(json.dumps(dict(stream=s, vmap_against_single_m=[
            float(e) for e in err])))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--vmap", default="1,3")
    a = ap.parse_args()
    main(a.streams, [int(x) for x in a.vmap.split(",") if x])
