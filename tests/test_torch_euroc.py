"""The port's EuRoC entry point end to end on the CPU:
vins_tpu_torch.run_euroc.main over the in-repo ASL fixture that
tests/test_euroc_path.py runs the JAX example on (80 frames, seed 5,
distorted 752x480 PNGs, 200 Hz IMU with bias walk), frame by frame with
loop closure off. The system initializes itself; the gate is the JAX
test's own: 79 frames and an aligned ATE under 0.10 m."""
import os

import numpy as np
import torch

from conftest import asl_fixture_cached

from vins_tpu_torch import run_euroc

torch.set_num_threads(1)


def test_run_euroc_end_to_end(tmp_path):
    """run_euroc.main(--no-loop, --device cpu) returns 79 frames and an
    aligned ATE under 0.10 m (tests/test_euroc_path.py:93's bound: the
    JAX path measured about 0.07 m there), and writes run.npz with one
    row per frame."""
    root, _ = asl_fixture_cached(n_frames=80, seed=5)
    out = str(tmp_path / "out")
    result = run_euroc.main(["--root", root, "--no-loop", "--device", "cpu",
                             "--out", out])
    assert result["frames"] == 79
    assert "ate_rmse" in result, "the system never initialized"
    assert result["ate_rmse"] < 0.10, result
    assert result["ate_rmse"] == result["ate_rmse_raw"]   # no loop closure
    assert np.isfinite(result["rpe_30"])
    with np.load(os.path.join(out, "run.npz")) as z:
        assert z["p"].shape == (79, 3) and z["initialized"].any()
