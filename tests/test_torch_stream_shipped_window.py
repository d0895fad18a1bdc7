"""test_torch_stream_shipped.py at one runtime-window point, (15, 4) at
this 192x256 scale. (15, 5) is out of the Pallas kernel's reach here: its
coarsest level is 12x16, narrower than the window, and the interpret-mode
kernel reads outside that level's VMEM buffer (an IndexError). The
reference's bootstrap prior is NaN here too, so it goes on from the
port's priors (test_torch_stream.carry_priors)."""
import pytest
import torch

import torch_watchdog
from test_torch_stream import (CFG, check_carried_priors, check_per_frame,
                               run_streams)
from test_torch_stream_shipped import reference_prior_is_nan, shipped

pytest_plugins = ["torch_watchdog"]

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def streams(request):
    """Both streams at (15, 4), built once per test run
    (torch_watchdog.once_per_run)."""
    return torch_watchdog.once_per_run(
        request, lambda: run_streams(*shipped(15, 4), tpu_branch=True))


def test_shipped_window_stream_matches_jax_per_frame(streams):
    """The per-frame checks and bounds of test_torch_stream.py at window
    15 and 4 levels, klt_eps 0.01, against the JAX package's TPU branch,
    on every frame. With its own priors the reference parted from the
    port from the frame that used the second prior: its float32 eigen
    pseudo-inverse left that Schur complement positive semidefinite (the
    ridge) and the port's eigen form 9.0 below zero (the 100x ridge, at
    14.0), ROADMAP item 31; both now go on from the port's priors, which
    hold the reference's own of the same inputs (check_carried_priors).
    Both packages' failure detection fires on the same frame, one block
    and a half after the bootstrap (they track 8-18 features between
    backend frames here)."""
    _, outs_j, outs_t, rec = streams
    assert len(rec["t"]) == len(rec["j"]) == 1
    check_per_frame(outs_j, outs_t, min_init=2 * CFG.freq)
    fail = [k for k, o in enumerate(outs_t) if o.status == "FAILURE"]
    assert fail == [k for k, o in enumerate(outs_j)
                    if o.status == "FAILURE"]
    check_carried_priors(rec)


def test_reference_bootstrap_prior_is_nan(streams):
    """As at (21, 3): the reference's own bootstrap prior is NaN, the
    port's finite."""
    _, _, _, rec = streams
    assert reference_prior_is_nan(rec)
    assert torch.all(torch.isfinite(rec["t"][0].prior.J))
