"""test_torch_stream_shipped.py at one runtime-window point, (15, 4) at
this 192x256 scale. (15, 5) is out of the Pallas kernel's reach here: its
coarsest level is 12x16, narrower than the window, and the interpret-mode
kernel reads outside that level's VMEM buffer (an IndexError). The
reference's bootstrap prior is NaN here too, so it goes on from the
port's (test_torch_stream.carry_bootstrap_priors)."""
import pytest
import torch

from test_torch_stream import CFG, check_per_frame, run_streams
from test_torch_stream_shipped import (parted_at, reference_prior_is_nan,
                                       shipped)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def streams():
    return run_streams(*shipped(15, 4), tpu_branch=True, carry=True,
                       branches=True)


def test_shipped_window_stream_matches_jax_per_frame(streams):
    """The per-frame checks and bounds of test_torch_stream.py at window
    15 and 4 levels, klt_eps 0.01, against the JAX package's TPU branch:
    decisions on every frame, poses up to the first solve that uses a
    prior the two packages factorized on different branches (parted_at).
    Here that is the second prior: both packages form its Schur
    complement with a float32 eigen-pseudo-inverse, whose round-off left
    the port's indefinite by 9.0 (the 100x ridge, at 14.0) and the
    reference's positive semidefinite (the ridge), so from the frame that
    uses it the two part by more than the bounds (5.8e-3 rad six frames
    later; ROADMAP Queue 3, the NaN marginalization prior;
    test_torch_stream.py::test_bootstrap_schur_spreads_in_both_packages).
    The poses compared are those of the bootstrap and of the first
    backend frame's block, which the port's bootstrap prior alone holds.
    Both packages' failure detection fires on the same frame, one block
    and a half after the bootstrap (they track 8-18 features between
    backend frames here)."""
    _, outs_j, outs_t, rec = streams
    assert len(rec["t"]) == len(rec["j"]) == 1
    upto = parted_at(rec, outs_t)
    check_per_frame(outs_j, outs_t, min_init=2 * CFG.freq, upto=upto)
    fail = [k for k, o in enumerate(outs_t) if o.status == "FAILURE"]
    assert fail == [k for k, o in enumerate(outs_j)
                    if o.status == "FAILURE"]


def test_reference_bootstrap_prior_is_nan(streams):
    """As at (21, 3): the reference's own bootstrap prior is NaN, the
    port's finite."""
    _, _, _, rec = streams
    assert reference_prior_is_nan(rec)
    assert torch.all(torch.isfinite(rec["t"][0].prior.J))
