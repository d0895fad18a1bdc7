"""Data-parallel VIO: B independent sliding-window streams per step (port
of vins_tpu/parallel/batched.py).

torch.func.vmap runs the select-variant backend step (no host read) over
a leading stream axis: one launch sequence for B windows. Streams are
independent, so a mesh only splits them: each rank takes its `batch`
slice, and no collective runs.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.func import vmap
from torch.utils._pytree import tree_map

from ..config import VinsConfig
from ..core.estimator import (BackendState, FrameInput, backend_step,
                              run_sequence_scan, tree_stack)
from ..core.factors import Extrinsics
from .mesh import BATCH_AXIS, shard_leading


def stack_states(states: Sequence[BackendState]) -> BackendState:
    """Per-stream BackendStates stacked along a new leading axis."""
    return tree_stack(states)


def stack_inputs(inputs: Sequence[FrameInput]) -> FrameInput:
    return tree_stack(inputs)


def _in_dims(tree):
    """vmap's in_dims for a tree: 0 for tensors, None for anything else
    (absent loop inputs, a host iteration budget)."""
    return tree_map(lambda x: 0 if isinstance(x, torch.Tensor) else None,
                    tree)


def _batched(fn: Callable, mesh) -> Callable:
    def run(est_b, inp_b):
        if mesh is not None:
            est_b, inp_b = shard_leading((est_b, inp_b), mesh, BATCH_AXIS)
        return vmap(fn, in_dims=_in_dims((est_b, inp_b)))(est_b, inp_b)
    return run


def make_batched_step(cfg: VinsConfig, ext: Extrinsics,
                      gravity: torch.Tensor, mesh=None) -> Callable:
    """(BackendState[B], FrameInput[B]) -> (state, BackendOutput), every
    leaf [B, ...]. With a mesh, this rank steps its `batch` slice of the
    B streams and returns that slice."""
    return _batched(lambda e, i: backend_step(e, i, cfg, ext, gravity,
                                              select=True), mesh)


def make_batched_sequence_runner(cfg: VinsConfig, ext: Extrinsics,
                                 gravity: torch.Tensor,
                                 mesh=None) -> Callable:
    """(BackendState[B], FrameInput[B, T]) -> (final state[B], outputs
    [B, T]): run_sequence_scan's loop over T inside, vmap over B outside;
    each stream's state is frozen at its last good window on its own
    failure. With a mesh, this rank runs its `batch` slice."""
    return _batched(lambda e, i: run_sequence_scan(e, i, cfg, ext, gravity),
                    mesh)
