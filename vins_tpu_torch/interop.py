"""Carry state between the JAX package and the port as numpy trees.

A VIO system has no weights: its parameters are the carried state
(ScanState with its TrackerState, PnpWindow and BackendState, and the
ImuChunk, FeatureTable and WindowState inside them). The port's
NamedTuples mirror the JAX ones field for field, so a tree fetched from
JAX (e.g. with jax.device_get, on the caller's side — this module never
sees JAX) maps onto a port type by field name. Port-only fields without a
JAX counterpart (TrackerState.gen, the torch.Generator standing in for
the JAX PRNG key) are taken from `like`.

Packed BRIEF words are uint32 in the JAX package and int32 bit patterns in
the port (PyTorch has no shifts on uint32): they cross as bit patterns,
with a view, never by value.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(tree: Any, like: Any, device=None) -> Any:
    """Convert a numpy tree onto the structure, dtypes and device of the
    port value `like` (a NamedTuple, tuple, tensor, int/bool or None)."""
    if isinstance(like, torch.Tensor):
        dev = like.device if device is None else device
        # np.array copies: arrays fetched from JAX are read-only.
        arr = np.array(tree)
        if arr.dtype == np.uint32 and like.dtype == torch.int32:
            arr = arr.view(np.int32)
        return torch.as_tensor(arr, device=dev).to(like.dtype)
    if isinstance(like, torch.Generator) or like is None:
        return like
    if isinstance(like, bool):
        return bool(np.asarray(tree))
    if isinstance(like, int):
        return int(np.asarray(tree))
    if isinstance(like, float):
        return float(np.asarray(tree))
    if _is_namedtuple(like):
        vals = []
        for name, sub in zip(like._fields, like):
            src = getattr(tree, name, None)
            vals.append(sub if src is None and not isinstance(
                sub, torch.Tensor) else to_torch(src, sub, device))
        return type(like)(*vals)
    if isinstance(like, (tuple, list)):
        return type(like)(to_torch(t, s, device) for t, s in zip(tree, like))
    raise TypeError(f"to_torch: unsupported template {type(like)}")


def to_numpy(tree: Any, like: Any = None) -> Any:
    """The port tree with every tensor as a host numpy array (generators
    dropped to None). like: an optional JAX-side tree of the same
    structure; an int32 tensor whose counterpart there is uint32 comes
    back as uint32 words, bit for bit."""
    if isinstance(tree, torch.Tensor):
        arr = tree.detach().cpu().numpy()
        if (arr.dtype == np.int32 and like is not None
                and np.dtype(getattr(like, "dtype", None)) == np.uint32):
            arr = arr.view(np.uint32)
        return arr
    if isinstance(tree, torch.Generator):
        return None
    if isinstance(tree, (tuple, list)):
        subs = like if like is not None else [None] * len(tree)
        vals = [to_numpy(x, s) for x, s in zip(tree, subs)]
        return type(tree)(*vals) if _is_namedtuple(tree) else type(tree)(
            vals)
    return tree
