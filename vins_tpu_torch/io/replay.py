"""Record and playback (port of vins_tpu/io/replay.py): per-frame sensor
inputs and outputs stacked into one compressed npz, and checkpoints of
the port's state.

A checkpoint holds a NamedTuple/tuple/list tree of tensors as numpy
leaves plus its structure (the NamedTuple classes by module and name,
the leaves' dtypes and devices), pickled. It does not read the JAX
package's checkpoints, which pickle JAX treedefs; carry JAX state across
with interop.to_torch instead.
"""
from __future__ import annotations

import importlib
import pickle
from typing import Any, Dict, List

import numpy as np
import torch


class Recorder:
    """Accumulates per-frame arrays, then saves them stacked."""

    def __init__(self):
        self.frames: List[Dict[str, Any]] = []

    def add(self, **arrays):
        self.frames.append({k: np.asarray(v) for k, v in arrays.items()})

    def save(self, path: str):
        if not self.frames:
            raise ValueError("nothing recorded")
        keys = self.frames[0].keys()
        stacked = {k: np.stack([f[k] for f in self.frames]) for k in keys}
        np.savez_compressed(path, **stacked)

    @staticmethod
    def load(path: str) -> Dict[str, np.ndarray]:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


def _flatten(tree):
    """(structure, leaves): tensors become numpy leaves, a generator its
    state; tuples, lists and NamedTuples are walked; any other value is
    kept in the structure."""
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x.detach().cpu().numpy())
            return ("tensor", str(x.dtype).replace("torch.", ""),
                    str(x.device))
        if isinstance(x, torch.Generator):
            return ("generator", str(x.device), x.get_state().numpy())
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return ("namedtuple", type(x).__module__, type(x).__qualname__,
                    [walk(v) for v in x])
        if isinstance(x, (tuple, list)):
            return (type(x).__name__, [walk(v) for v in x])
        return ("value", x)

    return walk(tree), leaves


def _unflatten(struct, leaves, device=None):
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == "tensor":
            dev = device if device is not None else s[2]
            return torch.as_tensor(next(it), dtype=getattr(torch, s[1]),
                                   device=dev)
        if kind == "generator":
            gen = torch.Generator(device=device if device is not None
                                  else s[1])
            gen.set_state(torch.as_tensor(s[2]))
            return gen
        if kind == "namedtuple":
            cls = getattr(importlib.import_module(s[1]), s[2])
            return cls(*[build(v) for v in s[3]])
        if kind in ("tuple", "list"):
            vals = [build(v) for v in s[1]]
            return tuple(vals) if kind == "tuple" else vals
        return s[1]

    return build(struct)


def save_checkpoint(path: str, state) -> None:
    """Snapshot a tree of tensors (estimator state, keyframe DB, ...)."""
    struct, leaves = _flatten(state)
    with open(path, "wb") as f:
        pickle.dump({"structure": struct, "leaves": leaves}, f)


def load_checkpoint(path: str, device=None):
    """The saved tree, each tensor on its saved device unless `device` is
    given."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return _unflatten(payload["structure"], payload["leaves"], device)
