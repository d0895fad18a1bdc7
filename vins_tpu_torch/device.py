"""The device an entry point runs on: the first CUDA card unless the
caller names one. Without a card the default raises; nothing carries on
on the CPU unless the caller asks for it (the tests pass device="cpu").
Also the port's one-copy fetch of several device tensors."""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """torch.device(device), or cuda:0 for None (RuntimeError without a
    CUDA card)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "vins_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", 0)


def fetch_flat(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Several device tensors to host numpy arrays in ONE device-to-host
    copy (one stream synchronization): each is flattened to one dtype,
    concatenated, copied, split and cast back. The dtype is float32 —
    exact for the bool, float16, float32 and small-integer leaves the
    pipeline fetches — or float64 when a leaf is float64 or int64."""
    if not tensors:
        return []
    wide = any(t.dtype in (torch.float64, torch.int64) for t in tensors)
    flat_dt = torch.float64 if wide else torch.float32
    flat = torch.cat([t.reshape(-1).to(flat_dt) for t in tensors])
    host = flat.cpu().numpy()
    out, o = [], 0
    for t in tensors:
        n = t.numel()
        dt = {torch.bool: np.bool_, torch.float16: np.float16,
              torch.int32: np.int32, torch.int64: np.int64,
              torch.float64: np.float64}.get(t.dtype, np.float32)
        out.append(host[o:o + n].reshape(tuple(t.shape)).astype(dt))
        o += n
    return out


def host_args(*xs):
    """The arguments with every tensor among them fetched to numpy by one
    fetch_flat call (one copy); other values are passed through. Returns
    a list in the order given."""
    idx = [i for i, x in enumerate(xs) if isinstance(x, torch.Tensor)]
    got = fetch_flat([xs[i].detach() for i in idx])
    out = list(xs)
    for i, g in zip(idx, got):
        out[i] = g
    return out
