"""The device an entry point runs on: the first CUDA card unless the
caller names one. Without a card the default raises; nothing carries on
on the CPU unless the caller asks for it (the tests pass device="cpu")."""
from __future__ import annotations

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
