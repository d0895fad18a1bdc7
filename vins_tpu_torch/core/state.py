"""Fixed-shape window state and factor tables (port of
vins_tpu/core/state.py). F = window frames, M = landmark slots."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import lie


class WindowState(NamedTuple):
    p: torch.Tensor           # [F, 3] world positions
    q: torch.Tensor           # [F, 4] wxyz world-from-body
    v: torch.Tensor           # [F, 3]
    ba: torch.Tensor          # [F, 3]
    bg: torch.Tensor          # [F, 3]
    inv_depth: torch.Tensor   # [M] inverse depth at the anchor frame

    @staticmethod
    def identity(F: int, M: int, dtype=torch.float32,
                 device="cpu") -> "WindowState":
        z = torch.zeros((F, 3), dtype=dtype, device=device)
        return WindowState(
            p=z, q=lie.quat_identity(dtype, device).repeat(F, 1),
            v=z.clone(), ba=z.clone(), bg=z.clone(),
            inv_depth=torch.full((M,), 0.2, dtype=dtype, device=device))


class FeatureTable(NamedTuple):
    obs: torch.Tensor       # [F, M, 2] normalized observations
    mask: torch.Tensor      # [F, M] bool
    anchor: torch.Tensor    # [M] int32 anchor frame
    valid: torch.Tensor     # [M] bool: live track with >= 2 obs
    track_id: torch.Tensor  # [M] int32 (-1 = free slot)

    @staticmethod
    def empty(F: int, M: int, dtype=torch.float32,
              device="cpu") -> "FeatureTable":
        return FeatureTable(
            obs=torch.zeros((F, M, 2), dtype=dtype, device=device),
            mask=torch.zeros((F, M), dtype=torch.bool, device=device),
            anchor=torch.zeros((M,), dtype=torch.int32, device=device),
            valid=torch.zeros((M,), dtype=torch.bool, device=device),
            track_id=torch.full((M,), -1, dtype=torch.int32, device=device))


class PriorFactor(NamedTuple):
    """Dense linearized marginalization prior: r(x) = r0 + J0 (x ⊟ x̄)."""

    J: torch.Tensor       # [D, D] (D = 15 F)
    r: torch.Tensor       # [D]
    lin_p: torch.Tensor   # [F, 3]
    lin_q: torch.Tensor   # [F, 4]
    lin_v: torch.Tensor   # [F, 3]
    lin_ba: torch.Tensor  # [F, 3]
    lin_bg: torch.Tensor  # [F, 3]
    weight: torch.Tensor  # [] 1 active, 0 before the first marginalization

    @staticmethod
    def empty(F: int, dtype=torch.float32, device="cpu") -> "PriorFactor":
        D = 15 * F
        z = torch.zeros((F, 3), dtype=dtype, device=device)
        return PriorFactor(
            J=torch.zeros((D, D), dtype=dtype, device=device),
            r=torch.zeros((D,), dtype=dtype, device=device),
            lin_p=z, lin_q=lie.quat_identity(dtype, device).repeat(F, 1),
            lin_v=z.clone(), lin_ba=z.clone(), lin_bg=z.clone(),
            weight=torch.zeros((), dtype=dtype, device=device))


def state_boxminus(s: WindowState, prior: PriorFactor) -> torch.Tensor:
    """[15 F] tangent of the state around the prior's linearization point."""
    return torch.cat([s.p - prior.lin_p, lie.quat_boxminus(s.q, prior.lin_q),
                      s.v - prior.lin_v, s.ba - prior.lin_ba,
                      s.bg - prior.lin_bg], -1).reshape(-1)


def retract_window(s: WindowState, delta_c: torch.Tensor,
                   delta_l: torch.Tensor) -> WindowState:
    F = s.p.shape[0]
    d = delta_c.reshape(F, 15)
    p, q = lie.pose_retract(s.p, s.q, d[:, 0:6])
    return WindowState(p=p, q=q, v=s.v + d[:, 6:9], ba=s.ba + d[:, 9:12],
                       bg=s.bg + d[:, 12:15],
                       inv_depth=s.inv_depth + delta_l)
