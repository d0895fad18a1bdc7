"""Shi–Tomasi response, spacing-aware corner selection and the FAST score
(port of vins_tpu/ops/corners.py: shi_tomasi_response,
select_corners_grid, occupancy_cells, fast_score)."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as nnf

from .image import _sep_filter, sobel_gradients


def shi_tomasi_response(img: torch.Tensor, block: int = 3) -> torch.Tensor:
    """Min-eigenvalue of the block-averaged structure tensor."""
    gx, gy = sobel_gradients(img)
    # The JAX band matrix holds 1/block as float32.
    k = (float(torch.tensor(1.0 / block, dtype=torch.float32)),) * block
    gxx = _sep_filter(gx * gx, k)
    gyy = _sep_filter(gy * gy, k)
    gxy = _sep_filter(gx * gy, k)
    tr = gxx + gyy
    det = gxx * gyy - gxy * gxy
    return 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))


class CornerPick(NamedTuple):
    pts: torch.Tensor    # [K, 2] (x, y)
    score: torch.Tensor  # [K]
    valid: torch.Tensor  # [K] bool


def _sorted_desc(x: torch.Tensor, k: int):
    """Top-k, ties broken toward the lower index (lax.top_k order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def select_corners_grid(response: torch.Tensor, occupied: torch.Tensor,
                        k: int, cell: int,
                        quality_frac: float = 0.01) -> CornerPick:
    """Up to k corners, one per cell of side `cell`, skipping occupied
    cells. occupied: [H//cell, W//cell] bool cell mask (occupancy_cells)
    or a [H, W] bool pixel mask."""
    H, W = response.shape
    gh, gw = H // cell, W // cell
    cell_mask = tuple(occupied.shape) == (gh, gw)
    ninf = float("-inf")
    resp = response if cell_mask else \
        torch.where(occupied, ninf, response)
    resp = resp.clone()
    resp[:8, :] = ninf
    resp[-8:, :] = ninf
    resp[:, :8] = ninf
    resp[:, -8:] = ninf

    tiles = resp[:gh * cell, :gw * cell].reshape(gh, cell, gw, cell)
    tiles = tiles.transpose(1, 2).reshape(gh * gw, cell * cell)
    best = torch.amax(tiles, dim=1)
    arg = torch.argmax(tiles, dim=1)      # first maximum, as jnp.argmax
    if cell_mask:
        best = torch.where(occupied.reshape(-1), ninf, best)

    thresh = quality_frac * torch.max(response)
    ok_cell = best > thresh
    score, idx = _sorted_desc(torch.where(ok_cell, best, ninf),
                              min(k, gh * gw))
    cy = idx // gw
    cx = idx % gw
    ay = arg[idx] // cell
    ax = arg[idx] % cell
    pts = torch.stack([(cx * cell + ax).to(response.dtype),
                       (cy * cell + ay).to(response.dtype)], -1)
    valid = torch.isfinite(score)
    return CornerPick(pts=pts, score=torch.where(valid, score, 0.0),
                      valid=valid)


def occupancy_mask(shape: Tuple[int, int], pts: torch.Tensor,
                   valid: torch.Tensor, radius: int) -> torch.Tensor:
    """[H, W] bool: True within `radius` px of a valid feature (the
    reference's setMask disc mask, dense over [H, W] x [M]; the tracker
    uses the cell-level occupancy_cells)."""
    H, W = shape
    yy = torch.arange(H, dtype=pts.dtype, device=pts.device)[:, None, None]
    xx = torch.arange(W, dtype=pts.dtype, device=pts.device)[None, :, None]
    d2 = (xx - pts[None, None, :, 0]) ** 2 + (yy - pts[None, None, :, 1]) ** 2
    return torch.any((d2 < radius * radius) & valid[None, None, :], dim=-1)


def occupancy_cells(shape: Tuple[int, int], pts: torch.Tensor,
                    valid: torch.Tensor, cell: int) -> torch.Tensor:
    """[H//cell, W//cell] bool: True where a cell center lies within
    `cell` px of a valid feature (no new corner there)."""
    H, W = shape
    gh, gw = H // cell, W // cell
    cy = (torch.arange(gh, dtype=pts.dtype, device=pts.device) + 0.5) * cell
    cx = (torch.arange(gw, dtype=pts.dtype, device=pts.device) + 0.5) * cell
    d2 = ((cx[None, :, None] - pts[None, None, :, 0]) ** 2
          + (cy[:, None, None] - pts[None, None, :, 1]) ** 2)
    r = cell
    return torch.any((d2 < r * r) & valid[None, None, :], dim=-1)


# Bresenham-16 circle of FAST, (dx, dy) in ring order.
_FAST_RING = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2),
              (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1),
              (-2, -2), (-1, -3))


def fast_score(img: torch.Tensor, threshold: float = 0.04) -> torch.Tensor:
    """FAST-9 response for the loop-closure keypoints: a pixel is a corner
    if >= 9 contiguous ring neighbours (edge-padded) are all brighter than
    centre + t or all darker than centre - t; its score is the sum of
    |ring - centre| over the 16 neighbours, 0 elsewhere."""
    H, W = img.shape
    pad = 3
    imp = nnf.pad(img[None, None], (pad, pad, pad, pad),
                  mode="replicate")[0, 0]
    ring = torch.stack([imp[pad + dy:pad + dy + H, pad + dx:pad + dx + W]
                        for dx, dy in _FAST_RING])
    bright = ring > img[None] + threshold
    dark = ring < img[None] - threshold

    def arc9(flags):
        doubled = torch.cat([flags, flags[:9]], 0)
        return torch.stack([torch.all(doubled[s:s + 9], 0)
                            for s in range(16)]).any(0)

    is_corner = arc9(bright) | arc9(dark)
    score = torch.sum(torch.abs(ring - img[None]), 0)
    return torch.where(is_corner, score, 0.0)
