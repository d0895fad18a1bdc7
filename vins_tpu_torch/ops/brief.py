"""BRIEF descriptors and Hamming matching (port of vins_tpu/ops/brief.py).

Descriptors are [N, 8] int32 tensors holding the bit patterns of the JAX
package's packed uint32 words (PyTorch has no shifts or popcount on
uint32). extract_brief reads the 256 test pairs from the raw frame
through kernel K3 (ops/brief_cuda.extract_brief_raw), which fuses the
Gaussian blur: one launch per call on the card. It keeps the TPU
semantics of a clamped subpixel-aligned patch per keypoint. Hamming
distances use a SWAR popcount on int64, the stand-in for
jax.lax.population_count.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import brief_cuda
from . import image as image_mod
from .brief_cuda import BRIEF_BITS, BRIEF_WORDS, PATCH_HALF, pack_bits

__all__ = ["BRIEF_BITS", "BRIEF_WORDS", "PATCH_HALF", "pack_bits",
           "make_pattern", "pattern_tensor", "popcount32", "extract_brief",
           "hamming_matrix", "MatchResult", "match_descriptors",
           "global_descriptor", "unpack_bits"]


def make_pattern(seed: int = 7) -> np.ndarray:
    """[256, 4] (x1, y1, x2, y2) integer test-pair offsets, N(0, (S/5)²)
    clipped to the 48x48 patch — the JAX package's seeded pattern."""
    rng = np.random.default_rng(seed)
    sigma = PATCH_HALF / 2.0
    pts = rng.normal(0.0, sigma, (BRIEF_BITS, 4))
    return np.rint(
        np.clip(pts, -PATCH_HALF, PATCH_HALF)).astype(np.float32)


_PATTERN = make_pattern()


@functools.lru_cache(maxsize=None)
def pattern_tensor(device: torch.device) -> torch.Tensor:
    """The pattern as a [256, 4] int32 tensor on `device` (cached: a fresh
    host-to-device copy would synchronize the stream)."""
    return torch.as_tensor(_PATTERN.astype(np.int32), device=device)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, as int64 (SWAR popcount)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def extract_brief(img: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor,
                  blur_sigma: float = 2.0) -> torch.Tensor:
    """Packed BRIEF descriptors [N, 8] int32 of keypoints pts [N, 2] (pixel
    x, y) on the raw frame img [H, W]; invalid rows are 0."""
    return brief_cuda.extract_brief_raw(
        img.contiguous(), pts.to(torch.float32).contiguous(),
        valid.contiguous(), pattern_tensor(pts.device),
        image_mod.gaussian_taps(blur_sigma))


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distances: [N, 8] x [M, 8] words -> [N, M] int32."""
    x = popcount32(torch.bitwise_xor(a[:, None, :], b[None, :, :]))
    return torch.sum(x, dim=-1).to(torch.int32)


class MatchResult(NamedTuple):
    idx: torch.Tensor    # [N] best match in b for each a (int32)
    dist: torch.Tensor   # [N] best Hamming distance
    ok: torch.Tensor     # [N] passes distance + ratio gates


def match_descriptors(a: torch.Tensor, b: torch.Tensor,
                      a_valid: torch.Tensor, b_valid: torch.Tensor,
                      max_dist: int = 80, ratio: float = 1.0) -> MatchResult:
    """Nearest-neighbour Hamming matching with the distance gate and, for
    ratio < 1, the best/second-best neigh-ratio gate."""
    big = torch.full((), 10_000, dtype=torch.int32, device=a.device)
    d = hamming_matrix(a, b)
    d = torch.where(b_valid[None, :], d, big)
    d = torch.where(a_valid[:, None], d, big)
    idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, idx[:, None])[:, 0]
    d2 = d.scatter(1, idx[:, None], big.expand(d.shape[0], 1))
    second = torch.amin(d2, dim=1)
    ok = (best < max_dist) & a_valid
    if ratio < 1.0:
        ok = ok & (best.to(torch.float32)
                   <= ratio * second.to(torch.float32))
    return MatchResult(idx=idx.to(torch.int32), dist=best, ok=ok)


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 words -> [N, 256] float32 of 0/1."""
    shifts = torch.arange(32, dtype=torch.int64, device=desc.device)
    b = ((desc.to(torch.int64)[:, :, None] & 0xFFFFFFFF) >> shifts) & 1
    return b.reshape(desc.shape[0], -1).to(torch.float32)


def global_descriptor(desc: torch.Tensor, valid: torch.Tensor,
                      pts: torch.Tensor, shape: Tuple[int, int]
                      ) -> torch.Tensor:
    """Spatially pooled bit statistics over a 2x2 grid: per cell the mean
    of each bit minus 0.5 (0 for an empty cell), L2-normalized [1024]."""
    H, W = shape
    bits = unpack_bits(desc)
    gx = (pts[:, 0] >= (W / 2)).to(torch.int64)
    gy = (pts[:, 1] >= (H / 2)).to(torch.int64)
    cell = gy * 2 + gx
    w = valid.to(torch.float32)
    cells = []
    for c in range(4):
        m = w * (cell == c)
        s = torch.sum(m)
        mean = torch.sum(bits * m[:, None], 0) / torch.clamp(s, min=1.0)
        cells.append(torch.where(s > 0, mean - 0.5, 0.0))
    g = torch.cat(cells)
    n = torch.sqrt(torch.sum(g * g))
    return g / torch.clamp(n, min=1e-8)
