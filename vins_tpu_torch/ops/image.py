"""Image ops: separable filters, pyramids, bilinear sampling, CLAHE
(port of vins_tpu/ops/image.py).

The JAX module writes every filter as a banded Toeplitz matmul because
that is what the TPU's matrix unit runs fast. Here they are what the band
matrices encode: reflect-101 correlations with the same taps, applied as
a sum of shifted gathers per axis (rows first, then columns), optionally
decimated. Images are [..., H, W] float32 in [0, 1]; every function
broadcasts over leading batch dimensions, so one call prepares a whole
block of frames.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _reflect_index(n: int, p: int, t: int, decimate: int,
                   device: torch.device) -> torch.Tensor:
    """Source index of tap t (kernel radius p) for outputs 0, d, 2d, ...
    under reflect-101 padding — the index _band_np places tap t at.
    Cached per device: a fresh host-to-device copy would sync the stream."""
    j = np.arange(0, n, decimate) + t - p
    j = np.where(j < 0, -j, j)
    return torch.as_tensor(np.where(j >= n, 2 * n - 2 - j, j), device=device)


def _filter_axis(x: torch.Tensor, kernel: Tuple[float, ...], axis: int,
                 decimate: int = 1) -> torch.Tensor:
    n = x.shape[axis]
    p = len(kernel) // 2
    out = None
    for t, kv in enumerate(kernel):
        if kv == 0.0:
            continue
        idx = _reflect_index(n, p, t, decimate, x.device)
        term = kv * x.index_select(axis, idx)
        out = term if out is None else out + term
    return out


def _sep_filter(img: torch.Tensor, kernel: Tuple[float, ...],
                decimate: int = 1) -> torch.Tensor:
    """Separable reflect-101 filter (rows, then columns), optionally with
    2D decimation (pyr_down)."""
    return _filter_axis(_filter_axis(img, kernel, img.dim() - 2, decimate),
                        kernel, img.dim() - 1, decimate)


@functools.lru_cache(maxsize=None)
def gaussian_taps(sigma: float = 1.0, radius: int = 2) -> Tuple[float, ...]:
    """The 2 * radius + 1 normalized Gaussian taps, each a float32 value
    (the JAX band matrix holds them as float32). gaussian_blur and the
    fused BRIEF kernel (ops/brief_cuda.extract_brief_raw) both read them
    here."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = k / np.sum(k)
    return tuple(float(np.float32(v)) for v in k)


def gaussian_blur(img: torch.Tensor, sigma: float = 1.0,
                  radius: int = 2) -> torch.Tensor:
    return _sep_filter(img, gaussian_taps(sigma, radius))


_PYR_K = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """5-tap Gaussian then 2x decimation (cv::pyrDown)."""
    return _sep_filter(img, _PYR_K, decimate=2)


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample a [H, W] image at float (x, y) positions, border-clamped."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * i00 + fx * i01)
            + fy * ((1 - fx) * i10 + fx * i11))


_SCHARR_D = (-0.5, 0.0, 0.5)
_SCHARR_S = (3.0 / 16, 10.0 / 16, 3.0 / 16)


def sobel_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scharr-weighted gradients (what OpenCV's LK uses internally)."""
    rows, cols = img.dim() - 2, img.dim() - 1
    gx = _filter_axis(_filter_axis(img, _SCHARR_S, rows), _SCHARR_D, cols)
    gy = _filter_axis(_filter_axis(img, _SCHARR_D, rows), _SCHARR_S, cols)
    return gx, gy


# ---------------------------------------------------------------------------
# CLAHE
# ---------------------------------------------------------------------------


def clahe(img: torch.Tensor, clip_limit: float = 3.0, grid: int = 8,
          n_bins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization of [..., H, W].

    Same values as vins_tpu.ops.image.clahe. The JAX blend for even tile
    sides contracts a one-hot of the pixel bins against the corner LUTs
    cast to bfloat16 with float32 accumulation, which returns each LUT
    value rounded to bfloat16 exactly; this port gathers from the
    bf16-rounded LUTs and blends in float32 with the same corner tiles
    and weights. Odd tile sides take the JAX gather path's full-precision
    LUTs and clamped fractions.
    """
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    th, tw = H // grid, W // grid
    Hc, Wc = th * grid, tw * grid
    img_c = img[..., :Hc, :Wc]
    v = torch.clamp((img_c * (n_bins - 1)).to(torch.int32), 0, n_bins - 1)
    v = v.long()
    tiles = v.reshape(lead + (grid, th, grid, tw)).transpose(-3, -2)
    tiles = tiles.reshape(lead + (grid * grid, th * tw))

    hist = torch.zeros(lead + (grid * grid, n_bins), dtype=img.dtype,
                       device=img.device)
    hist.scatter_add_(-1, tiles, torch.ones_like(tiles, dtype=img.dtype))

    limit = max(clip_limit * (th * tw) / n_bins, 1.0)
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=-1,
                       keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / n_bins
    cdf = torch.cumsum(hist, dim=-1)
    cdf = (cdf - cdf[..., :1]) / torch.clamp(cdf[..., -1:] - cdf[..., :1],
                                             min=1.0)
    luts = cdf.reshape(lead + (grid, grid, n_bins))

    blocked = th % 2 == 0 and tw % 2 == 0
    if blocked:
        luts = luts.to(torch.bfloat16).to(img.dtype)
    yy = (torch.arange(Hc, dtype=img.dtype, device=img.device) + 0.5) \
        / th - 0.5
    xx = (torch.arange(Wc, dtype=img.dtype, device=img.device) + 0.5) \
        / tw - 0.5
    yf, xf = torch.floor(yy), torch.floor(xx)
    y0 = torch.clamp(yf.long(), 0, grid - 1)
    x0 = torch.clamp(xf.long(), 0, grid - 1)
    if blocked:
        # Half-tile blocks see constant (edge-replicated) neighbor tiles
        # and unclamped fractions (_apply_luts_blocked).
        y1 = torch.clamp(yf.long() + 1, 0, grid - 1)
        x1 = torch.clamp(xf.long() + 1, 0, grid - 1)
        fy = (yy - yf)[:, None]
        fx = (xx - xf)[None, :]
    else:
        y1 = torch.clamp(y0 + 1, 0, grid - 1)
        x1 = torch.clamp(x0 + 1, 0, grid - 1)
        fy = torch.clamp(yy - y0.to(img.dtype), 0.0, 1.0)[:, None]
        fx = torch.clamp(xx - x0.to(img.dtype), 0.0, 1.0)[None, :]

    flat = luts.reshape(lead + (grid * grid * n_bins,))

    def lut_at(gy, gx):
        idx = (gy[:, None] * grid + gx[None, :]) * n_bins + v
        return torch.gather(flat, -1, idx.reshape(lead + (Hc * Wc,))
                            ).reshape(lead + (Hc, Wc))

    out = ((1 - fy) * (1 - fx) * lut_at(y0, x0)
           + (1 - fy) * fx * lut_at(y0, x1)
           + fy * (1 - fx) * lut_at(y1, x0)
           + fy * fx * lut_at(y1, x1))

    if Hc == H and Wc == W:
        return out
    full = torch.zeros_like(img)
    full[..., :Hc, :Wc] = out
    if Hc < H:
        full[..., Hc:, :] = full[..., Hc - 1:Hc, :]
    if Wc < W:
        full[..., :, Wc:] = full[..., :, Wc - 1:Wc]
    return full
