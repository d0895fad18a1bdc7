"""Kernel K3 (BRIEF words from subpixel-aligned patches): the CUDA wrapper
and its plain PyTorch versions.

K3 replaces `_patches_kernel` / `extract_patches_pallas`
(vins_tpu/ops/klt_pallas.py:329-365) together with the one-hot difference
matmul and bit packing that follow it in vins_tpu/ops/brief.extract_brief
(brief.py:89-101); the CUDA source is vins_tpu_torch/csrc/brief.cu. The
port follows the TPU semantics on every device: each keypoint's 49x49
patch corner is clamped once, as `_bilinear_patch` clamps it
(klt_pallas.py:40-46), so every tap of a keypoint within 25 px of a
border shifts with the patch. (The JAX package's CPU branch clamps each
tap alone instead; the two agree only inside the border.)

Descriptors are [N, 8] int32 tensors holding the bit patterns of the
JAX package's packed uint32 words.

Dispatch is on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. Nothing falls back.
The wrapper counts its launches in `extract_brief_words.launches`.
"""
from __future__ import annotations

import torch

from . import native
from .klt_cuda import _check_tensor, _patches, _stream_ptr

PATCH_HALF = 24
PATCH_WIN = 2 * PATCH_HALF + 1     # 49x49 patch
BRIEF_BITS = 256
BRIEF_WORDS = BRIEF_BITS // 32


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, 256] bool -> [N, 8] int32 words; bit j of word w is bit 32w + j
    (brief._pack_bits)."""
    w = bits.reshape(bits.shape[0], BRIEF_WORDS, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(w << shifts, dim=2)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def extract_patches_plain(img: torch.Tensor, pts: torch.Tensor,
                          win: int = PATCH_WIN) -> torch.Tensor:
    """[N, win, win] bilinear patches centred at pts [N, 2] (pixel x, y),
    the corner clamped as extract_patches_pallas clamps it."""
    r = (win - 1) / 2.0
    return _patches(img, pts[:, 0] - r, pts[:, 1] - r, win).reshape(
        pts.shape[0], win, win)


def extract_brief_words_plain(img: torch.Tensor, pts: torch.Tensor,
                              valid: torch.Tensor,
                              pattern: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: the 512 taps the pattern reads from each
    keypoint's clamped patch, blended in the Pallas order, compared and
    packed. img: [H, W] blurred frame; pattern: [256, 4] int32."""
    H, W = img.shape
    r = float(PATCH_HALF)
    hx = W - PATCH_WIN - 1.001
    hy = H - PATCH_WIN - 1.001
    cx = torch.clamp(torch.nan_to_num(pts[:, 0] - r, nan=0.0), 0.0, hx)
    cy = torch.clamp(torch.nan_to_num(pts[:, 1] - r, nan=0.0), 0.0, hy)
    flx, fly = torch.floor(cx), torch.floor(cy)
    ix = flx.long()[:, None] + PATCH_HALF
    iy = fly.long()[:, None] + PATCH_HALF
    fx = (cx - flx)[:, None]
    fy = (cy - fly)[:, None]
    gx, gy = 1 - fx, 1 - fy
    pat = pattern.long()

    def taps(ox, oy):
        x = ix + ox[None, :]
        y = iy + oy[None, :]
        a, b = img[y, x], img[y, x + 1]
        c, d = img[y + 1, x], img[y + 1, x + 1]
        return gy * (gx * a + fx * b) + fy * (gx * c + fx * d)

    bits = taps(pat[:, 2], pat[:, 3]) > taps(pat[:, 0], pat[:, 1])
    return torch.where(valid[:, None], pack_bits(bits),
                       torch.zeros((), dtype=torch.int32,
                                   device=img.device))


def _brief_words_cuda(img, pts, valid, pattern):
    dev = pts.device
    N = pts.shape[0]
    H, W = img.shape
    if H < PATCH_WIN + 2 or W < PATCH_WIN + 2:
        raise ValueError(f"image ({H}x{W}) is smaller than the "
                         f"{PATCH_WIN}x{PATCH_WIN} patch plus its border")
    _check_tensor("img", img, (H, W), torch.float32, dev)
    _check_tensor("pts", pts, (N, 2), torch.float32, dev)
    _check_tensor("valid", valid, (N,), torch.bool, dev)
    _check_tensor("pattern", pattern, (BRIEF_BITS, 4), torch.int32, dev)
    words = torch.empty((N, BRIEF_WORDS), dtype=torch.int32, device=dev)
    status = native.library().vins_brief_words(
        img.data_ptr(), H, W, pts.data_ptr(), valid.data_ptr(),
        pattern.data_ptr(), N, words.data_ptr(), _stream_ptr(dev))
    native.check(status, "vins_brief_words")
    return words


def extract_brief_words(img: torch.Tensor, pts: torch.Tensor,
                        valid: torch.Tensor,
                        pattern: torch.Tensor) -> torch.Tensor:
    """K3: [N, 8] int32 BRIEF words of keypoints pts [N, 2] on the blurred
    frame img [H, W]; rows with valid = False are 0."""
    if pts.is_cuda:
        out = _brief_words_cuda(img, pts, valid, pattern)
        extract_brief_words.launches += 1
        return out
    if pts.device.type != "cpu":
        raise ValueError(f"extract_brief_words: unsupported device "
                         f"{pts.device}")
    return extract_brief_words_plain(img, pts, valid, pattern)


extract_brief_words.launches = 0


def reset_launch_counts() -> None:
    extract_brief_words.launches = 0
