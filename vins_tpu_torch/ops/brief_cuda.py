"""Kernel K3 (BRIEF words from subpixel-aligned patches): the CUDA wrappers
and their plain PyTorch versions.

K3 replaces `_patches_kernel` / `extract_patches_pallas`
(vins_tpu/ops/klt_pallas.py:329-365) together with the one-hot difference
matmul and bit packing that follow it in vins_tpu/ops/brief.extract_brief
(brief.py:89-101); the CUDA source is vins_tpu_torch/csrc/brief.cu. It
has two entries on one kernel: `extract_brief_raw`, which the system
calls, takes the raw frame and fuses the Gaussian blur that precedes the
patch kernel (brief.py:87), staging each keypoint's window in shared
memory; `extract_brief_words` takes a frame blurred beforehand, the
direct counterpart of the Pallas kernel; `extract_patches` computes the
Pallas kernel's own output, the [N, win, win] patches at any window from
1 to 128, in a kernel of its own (its library yardstick,
`extract_patches_grid_sample`, one `F.grid_sample` call, serves the tests
and chip_smoke.py only). The port follows the TPU
semantics on every device: each keypoint's 49x49 patch corner is clamped
once, as `_bilinear_patch` clamps it (klt_pallas.py:40-46), so every tap
of a keypoint within 25 px of a border shifts with the patch. (The JAX
package's CPU branch clamps each tap alone instead; the two agree only
inside the border.)

Descriptors are [N, 8] int32 tensors holding the bit patterns of the
JAX package's packed uint32 words.

Dispatch is on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. Nothing falls back.
Each wrapper counts its launches (`extract_brief_raw.launches`,
`extract_brief_words.launches`, `extract_patches.launches`).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import native
from .image import _sep_filter
from .klt_cuda import (_check_level_shape, _check_tensor, _check_win,
                       _patches, _stream_ptr)

PATCH_HALF = 24
PATCH_WIN = 2 * PATCH_HALF + 1     # 49x49 patch
BRIEF_BITS = 256
BRIEF_WORDS = BRIEF_BITS // 32
BLUR_TAPS = 5                      # the raw-frame kernel's blur taps


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


def patch_grid(img: torch.Tensor, pts: torch.Tensor,
               win: int = PATCH_WIN) -> torch.Tensor:
    """[1, N * win, win, 2] grid_sample points of the patches of
    extract_patches_plain: the clamped corner plus the integer offsets,
    normalized as 2x / (W - 1) - 1 (in float64, then float32)."""
    H, W = img.shape
    r = (win - 1) / 2.0
    cx = torch.clamp(torch.nan_to_num(pts[:, 0] - r, nan=0.0), 0.0,
                     W - win - 1.001)
    cy = torch.clamp(torch.nan_to_num(pts[:, 1] - r, nan=0.0), 0.0,
                     H - win - 1.001)
    o = torch.arange(win, dtype=torch.float64, device=pts.device)
    gx = 2 * (cx.double()[:, None] + o) / (W - 1) - 1     # [N, win]
    gy = 2 * (cy.double()[:, None] + o) / (H - 1) - 1
    grid = torch.stack(torch.broadcast_tensors(gx[:, None, :],
                                               gy[:, :, None]), -1)
    return grid.reshape(1, pts.shape[0] * win, win, 2).float()


def extract_patches_grid_sample(img: torch.Tensor, pts: torch.Tensor,
                                win: int = PATCH_WIN,
                                grid=None) -> torch.Tensor:
    """The library yardstick of extract_patches: the same [N, win, win]
    patches from one F.grid_sample call (bilinear, border padding,
    align_corners=True) on `grid` (patch_grid's, built here if None).
    It rounds the sample point otherwise (grid_sample unnormalizes it), so
    it agrees with extract_patches_plain to about 1e-5 on a blurred frame,
    not bit for bit. Used by the tests and chip_smoke.py only."""
    if grid is None:
        grid = patch_grid(img, pts, win)
    return F.grid_sample(img[None, None], grid, mode="bilinear",
                         padding_mode="border", align_corners=True
                         ).reshape(pts.shape[0], win, win)


def _patches_cuda(img, pts, win):
    dev = pts.device
    N = pts.shape[0]
    H, W = img.shape
    _check_win(win)
    _check_level_shape(0, H, W, win)
    _check_tensor("img", img, (H, W), torch.float32, dev)
    _check_tensor("pts", pts, (N, 2), torch.float32, dev)
    out = torch.empty((N, win, win), dtype=torch.float32, device=dev)
    status = native.library().vins_extract_patches(
        img.data_ptr(), H, W, pts.data_ptr(), N, win, out.data_ptr(),
        _stream_ptr(dev))
    native.check(status, "vins_extract_patches")
    return out


def extract_patches(img: torch.Tensor, pts: torch.Tensor,
                    win: int = PATCH_WIN) -> torch.Tensor:
    """K3's own output (extract_patches_pallas): [N, win, win] bilinear
    patches of img [H, W] centred at pts [N, 2], in one launch on the card
    (none at N = 0); equal to extract_patches_plain bit for bit."""
    if pts.is_cuda:
        out = _patches_cuda(img, pts, win)
        if pts.shape[0]:
            extract_patches.launches += 1
        return out
    if pts.device.type != "cpu":
        raise ValueError(f"extract_patches: unsupported device {pts.device}")
    return extract_patches_plain(img, pts, win)


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


def extract_brief_raw_plain(raw: torch.Tensor, pts: torch.Tensor,
                            valid: torch.Tensor, pattern: torch.Tensor,
                            taps) -> torch.Tensor:
    """Plain version of the raw-frame entry: the separable reflect-101
    blur of raw [H, W] with the 5 taps (image.gaussian_taps), then
    extract_brief_words_plain."""
    return extract_brief_words_plain(_sep_filter(raw, tuple(taps)), pts,
                                     valid, pattern)


def _brief_cuda(img, pts, valid, pattern, taps=None):
    """Check the inputs and launch csrc/brief.cu: the raw-frame entry,
    which blurs img with `taps`, or, with taps None, the blurred-input
    entry."""
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
    lib = native.library()
    head = (img.data_ptr(), H, W, pts.data_ptr(), valid.data_ptr(),
            pattern.data_ptr())
    tail = (N, words.data_ptr(), _stream_ptr(dev))
    if taps is None:
        name = "vins_brief_words"
        status = lib.vins_brief_words(*head, *tail)
    else:
        if len(taps) != BLUR_TAPS:
            raise ValueError(f"the kernel blurs with {BLUR_TAPS} taps, not "
                             f"{len(taps)}")
        name = "vins_brief_raw_words"
        k = (ctypes.c_float * BLUR_TAPS)(*taps)
        status = lib.vins_brief_raw_words(*head, ctypes.addressof(k), *tail)
    native.check(status, name)
    return words


def extract_brief_raw(raw: torch.Tensor, pts: torch.Tensor,
                      valid: torch.Tensor, pattern: torch.Tensor,
                      taps) -> torch.Tensor:
    """K3 from the raw frame: [N, 8] int32 BRIEF words of keypoints pts
    [N, 2] on raw [H, W] blurred with the 5 float32 taps `taps`, in one
    launch; rows with valid = False are 0."""
    if pts.is_cuda:
        out = _brief_cuda(raw, pts, valid, pattern, taps)
        extract_brief_raw.launches += 1
        return out
    if pts.device.type != "cpu":
        raise ValueError(f"extract_brief_raw: unsupported device "
                         f"{pts.device}")
    return extract_brief_raw_plain(raw, pts, valid, pattern, taps)


def extract_brief_words(img: torch.Tensor, pts: torch.Tensor,
                        valid: torch.Tensor,
                        pattern: torch.Tensor) -> torch.Tensor:
    """K3: [N, 8] int32 BRIEF words of keypoints pts [N, 2] on the blurred
    frame img [H, W]; rows with valid = False are 0."""
    if pts.is_cuda:
        out = _brief_cuda(img, pts, valid, pattern)
        extract_brief_words.launches += 1
        return out
    if pts.device.type != "cpu":
        raise ValueError(f"extract_brief_words: unsupported device "
                         f"{pts.device}")
    return extract_brief_words_plain(img, pts, valid, pattern)


extract_brief_raw.launches = 0
extract_brief_words.launches = 0
extract_patches.launches = 0


def reset_launch_counts() -> None:
    extract_brief_raw.launches = 0
    extract_brief_words.launches = 0
    extract_patches.launches = 0
