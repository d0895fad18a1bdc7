"""Kernels K1 (pyramidal LK), K4 (one LK level), K2 (patch NCC) and the
fused forward–backward–NCC tracking kernel: CUDA wrappers and their plain
PyTorch versions.

K1 replaces `_klt_pyramid_kernel` / `track_pyramid_pallas`
(vins_tpu/ops/klt_pallas.py:191-326), K4 replaces `_klt_kernel` /
`track_level_pallas` (klt_pallas.py:67-188) as K1's code at L = 1, and
K2 replaces `_ncc_kernel` / `patch_ncc_pallas` (klt_pallas.py:368-411).
`track_fb` runs in one launch what vins_tpu/ops/klt.track_pyramid_fb
(klt.py:157-204) does on the TPU with three: K1 forward, K1 backward and
K2, with the post-filters and the gate. The CUDA sources are in
vins_tpu_torch/csrc/klt.cu. Like the Pallas kernels, every entry takes any
window from 1x1 to MAX_WIN x MAX_WIN and up to MAX_LEVELS levels, each
level holding the window plus its 1 px bilinear border; the CUDA wrappers
raise outside that domain. Dispatch is on the tensor's device: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises. Nothing falls back.

The plain versions implement the KERNEL's semantics, not those of the
JAX package's XLA path (vins_tpu/ops/klt._track_level, which always runs
`iters` updates): a per-slot early exit once |Δ|² ≤ eps², dead input
slots skipping every level's loop, and the min-eigenvalue gate applied to
`ok` while gated slots still iterate. They are written as a masked,
batched loop over `iters` in which a slot freezes once it stops.

Each CUDA wrapper counts its launches in a plain integer attribute
(`track_pyramid.launches`, `track_level.launches`, `patch_ncc.launches`,
`track_fb.launches`), incremented only where the kernel is launched.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import native


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _patches(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
             win: int) -> torch.Tensor:
    """[M, win*win] bilinear patches with top-left corners (cx, cy), the
    corner clamped to [0, W-win-1.001] (klt_pallas._bilinear_patch). A NaN
    corner reads at 0, as the CUDA kernel does."""
    H, W = img.shape
    cx = torch.clamp(torch.nan_to_num(cx, nan=0.0), 0.0, W - win - 1.001)
    cy = torch.clamp(torch.nan_to_num(cy, nan=0.0), 0.0, H - win - 1.001)
    fxf, fyf = torch.floor(cx), torch.floor(cy)
    ix, iy = fxf.long(), fyf.long()
    fx = (cx - fxf)[:, None, None]
    fy = (cy - fyf)[:, None, None]
    o = torch.arange(win + 1, device=img.device)
    raw = img[(iy[:, None] + o)[:, :, None], (ix[:, None] + o)[:, None, :]]
    top = (1 - fy) * ((1 - fx) * raw[:, :-1, :-1] + fx * raw[:, :-1, 1:])
    bot = fy * ((1 - fx) * raw[:, 1:, :-1] + fx * raw[:, 1:, 1:])
    return (top + bot).reshape(cx.shape[0], win * win)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _pyramid_flow_plain(pyr_prev: Sequence[torch.Tensor],
                        grads: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                        pyr_next: Sequence[torch.Tensor],
                        pts_prev: torch.Tensor, valid: torch.Tensor,
                        win: int, iters: int, eps: float,
                        guess: torch.Tensor, iters_run: Optional[list] = None):
    """(flow [M,2], ok [M], err [M]) of _klt_pyramid_kernel, starting at
    the coarsest level with `guess` (that level's pixels). iters_run: if a
    list, the [M] count of updates each slot ran is appended per level."""
    L = len(pyr_prev)
    r = (win - 1) / 2.0
    area = float(win * win)
    eps2 = _f32(eps * eps, pts_prev)
    px, py = pts_prev[:, 0], pts_prev[:, 1]
    flx, fly = guess[:, 0].clone(), guess[:, 1].clone()
    alive = valid.clone()
    ok = alive.clone()
    err = torch.zeros_like(px)
    inf = torch.full_like(px, float("inf"))
    for lvl in range(L - 1, -1, -1):
        scale = float(2 ** lvl)
        plx, ply = px / scale, py / scale
        t = _patches(pyr_prev[lvl], plx - r, ply - r, win)
        tx = _patches(grads[lvl][0], plx - r, ply - r, win)
        ty = _patches(grads[lvl][1], plx - r, ply - r, win)
        a = torch.sum(tx * tx, -1)
        b = torch.sum(tx * ty, -1)
        c = torch.sum(ty * ty, -1)
        det = a * c - b * b
        tr = a + c
        min_eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det,
                                                     min=0.0)))
        ok = ok & (min_eig / area > 1e-4)
        inv_det = 1.0 / torch.where(det > 1e-12, det, torch.ones_like(det))
        i00, i01, i11 = c * inv_det, -b * inv_det, a * inv_det

        d2 = torch.where(alive, inf, torch.zeros_like(px))
        err_l = torch.zeros_like(px)
        n_run = torch.zeros_like(px, dtype=torch.int32)
        for _ in range(iters):
            run = d2 > eps2
            n_run += run
            cur = _patches(pyr_next[lvl], plx + flx - r, ply + fly - r, win)
            diff = cur - t
            rx = torch.sum(diff * tx, -1)
            ry = torch.sum(diff * ty, -1)
            dx = -(i00 * rx + i01 * ry)
            dy = -(i01 * rx + i11 * ry)
            flx = torch.where(run, flx + dx, flx)
            fly = torch.where(run, fly + dy, fly)
            err_l = torch.where(run, torch.sum(torch.abs(diff), -1) / area,
                                err_l)
            d2 = torch.where(run, dx * dx + dy * dy, d2)
        if iters_run is not None:
            iters_run.append(n_run)
        err = err_l
        if lvl > 0:
            flx, fly = flx * 2.0, fly * 2.0
    return torch.stack([flx, fly], -1), ok, err


def _coarse_guess(pts_prev, init_flow, L):
    if init_flow is None:
        return torch.zeros_like(pts_prev)
    return init_flow / (2.0 ** (L - 1))


def track_pyramid_plain(pyr_prev, grads, pyr_next, pts_prev, valid,
                        win: int, iters: int, eps: float = 0.0,
                        init_flow: Optional[torch.Tensor] = None,
                        iters_run: Optional[list] = None):
    """Plain version of K1: (pts_prev + flow, ok & valid, err). iters_run:
    if a list, receives each level's [M] count of LK updates run."""
    flow, ok, err = _pyramid_flow_plain(
        pyr_prev, grads, pyr_next, pts_prev, valid, win, iters, eps,
        _coarse_guess(pts_prev, init_flow, len(pyr_prev)), iters_run)
    return pts_prev + flow, ok & valid, err


def track_level_plain(img_prev, gx, gy, img_next, pts_prev, guess, valid,
                      win: int, iters: int, eps: float = 0.0,
                      iters_run: Optional[list] = None):
    """Plain version of K4: one level with an arbitrary per-slot guess
    (`track_level_pallas`, klt_pallas.py:67-188), which is K1 at L = 1.
    Returns (flow, ok, err)."""
    return _pyramid_flow_plain([img_prev], [(gx, gy)], [img_next],
                               pts_prev, valid, win, iters, eps, guess,
                               iters_run)


def post_filter(pts_next: torch.Tensor, ok: torch.Tensor,
                err: torch.Tensor, valid: torch.Tensor,
                shape) -> torch.Tensor:
    """The status of a tracking pass (vins_tpu/ops/klt.py:147-154): the
    kernel's ok, in bounds with a 1 px border of an image of `shape`
    [H, W], err < 0.35, finite, and valid."""
    H, W = shape
    border = 1.0
    inb = ((pts_next[:, 0] >= border) & (pts_next[:, 0] < W - border)
           & (pts_next[:, 1] >= border) & (pts_next[:, 1] < H - border))
    ok = ok & inb & (err < 0.35) & torch.all(torch.isfinite(pts_next), -1)
    return ok & valid


def patch_ncc_plain(img_a: torch.Tensor, img_b: torch.Tensor,
                    pts_a: torch.Tensor, pts_b: torch.Tensor,
                    win: int) -> torch.Tensor:
    """Plain version of K2: zero-mean NCC of [win, win] patches centered
    at pts_a in img_a and pts_b in img_b."""
    r = (win - 1) / 2.0
    ta = _patches(img_a, pts_a[:, 0] - r, pts_a[:, 1] - r, win)
    tb = _patches(img_b, pts_b[:, 0] - r, pts_b[:, 1] - r, win)
    area = float(win * win)
    ta = ta - torch.sum(ta, -1, keepdim=True) / area
    tb = tb - torch.sum(tb, -1, keepdim=True) / area
    return torch.sum(ta * tb, -1) * torch.rsqrt(
        torch.sum(ta * ta, -1) * torch.sum(tb * tb, -1) + 1e-12)


def track_fb_plain(pyr_prev, grads_prev, pyr_next, grads_next,
                   pts_prev: torch.Tensor, valid: torch.Tensor, win: int,
                   iters: int, eps: float, fb_thresh: float,
                   ncc_min: float):
    """Plain version of the fused tracking kernel: K1 forward, its
    post-filter, K1 backward from the forward result seeded with the
    negated forward flow, its post-filter, K2 on the forward result and
    the gate (vins_tpu/ops/klt.py:171-203). Returns (fwd_pts [M, 2],
    status [M], err [M] = the round-trip distance, ncc [M])."""
    p_f, ok_f, e_f = track_pyramid_plain(pyr_prev, grads_prev, pyr_next,
                                         pts_prev, valid, win, iters, eps)
    ok_f = post_filter(p_f, ok_f, e_f, valid, pyr_next[0].shape)
    p_b, ok_b, e_b = track_pyramid_plain(pyr_next, grads_next, pyr_prev,
                                         p_f, ok_f, win, iters, eps,
                                         init_flow=pts_prev - p_f)
    ok_b = post_filter(p_b, ok_b, e_b, ok_f, pyr_prev[0].shape)
    d = p_b - pts_prev
    rt = torch.sqrt(torch.sum(d * d, -1))
    ncc = patch_ncc_plain(pyr_prev[0], pyr_next[0], pts_prev, p_f, win)
    status = ok_f & ok_b & (rt < fb_thresh) & (ncc > ncc_min)
    return p_f, status, rt, ncc


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _check_tensor(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# The domain of the CUDA kernels. A window needs win + 1 <= 129 columns,
# the bound of the Pallas read (klt_pallas.py:52-55); a launch takes up to
# 32 levels, more than any halving pyramid of int-sized images whose
# coarsest level holds a window (3 * 2^31 rows at level 0).
MAX_WIN = 128
MAX_LEVELS = 32


def _check_win(win: int) -> None:
    if not 1 <= win <= MAX_WIN:
        raise ValueError(f"the CUDA kernels take windows of 1x1 to "
                         f"{MAX_WIN}x{MAX_WIN} pixels, not {win}x{win}")


def _check_levels(L: int) -> None:
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"the CUDA kernels take 1 to {MAX_LEVELS} pyramid "
                         f"levels, not {L}")


def _check_level_shape(lvl: int, H: int, W: int, win: int) -> None:
    if H < win + 2 or W < win + 2:
        raise ValueError(f"level {lvl} ({H}x{W}) is smaller than the "
                         f"{win}x{win} window plus its bilinear border: "
                         f"the kernels take levels of at least "
                         f"{win + 2}x{win + 2} pixels")


class GenericPlan(NamedTuple):
    """How a runtime-window launch runs (klt.cu's plan_r). Up to window 64
    each of its 256 threads holds taps_per_thread template taps in
    registers (1, 2, 4, 8 or 16: the least that covers win^2) and
    ring_levels of the L levels are staged in shared memory at a time;
    past 64 the blended templates of shared_taps of the win^2 taps lie in
    shared memory: all of them (taps_per_thread 0; up to window 113 on an
    H100) or as many as fit beside the next-frame tile (-1), the rest
    blended from L2 at each use. smem_bytes: the launch's dynamic shared
    memory."""
    taps_per_thread: int
    ring_levels: int
    shared_taps: int
    smem_bytes: int


def generic_plan(win: int, L: int) -> GenericPlan:
    """On the card: the plan of the runtime-window kernels at window win
    and L levels. The 21x21 window at up to 4 levels takes the
    specialization instead."""
    _check_win(win)
    _check_levels(L)
    kt, r, nbytes = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    native.check(native.library().vins_klt_plan(
        win, L, ctypes.addressof(kt), ctypes.addressof(r),
        ctypes.addressof(nbytes)), "vins_klt_plan")
    regs = kt.value > 0
    return GenericPlan(kt.value, r.value if regs else 0,
                       0 if regs else r.value, nbytes.value)


def _track_pyramid_cuda(pyr_prev, grads, pyr_next, pts_prev, valid,
                        win, iters, eps, init_flow):
    dev = pts_prev.device
    M = pts_prev.shape[0]
    L = len(pyr_prev)
    f32 = torch.float32
    _check_win(win)
    _check_levels(L)
    _check_tensor("pts_prev", pts_prev, (M, 2), f32, dev)
    _check_tensor("valid", valid, (M,), torch.bool, dev)
    if init_flow is not None:
        _check_tensor("init_flow", init_flow, (M, 2), f32, dev)
    planes, Hs, Ws = [], [], []
    for lvl in range(L):
        H, W = pyr_prev[lvl].shape
        _check_level_shape(lvl, H, W, win)
        for name, x in (("prev", pyr_prev[lvl]), ("gx", grads[lvl][0]),
                        ("gy", grads[lvl][1]), ("next", pyr_next[lvl])):
            _check_tensor(f"{name}[{lvl}]", x, (H, W), f32, dev)
            planes.append(x.data_ptr())
        Hs.append(H)
        Ws.append(W)
    pts_out = torch.empty((M, 2), dtype=f32, device=dev)
    ok_out = torch.empty((M,), dtype=torch.bool, device=dev)
    err_out = torch.empty((M,), dtype=f32, device=dev)
    c_planes = (ctypes.c_void_p * len(planes))(*planes)
    c_H = (ctypes.c_int * L)(*Hs)
    c_W = (ctypes.c_int * L)(*Ws)
    lib = native.library()
    status = lib.vins_klt_pyramid(
        pts_prev.data_ptr(),
        init_flow.data_ptr() if init_flow is not None else None,
        valid.data_ptr(), ctypes.addressof(c_planes),
        ctypes.addressof(c_H), ctypes.addressof(c_W), L, M, win, iters,
        eps * eps, pts_out.data_ptr(), ok_out.data_ptr(),
        err_out.data_ptr(), _stream_ptr(dev))
    native.check(status, "vins_klt_pyramid")
    return pts_out, ok_out, err_out


def _track_level_cuda(img_prev, gx, gy, img_next, pts_prev, guess, valid,
                      win, iters, eps):
    dev = pts_prev.device
    M = pts_prev.shape[0]
    H, W = img_prev.shape
    f32 = torch.float32
    _check_win(win)
    _check_level_shape(0, H, W, win)
    for name, x in (("img_prev", img_prev), ("gx", gx), ("gy", gy),
                    ("img_next", img_next)):
        _check_tensor(name, x, (H, W), f32, dev)
    _check_tensor("pts_prev", pts_prev, (M, 2), f32, dev)
    _check_tensor("guess", guess, (M, 2), f32, dev)
    _check_tensor("valid", valid, (M,), torch.bool, dev)
    flow = torch.empty((M, 2), dtype=f32, device=dev)
    ok = torch.empty((M,), dtype=torch.bool, device=dev)
    err = torch.empty((M,), dtype=f32, device=dev)
    status = native.library().vins_klt_level(
        img_prev.data_ptr(), gx.data_ptr(), gy.data_ptr(),
        img_next.data_ptr(), H, W, pts_prev.data_ptr(), guess.data_ptr(),
        valid.data_ptr(), M, win, iters, eps * eps, flow.data_ptr(),
        ok.data_ptr(), err.data_ptr(), _stream_ptr(dev))
    native.check(status, "vins_klt_level")
    return flow, ok, err


def _patch_ncc_cuda(img_a, img_b, pts_a, pts_b, win):
    dev = pts_a.device
    M = pts_a.shape[0]
    H, W = img_a.shape
    f32 = torch.float32
    _check_win(win)
    _check_level_shape(0, H, W, win)
    _check_tensor("img_a", img_a, (H, W), f32, dev)
    _check_tensor("img_b", img_b, (H, W), f32, dev)
    _check_tensor("pts_a", pts_a, (M, 2), f32, dev)
    _check_tensor("pts_b", pts_b, (M, 2), f32, dev)
    out = torch.empty((M,), dtype=f32, device=dev)
    status = native.library().vins_patch_ncc(
        img_a.data_ptr(), img_b.data_ptr(), H, W, pts_a.data_ptr(),
        pts_b.data_ptr(), M, win, out.data_ptr(), _stream_ptr(dev))
    native.check(status, "vins_patch_ncc")
    return out


def _track_fb_cuda(pyr_prev, grads_prev, pyr_next, grads_next, pts_prev,
                   valid, win, iters, eps, fb_thresh, ncc_min):
    dev = pts_prev.device
    M = pts_prev.shape[0]
    L = len(pyr_prev)
    f32 = torch.float32
    _check_win(win)
    _check_levels(L)
    for name, seq in (("grads_prev", grads_prev), ("pyr_next", pyr_next),
                      ("grads_next", grads_next)):
        if len(seq) != L:
            raise ValueError(f"{name} has {len(seq)} levels, expected {L}")
    _check_tensor("pts_prev", pts_prev, (M, 2), f32, dev)
    _check_tensor("valid", valid, (M,), torch.bool, dev)
    planes, Hs, Ws = [], [], []
    for lvl in range(L):
        H, W = pyr_prev[lvl].shape
        _check_level_shape(lvl, H, W, win)
        for name, x in (("prev", pyr_prev[lvl]),
                        ("gx_prev", grads_prev[lvl][0]),
                        ("gy_prev", grads_prev[lvl][1]),
                        ("next", pyr_next[lvl]),
                        ("gx_next", grads_next[lvl][0]),
                        ("gy_next", grads_next[lvl][1])):
            _check_tensor(f"{name}[{lvl}]", x, (H, W), f32, dev)
            planes.append(x.data_ptr())
        Hs.append(H)
        Ws.append(W)
    fwd_pts = torch.empty((M, 2), dtype=f32, device=dev)
    status = torch.empty((M,), dtype=torch.bool, device=dev)
    err = torch.empty((M,), dtype=f32, device=dev)
    ncc = torch.empty((M,), dtype=f32, device=dev)
    c_planes = (ctypes.c_void_p * len(planes))(*planes)
    c_H = (ctypes.c_int * L)(*Hs)
    c_W = (ctypes.c_int * L)(*Ws)
    rc = native.library().vins_klt_fb_ncc(
        pts_prev.data_ptr(), valid.data_ptr(), ctypes.addressof(c_planes),
        ctypes.addressof(c_H), ctypes.addressof(c_W), L, M, win, iters,
        eps * eps, fb_thresh, ncc_min, fwd_pts.data_ptr(),
        status.data_ptr(), err.data_ptr(), ncc.data_ptr(), _stream_ptr(dev))
    native.check(rc, "vins_klt_fb_ncc")
    return fwd_pts, status, err, ncc


def track_pyramid(pyr_prev: List[torch.Tensor], grads, pyr_next,
                  pts_prev: torch.Tensor, valid: torch.Tensor, win: int,
                  iters: int, eps: float = 0.0,
                  init_flow: Optional[torch.Tensor] = None):
    """K1: whole-pyramid LK for [M, 2] level-0 points in one launch.

    pyr_prev/pyr_next: per-level [H, W] images (finest first); grads:
    per-level (gx, gy) of pyr_prev; valid: [M] bool; init_flow: optional
    [M, 2] level-0 flow prior. Returns (pts_prev + flow, ok & valid, err)
    as track_pyramid_pallas followed by ops/klt.py:132."""
    if pts_prev.is_cuda:
        out = _track_pyramid_cuda(pyr_prev, grads, pyr_next, pts_prev,
                                  valid, win, iters, eps, init_flow)
        track_pyramid.launches += 1
        return out
    if pts_prev.device.type != "cpu":
        raise ValueError(f"track_pyramid: unsupported device "
                         f"{pts_prev.device}")
    return track_pyramid_plain(pyr_prev, grads, pyr_next, pts_prev, valid,
                               win, iters, eps, init_flow)


def track_level(img_prev: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                img_next: torch.Tensor, pts_prev: torch.Tensor,
                guess: torch.Tensor, valid: torch.Tensor, win: int,
                iters: int, eps: float = 0.0):
    """K4: one LK level for [M, 2] points with a per-slot guess (both in
    this level's pixels). Returns (flow, ok & valid, err) as
    track_level_pallas."""
    if pts_prev.is_cuda:
        out = _track_level_cuda(img_prev, gx, gy, img_next, pts_prev, guess,
                                valid, win, iters, eps)
        track_level.launches += 1
        return out
    if pts_prev.device.type != "cpu":
        raise ValueError(f"track_level: unsupported device "
                         f"{pts_prev.device}")
    return track_level_plain(img_prev, gx, gy, img_next, pts_prev, guess,
                             valid, win, iters, eps)


def patch_ncc(img_a: torch.Tensor, img_b: torch.Tensor,
              pts_a: torch.Tensor, pts_b: torch.Tensor,
              win: int) -> torch.Tensor:
    """K2: zero-mean NCC of [win, win] patches, one value per slot."""
    if pts_a.is_cuda:
        out = _patch_ncc_cuda(img_a, img_b, pts_a, pts_b, win)
        patch_ncc.launches += 1
        return out
    if pts_a.device.type != "cpu":
        raise ValueError(f"patch_ncc: unsupported device {pts_a.device}")
    return patch_ncc_plain(img_a, img_b, pts_a, pts_b, win)


def track_fb(pyr_prev: List[torch.Tensor], grads_prev, pyr_next,
             grads_next, pts_prev: torch.Tensor, valid: torch.Tensor,
             win: int, iters: int, eps: float, fb_thresh: float,
             ncc_min: float):
    """Forward–backward tracking with the NCC gate in one launch.

    pyr_prev/pyr_next: per-level [H, W] images (finest first); grads_prev/
    grads_next: their per-level (gx, gy); pts_prev: [M, 2] level-0 points;
    valid: [M] bool. Returns (fwd_pts [M, 2], status [M], err [M] = the
    round-trip distance, ncc [M]) as track_fb_plain."""
    if pts_prev.is_cuda:
        out = _track_fb_cuda(pyr_prev, grads_prev, pyr_next, grads_next,
                             pts_prev, valid, win, iters, eps, fb_thresh,
                             ncc_min)
        track_fb.launches += 1
        return out
    if pts_prev.device.type != "cpu":
        raise ValueError(f"track_fb: unsupported device {pts_prev.device}")
    return track_fb_plain(pyr_prev, grads_prev, pyr_next, grads_next,
                          pts_prev, valid, win, iters, eps, fb_thresh,
                          ncc_min)


track_pyramid.launches = 0
track_level.launches = 0
patch_ncc.launches = 0
track_fb.launches = 0


def reset_launch_counts() -> None:
    track_pyramid.launches = 0
    track_level.launches = 0
    patch_ncc.launches = 0
    track_fb.launches = 0
