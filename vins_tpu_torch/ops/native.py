"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The library is compiled with nvcc for sm_90a into
vins_tpu_torch/_build/libvins_kernels.so at first CUDA use — never at
import — from the sources in this checkout only, and rebuilt whenever a
source is newer than the library. Every source compiles in its own nvcc
process, all started together, and one link step joins the objects. It
has a plain C interface and is bound with ctypes (the same pattern as
native/Makefile with vins_tpu/io/native_loader.py), so the build needs
nvcc alone: no ninja, no PyTorch headers.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libvins_kernels.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_VP = ctypes.c_void_p
_ARGTYPES = {
    # pts, init_flow, valid, planes, Hs, Ws, L, M, win, iters, eps2,
    # pts_out, ok_out, err_out, stream
    "vins_klt_pyramid": [_VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_float, _VP, _VP, _VP, _VP],
    # img_a, img_b, H, W, pts_a, pts_b, M, win, out, stream
    "vins_patch_ncc": [_VP, _VP, ctypes.c_int, ctypes.c_int, _VP, _VP,
                       ctypes.c_int, ctypes.c_int, _VP, _VP],
    # prev, gx, gy, next, H, W, pts, guess, valid, M, win, iters, eps2,
    # flow_out, ok_out, err_out, stream
    "vins_klt_level": [_VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int, _VP,
                       _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, _VP, _VP, _VP, _VP],
    # pts, valid, planes, Hs, Ws, L, M, win, iters, eps2, fb_thresh,
    # ncc_min, fwd_pts, status, err, ncc, stream
    "vins_klt_fb_ncc": [_VP, _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_float,
                        ctypes.c_float, ctypes.c_float, _VP, _VP, _VP, _VP,
                        _VP],
    # (no arguments): the runtime-window kernels' shared-memory opt-in
    "vins_klt_init": [],
    # win, L, ring_out (int*), bytes_out (long long*)
    "vins_klt_plan": [ctypes.c_int, ctypes.c_int, _VP, _VP],
    # img, H, W, pts, N, win, out, stream
    "vins_extract_patches": [_VP, ctypes.c_int, ctypes.c_int, _VP,
                             ctypes.c_int, ctypes.c_int, _VP, _VP],
    # img, H, W, pts, valid, pattern, N, words, stream
    "vins_brief_words": [_VP, ctypes.c_int, ctypes.c_int, _VP, _VP, _VP,
                         ctypes.c_int, _VP, _VP],
    # raw, H, W, pts, valid, pattern, taps (host float[5]), N, words, stream
    "vins_brief_raw_words": [_VP, ctypes.c_int, ctypes.c_int, _VP, _VP, _VP,
                             _VP, ctypes.c_int, _VP, _VP],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in _sources())


def _run_all(cmds) -> list:
    """Run the commands in parallel; raise with the compiler's report on
    the first failure. Returns each command's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError("nvcc failed (exit %d):\n%s\n%s" % (
                p.returncode, " ".join(c), err[-8000:]))
    return [err for _, err in outs]


def build() -> dict:
    """Compile csrc/*.cu into LIB_PATH if it is missing or stale: one nvcc
    per source, in parallel, then one link. Returns {"seconds": ...,
    "rebuilt": bool, "ptxas": compiler report}."""
    if not _stale():
        return {"seconds": 0.0, "rebuilt": False, "ptxas": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    cu = [s for s in _sources() if s.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, os.path.basename(s)[:-3] + f".{tag}.o")
            for s in cu]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    reports = _run_all([[nvcc] + NVCC_FLAGS + ["-c", "-o", o, s]
                        for s, o in zip(cu, objs)])
    tmp = f"{LIB_PATH}.{tag}"
    _run_all([[nvcc] + ARCH_FLAGS + ["-shared", "-o", tmp] + objs])
    os.replace(tmp, LIB_PATH)
    for o in objs:
        os.remove(o)
    return {"seconds": time.perf_counter() - t0, "rebuilt": True,
            "ptxas": "\n".join(reports)}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build_info.update(build())
            lib = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            # Let the runtime-window kernels use the card's opt-in shared
            # memory (cudaFuncSetAttribute) before any launch is captured.
            check(lib.vins_klt_init(), "vins_klt_init")
            _lib = lib
        return _lib


def check(status: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error (launch refused, bad
    argument); a fault during the run surfaces at the next synchronize."""
    if status != 0:
        import torch
        msg = torch.cuda.get_device_name() if torch.cuda.is_available() \
            else "no device"
        raise RuntimeError(f"{name}: CUDA error {status} on {msg}")
