"""Build the host libraries of the port's native IO with g++, at first
use and never at import:

  _build/libvinsruntime.so  from native/runtime.cpp (the streaming sensor
                            runtime; the source is shared with the JAX
                            package and only read here), -lpthread;
  _build/libvinsloader.so   from vins_tpu_torch/csrc/host/dataloader.cpp
                            (the port's copy of the prefetching PNG
                            loader, with its in-order deadlock repaired),
                            -lz -lpthread.

native/Makefile's flags. A library is rebuilt when its source is newer;
each build writes a temporary file and renames it, so concurrent
processes never load a half-written library. Nothing is written under
native/.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall"]
LIBRARIES = {
    "vinsruntime": (os.path.join(os.path.dirname(_PKG_DIR), "native",
                                 "runtime.cpp"), ["-lpthread"]),
    "vinsloader": (os.path.join(_PKG_DIR, "csrc", "host", "dataloader.cpp"),
                   ["-lz", "-lpthread"]),
}

_lock = threading.Lock()


class BuildError(RuntimeError):
    """g++ is missing or refused a source (the message holds its report)."""


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build(name: str) -> str:
    """Compile library `name` ("vinsruntime" or "vinsloader") into BUILD_DIR
    if it is missing or older than its source; returns its path."""
    src, libs = LIBRARIES[name]
    out = lib_path(name)
    with _lock:
        if (os.path.exists(out)
                and os.path.getmtime(out) >= os.path.getmtime(src)):
            return out
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise BuildError("g++ not found: the native host libraries "
                             "cannot be built")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        proc = subprocess.run([cxx] + CXXFLAGS + ["-shared", src, "-o", tmp]
                              + libs, capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(f"g++ failed on {src} (exit {proc.returncode}):"
                             f"\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
        return out


def load(name: str) -> ctypes.CDLL:
    """The library `name`, built first if needed."""
    return ctypes.CDLL(build(name))
