"""Tracing and profiling: scoped stage timers, the torch profiler, and
operation and byte counts for speed-of-light checks (port of
vins_tpu/utils/profiling.py).

Replaces the reference's TS/TE tick-count macro pair
(VINS_ios/global_param.hpp:85-92) with:

  * `StageTimers.stage(name)` — a context manager that accumulates wall
    time per stage, synchronizing the device of the staged result so that
    the number means what it says; `timers` is the module-level registry;
  * `trace(dir)` — torch.profiler around a region, exported as a Chrome
    trace (dir/trace.json);
  * `cost_analysis(fn, *args)` — `flops` from
    torch.utils.flop_counter.FlopCounterMode and `bytes accessed`, the
    input and output bytes of every aten op the call runs;
  * `speed_of_light(fn, *args)` — the larger of the two roofline times at
    the H100's peaks.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode


def _synchronize(result: Any) -> None:
    """Wait for the CUDA devices that hold a tensor of `result`."""
    devs = {x.device for x in tree_flatten(result)[0]
            if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for d in devs:
        torch.cuda.synchronize(d)


class StageTimers:
    """Accumulating per-stage wall timers (the TS/TE equivalent)."""

    def __init__(self, sync: bool = True):
        self.total_s: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.last_s: Dict[str, float] = {}
        self.sync = sync

    @contextlib.contextmanager
    def stage(self, name: str, result: Any = None):
        """Time the block; with sync, wait for the device of the staged
        result (`result`, or what the block puts in the yielded dict's
        "result") before the clock stops."""
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            out = box.get("result", result)
            if self.sync and out is not None:
                _synchronize(out)
            dt = time.perf_counter() - t0
            self.total_s[name] += dt
            self.count[name] += 1
            self.last_s[name] = dt

    def mean_ms(self, name: str) -> float:
        c = self.count.get(name, 0)
        return 1e3 * self.total_s[name] / c if c else 0.0

    def report(self) -> str:
        rows = [f"{'stage':24s} {'calls':>6s} {'mean ms':>9s} {'last ms':>9s}"]
        for name in sorted(self.total_s, key=lambda n: -self.total_s[n]):
            rows.append(
                f"{name:24s} {self.count[name]:6d} "
                f"{self.mean_ms(name):9.3f} "
                f"{1e3 * self.last_s.get(name, 0.0):9.3f}")
        return "\n".join(rows)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {n: {"calls": self.count[n], "mean_ms": self.mean_ms(n),
                    "total_s": self.total_s[n]} for n in self.total_s}


# Module-level default registry (the reference's macros are global too).
timers = StageTimers()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (the CPU, and CUDA when a card is
    present), written to log_dir/trace.json as a Chrome trace. Yields the
    profiler (key_averages() for tables)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _ByteCounter(TorchDispatchMode):
    """Adds up the bytes of every tensor each aten op reads and writes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        leaves = tree_flatten((args, kwargs, out))[0]
        self.bytes += sum(x.numel() * x.element_size() for x in leaves
                          if isinstance(x, torch.Tensor))
        return out


def cost_analysis(fn: Callable, *args) -> Dict[str, float]:
    """Run fn(*args) once and count its work: `flops` (FlopCounterMode:
    matmuls, convolutions and attention, 2 per multiply-add) and
    `bytes accessed` (every aten op's inputs and outputs, each counted
    once per op: an upper bound on the bytes that the fused work would
    move)."""
    counter = _ByteCounter()
    flops = FlopCounterMode(display=False)
    with flops, counter:
        fn(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(counter.bytes)}


def speed_of_light(fn: Callable, *args, peak_tflops: float = 67.0,
                   peak_hbm_gbs: float = 3350.0,
                   measured_s: Optional[float] = None) -> Dict[str, float]:
    """Roofline bound of fn(*args) from cost_analysis. The defaults are
    the NVIDIA H100 SXM's: 67 TFLOP/s fp32 without tensor cores and
    3.35 TB/s of HBM3, the peaks of the kernel table's bounds. Returns
    the compute- and memory-bound lower bounds on the time and, with
    `measured_s`, the share of speed of light achieved."""
    costs = cost_analysis(fn, *args)
    flops, nbytes = costs["flops"], costs["bytes accessed"]
    t_compute = flops / (peak_tflops * 1e12)
    t_memory = nbytes / (peak_hbm_gbs * 1e9)
    bound = max(t_compute, t_memory)
    out = {"flops": flops, "bytes": nbytes, "t_compute_s": t_compute,
           "t_memory_s": t_memory, "t_bound_s": bound}
    if measured_s is not None and bound > 0:
        out["sol_fraction"] = bound / measured_s
    return out
