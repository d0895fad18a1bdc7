"""vins_tpu_torch.utils.profiling against vins_tpu.utils.profiling on the
CPU (the port's counterpart of tests/test_viz_aux.py:126-148): stage
timers, operation and byte counts, the roofline bound, the trace."""
import json

import jax.numpy as jnp
import pytest
import torch

from vins_tpu.utils import profiling as j_prof
from vins_tpu_torch.utils import profiling as t_prof

torch.set_num_threads(1)


def test_stage_timers_accumulate():
    t = t_prof.StageTimers(sync=False)
    with t.stage("solve"):
        pass
    with t.stage("solve"):
        pass
    assert t.count["solve"] == 2
    assert "solve" in t.report()
    d = t.as_dict()
    assert d["solve"]["calls"] == 2
    assert d["solve"]["mean_ms"] == pytest.approx(t.mean_ms("solve"))


def test_module_timers_is_a_shared_registry():
    """profiling.timers is the module's default StageTimers, as
    vins_tpu.utils.profiling.timers is the JAX package's: one registry
    that every importer shares, syncing by default."""
    from vins_tpu_torch.utils.profiling import timers
    assert isinstance(j_prof.timers, j_prof.StageTimers)
    assert isinstance(t_prof.timers, t_prof.StageTimers)
    assert timers is t_prof.timers and timers.sync == j_prof.timers.sync
    n = timers.count["module_timers_probe"]
    with timers.stage("module_timers_probe"):
        pass
    assert t_prof.timers.count["module_timers_probe"] == n + 1


def test_stage_timers_take_the_staged_result():
    """The staged result may be given up front or put in the yielded dict
    (a tree of tensors); the stage still counts on a CPU result."""
    t = t_prof.StageTimers()
    x = torch.ones(8, 8)
    with t.stage("mm", result=(x, None)):
        y = x @ x
    with t.stage("mm") as box:
        box["result"] = {"y": y @ y}
    assert t.count["mm"] == 2 and t.last_s["mm"] >= 0.0
    assert t.mean_ms("absent") == 0.0


def test_cost_analysis_counts_a_matmul():
    """A 64x64 matmul: exactly 2·64³ flops (the JAX test's bound is half
    that, which the JAX package's own count meets too), and at least the
    operands' and the result's bytes."""
    x = torch.ones((64, 64), dtype=torch.float32)
    costs = t_prof.cost_analysis(lambda a: a @ a, x)
    assert costs["flops"] == 2 * 64 ** 3
    assert costs["bytes accessed"] >= 3 * 64 * 64 * 4
    j = j_prof.cost_analysis(lambda a: a @ a, jnp.ones((64, 64), jnp.float32))
    if "flops" in j:
        assert j["flops"] >= 2 * 64 ** 3 * 0.5
        assert costs["flops"] >= 2 * 64 ** 3 * 0.5


def test_speed_of_light_at_the_h100_peaks():
    """The bound is the larger of flops over 67 TFLOP/s and bytes over
    3.35 TB/s; the measured share follows from it."""
    x = torch.ones((64, 64), dtype=torch.float32)
    sol = t_prof.speed_of_light(lambda a: a @ a, x, measured_s=1.0)
    assert sol["t_compute_s"] == pytest.approx(2 * 64 ** 3 / 67e12)
    assert sol["t_memory_s"] == pytest.approx(sol["bytes"] / 3.35e12)
    assert sol["t_bound_s"] == max(sol["t_compute_s"], sol["t_memory_s"])
    assert sol["sol_fraction"] == pytest.approx(sol["t_bound_s"])
    assert "sol_fraction" not in t_prof.speed_of_light(lambda a: a + 1, x)


def test_trace_writes_a_chrome_trace(tmp_path):
    with t_prof.trace(str(tmp_path / "tr")) as prof:
        torch.ones(16, 16) @ torch.ones(16, 16)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert prof.key_averages() is not None
