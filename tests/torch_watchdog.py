"""A time limit of its own for every test of the port.

Each tests/test_torch_*.py names this module in `pytest_plugins`; pytest
registers it when it imports the first such file. For every test of a
module that names it, the plugin arms faulthandler's watchdog
(`dump_traceback_later(limit, exit=True)`) when the test's setup starts
and cancels it when its teardown ends, so the limit covers the module
fixtures that the setup builds as well as the call. A test that runs
past its limit dumps every thread's stack to the real stderr and ends
its process with exit code 1: under pytest-xdist the controller reports
that test failed ("worker crashed while running ...") and starts a new
worker for the rest; without xdist the session ends there, with the
stack printed. Under `--dist loadfile` xdist hands the crashed test to
the new worker again, with the rest of its file: each watched test
leaves a marker file while it runs (under the temporary directory,
per xdist test run), and a test that finds its own marker fails at
once, since its earlier worker died in it.

The limits are in tests/torch_time_limits.json, written by
`python tools/torch_tier1_soak.py --size XML...` from the junit reports
of Tier-1 runs and card runs. A test's limit is its own (`tests`, by
file and item name) plus its file's `setup` when its setup builds a
fixture of a wider scope than the function's that is not built yet (a
module fixture: rendered frames, both systems' runs). A test the table
does not list takes `default`. A module may name its own limits in a
dict `TIME_LIMITS` (item name -> seconds), which the table does not
override. Every watched test records, as the junit property
`watchdog_shared_setup_s`, the seconds of a setup that built such a
fixture (0.0 otherwise): the sizing tool splits each test's time with
it.

The JAX package's tests keep no limit, with one exception that this
plugin adds from outside its file: REFERENCE_TESTS, the reference's
tests whose stall has been seen and whose cause lies in the reference
(ROADMAP, "Faults of the reference"). Such a test fails at its limit
(table `reference`) instead of holding the whole run until the command
is cut; a test that passes is not touched.
"""
from __future__ import annotations

import contextlib
import faulthandler
import hashlib
import json
import os
import sys
import tempfile
import time

import pytest

LIMITS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "torch_time_limits.json")
PLUGIN = "torch_watchdog"
SHARED_SETUP = "watchdog_shared_setup_s"
# tests/test_io.py::test_native_png_decoder_and_prefetch waits forever
# in native/dataloader.cpp's in-order delivery under load (vl_next at
# vins_tpu/io/native_loader.py:82, called from tests/test_io.py:100).
REFERENCE_TESTS = ("tests/test_io.py::test_native_png_decoder_and_prefetch",)

_table = None
_stderr_fd = None
_armed = pytest.StashKey[str]()
_died_in = pytest.StashKey[bool]()


def table() -> dict:
    global _table
    if _table is None:
        with open(LIMITS_PATH) as f:
            _table = json.load(f)
    return _table


def _reference_key(item) -> str:
    return f"tests/{item.path.name}::{item.name}"


def watched(item) -> bool:
    """Whether the test's module names this plugin, or the test is one
    of REFERENCE_TESTS."""
    plugins = getattr(getattr(item, "module", None), "pytest_plugins", ())
    return (PLUGIN in ([plugins] if isinstance(plugins, str) else plugins)
            or _reference_key(item) in REFERENCE_TESTS)


def builds_shared(item) -> bool:
    """Whether the item's setup builds a fixture of a wider scope than
    the function's that is not built yet (pytest drops a module
    fixture's cached value when it tears the fixture down)."""
    defs = item._fixtureinfo.name2fixturedefs
    return any(defs[name][-1].scope != "function"
               and defs[name][-1].cached_result is None
               for name in item.fixturenames if defs.get(name))


def limit_of(item, shared: bool) -> float:
    """Seconds for the item's setup, call and teardown together."""
    key = _reference_key(item)
    if key in REFERENCE_TESTS:
        return float(table()["reference"][key])
    own = getattr(item.module, "TIME_LIMITS", {}).get(item.name)
    if own is not None:
        return float(own)
    entry = table()["files"].get(item.path.name, {})
    seconds = entry.get("tests", {}).get(item.name, table()["default"])
    return float(seconds + (entry.get("setup", 0) if shared else 0))


def _marker(item):
    """The file a watched test leaves while it runs in an xdist worker
    (None outside one, where a stall ends the session)."""
    worker = getattr(item.config, "workerinput", None)
    if worker is None:
        return None
    folder = os.path.join(tempfile.gettempdir(),
                          f"torch_watchdog_{worker['testrunuid']}")
    os.makedirs(folder, exist_ok=True)
    return os.path.join(folder, hashlib.sha1(
        item.nodeid.encode()).hexdigest())


def _drop(marker: str) -> None:
    """Remove the marker, and its folder once no worker has one there."""
    os.remove(marker)
    with contextlib.suppress(OSError):
        os.rmdir(os.path.dirname(marker))


def _real_stderr(config) -> int:
    """A copy of the process's stderr taken outside pytest's capture."""
    global _stderr_fd
    if _stderr_fd is None:
        capman = config.pluginmanager.getplugin("capturemanager")
        with (capman.global_and_fixture_disabled() if capman is not None
              else contextlib.nullcontext()):
            sys.stderr.flush()
            _stderr_fd = os.dup(2)
    return _stderr_fd


@pytest.hookimpl(tryfirst=True, specname="pytest_runtest_setup")
def pytest_refuse_a_test_that_stalled(item):
    """Fail, before any fixture is built, a test in which an earlier
    worker died (pytest_runtest_setup below found its marker)."""
    if item.stash.get(_died_in, False):
        pytest.fail(f"{item.nodeid}: an earlier worker died in this test "
                    f"(past its time limit, its stack above, or a crash)",
                    pytrace=False)


@pytest.hookimpl(wrapper=True, tryfirst=True)
def pytest_runtest_setup(item):
    if not watched(item):
        return (yield)
    marker = _marker(item)
    if marker is not None and os.path.exists(marker):
        item.stash[_died_in] = True
        _drop(marker)
        return (yield)    # pytest_refuse_a_test_that_stalled fails it
    shared = builds_shared(item)
    item.stash[_armed] = marker or ""
    if marker is not None:
        open(marker, "w").close()
    faulthandler.dump_traceback_later(limit_of(item, shared), exit=True,
                                      file=_real_stderr(item.config))
    t0 = time.perf_counter()
    try:
        return (yield)
    finally:
        item.user_properties.append(
            (SHARED_SETUP, round(time.perf_counter() - t0, 3) if shared
             else 0.0))


@pytest.hookimpl(wrapper=True, trylast=True)
def pytest_runtest_teardown(item):
    try:
        return (yield)
    finally:
        marker = item.stash.get(_armed, None)
        if marker is not None:
            faulthandler.cancel_dump_traceback_later()
            if marker:
                _drop(marker)
