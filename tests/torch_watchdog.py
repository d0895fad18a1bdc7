"""A time limit of its own for every test of the port, and module fixtures
built once per test run.

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
stack printed.

Under `--dist load` (the Tier-1 command) xdist does not hand the
crashed test to any worker again: the rest of the dead worker's queue
goes to the others. Under `--dist loadfile` it hands the crashed test to
the new worker again, with the rest of its file; so each watched test
leaves a marker file while it runs, and a test that finds its own
marker fails at once, since its earlier worker died in it. The markers
lie in the run's own temporary folder (the controller's pytest basetemp,
whose `popen-gwN` subfolders the workers use), which pytest deletes with
its old runs' folders; a marker of a crashed test under `--dist load`
stays there unread.

The limits are in tests/torch_time_limits.json, written by
`python tools/torch_tier1_soak.py --size XML...` from the junit reports
of Tier-1 runs and card runs. A test's limit is its own (`tests`, by
file and item name) plus its file's `setup` when its setup builds a
fixture of a wider scope than the function's that is not built yet (a
module fixture: rendered frames, both systems' runs). A test the table
does not list takes `default`. A module may name its own limits in a
dict `TIME_LIMITS` (item name -> seconds), which the table does not
override. Every watched test records two junit properties:
`watchdog_shared_setup_s`, the seconds of a setup that built such a
fixture in this process, and `watchdog_shared_read_s`, the seconds it
spent waiting for and reading a fixture that another process of the
run built (once_per_run; both 0.0 otherwise). The sizing tool splits
each test's time with them.

once_per_run(request, build) is how a module fixture is built once per
test run, not once per xdist worker: under `--dist load` the tests of
one file go to several workers, and a worker tears a module fixture
down whenever its next test is of another file. The first process to
ask builds the value under a file lock in the run's folder and writes
it there pickled; every other process (and the same one, after a
teardown) waits on the lock and reads it. A build that fails writes its
error, and every later reader fails with it; a process that dies while
building leaves its start marker, and every later reader fails on that.
Every caller, the building process too, gets the value through a pickle
round trip, so each test sees the same kind of copy with or without
xdist and runs its own assertions on it.

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
import fcntl
import hashlib
import json
import os
import pickle
import sys
import time
import traceback

import pytest

LIMITS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "torch_time_limits.json")
PLUGIN = "torch_watchdog"
SHARED_SETUP = "watchdog_shared_setup_s"
SHARED_READ = "watchdog_shared_read_s"
# tests/test_io.py::test_native_png_decoder_and_prefetch waits forever
# in native/dataloader.cpp's in-order delivery under load (vl_next at
# vins_tpu/io/native_loader.py:82, called from tests/test_io.py:100).
REFERENCE_TESTS = ("tests/test_io.py::test_native_png_decoder_and_prefetch",)

_table = None
_stderr_fd = None
_read_s = 0.0      # seconds once_per_run spent reading in this setup
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


def run_folder(config):
    """The folder every process of this xdist run shares: the
    controller's pytest basetemp, the parent of each worker's (None
    outside a worker)."""
    if getattr(config, "workerinput", None) is None:
        return None
    return str(config._tmp_path_factory.getbasetemp().parent)


def _marker(item):
    """The file a watched test leaves while it runs in an xdist worker
    (None outside one, where a stall ends the session)."""
    folder = run_folder(item.config)
    if folder is None:
        return None
    folder = os.path.join(folder, "torch_watchdog")
    os.makedirs(folder, exist_ok=True)
    return os.path.join(folder, hashlib.sha1(
        item.nodeid.encode()).hexdigest())


def _drop(marker: str) -> None:
    """Remove the marker, and its folder once no worker has one there."""
    os.remove(marker)
    with contextlib.suppress(OSError):
        os.rmdir(os.path.dirname(marker))


def _write(path: str, record) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(record, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def once_per_run(request, build):
    """build()'s value, built once per test run (module docstring): by
    this process if no other has, else read from the run's folder; always
    through a pickle round trip. Keyed by the module and the fixture's
    name (request: the fixture's)."""
    global _read_s
    folder = run_folder(request.config)
    if folder is None:
        return pickle.loads(pickle.dumps(build(),
                                         protocol=pickle.HIGHEST_PROTOCOL))
    folder = os.path.join(folder, "once_per_run")
    os.makedirs(folder, exist_ok=True)
    name = f"{request.module.__name__}.{request.fixturename}"
    path = os.path.join(folder, name)
    t0 = time.perf_counter()
    built = False
    with open(path + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path + ".pkl"):
            if os.path.exists(path + ".started"):
                pytest.fail(f"{name}: the worker that was building it died "
                            f"(past its time limit, or a crash)",
                            pytrace=False)
            open(path + ".started", "w").close()
            built = True
            try:
                value = build()
            except BaseException:
                _write(path + ".pkl", (False, traceback.format_exc()))
                raise
            _write(path + ".pkl", (True, value))
    with open(path + ".pkl", "rb") as f:
        ok, value = pickle.load(f)
    if not built:
        _read_s += time.perf_counter() - t0
    if not ok:
        pytest.fail(f"{name}: its build failed in another process of this "
                    f"run:\n{value}", pytrace=False)
    return value


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
    global _read_s
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
    _read_s = 0.0
    t0 = time.perf_counter()
    try:
        return (yield)
    finally:
        seconds = time.perf_counter() - t0 if shared else 0.0
        item.user_properties.append(
            (SHARED_SETUP, round(max(seconds - _read_s, 0.0), 2)))
        item.user_properties.append((SHARED_READ, round(_read_s, 2)))


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
