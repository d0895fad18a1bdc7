"""A watchdog for every test of the port that fails a stall, not a slow
test; module fixtures built once per test run; and an order of the
collection that starts those builds first.

Each tests/test_torch_*.py names this module in `pytest_plugins`; pytest
registers it when it imports the first such file.

The stall limit. For every test of a module that names this plugin, the
plugin arms faulthandler's watchdog (`dump_traceback_later(S, exit=True)`)
when the test's setup starts, with the stall limit S (the table's
`stall`), and cancels it when the test's teardown ends. A sampler thread
reads the test thread's Python stack every POLL seconds
(`sys._current_frames()`: each frame's code and line) and re-arms the
watchdog with S each time the stack has changed. A test that is slow but
moves keeps re-arming it; a test blocked in a lock, a wait, or a native
call that never returns stops re-arming, and the watchdog fires S after
the last change. faulthandler's own C thread fires it, with no need of
the GIL, so a native call that hangs holding the GIL is caught as well.
Firing dumps every thread's stack to the real stderr ("Timeout
(h:mm:ss)!", the time of the last arm) and ends the process with exit
code 1: under pytest-xdist the controller reports that test failed
("worker crashed while running ...") and starts a new worker for the
rest; without xdist the session ends there, with the stack printed.

The cap. Every test also has a total cap, its limit in the table (below):
past it the sampler stops re-arming, and the last arm ends exactly at the
cap, so a test that keeps moving still dies there. The time a test waits
for another process's build (once_per_run) does not count against its
cap: that build has a watchdog of its own.

The stall limit is sized from measurement: each watched test records
`watchdog_longest_still_s`, the longest interval in which the sampler saw
its stack unchanged (a long XLA compile of the reference is one), and S
is the sizing tool's factor times the longest such interval of any port
test, at least its floor. A module may name its own stall limit in
`STALL_LIMIT` (seconds).

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
of Tier-1 runs and card runs. A test's cap is its own limit (`tests`, by
file and item name) plus its file's `setup` when its setup builds a
fixture of a wider scope than the function's that is not built yet (a
module fixture: rendered frames, both systems' runs). A test the table
does not list takes `default`. No cap is below the table's `floor`. A
module may name its own caps in a dict `TIME_LIMITS` (item name ->
seconds), which the table does not override.
Every test records its start (`watchdog_start_s`, seconds since the
run's controller process started) and its worker (`watchdog_worker`: N
of xdist's gwN, -1 outside xdist) as junit properties, and every
watched test three more: `watchdog_shared_setup_s`, the seconds of a
setup that built such a fixture in this process,
`watchdog_shared_read_s`, the seconds it spent waiting for and reading
a fixture that another process of the run built (once_per_run; both 0.0
otherwise), and `watchdog_longest_still_s` (above). The sizing tool
splits each test's time with them, and its timeline reads them.

once_per_run(request, build) is how a module fixture is built once per
test run, not once per xdist worker: under `--dist load` the tests of
one file go to several workers, and a worker tears a module fixture down
whenever its next test is of another file. The first process to ask
takes a file lock in the run's folder, leaves a start marker naming
itself, builds the value and writes it there pickled; its sampler
touches the marker each time it sees the build's stack change. Every
other process (and the same one, after a teardown) reads the pickle; while
the build runs it polls the lock without blocking, and its own watchdog
is re-armed each time the marker's time moves. A reader fails at once,
naming the builder, when the marker is older than S (the build stalled),
when the lock is free but no pickle was written (the builder died), or
when the pickle holds the build's error. Every caller, the building
process too, gets the value through a pickle round trip, so each test
sees the same kind of copy with or without xdist and runs its own
assertions on it. A build may also write what it has so far to
shared_dir(request, name), for a build of another fixture that runs
beside it in another process: that one checks build_begun and waits on
it with follow_build, as a reader waits.

The order. Under `--dist load` xdist first hands each of its N workers
a chunk of consecutive items (a quarter of its share), then small
batches in collection order. The plugin reorders the collection, the
same way in every worker: the first test of each once_per_run fixture
(its builder) goes to the head of a worker's chunk, heaviest first by
the table's `setup_measured`, each to the worker with the least build
time so far; the fixture's other tests (its readers) go to the end of
the collection, so that they are handed out after the builds; every
other test keeps its relative order, but the first test of a module
fixture of a test that uses no once_per_run fixture, in a file whose
`setup_measured` is HEAVY_SETUP or more (a build per worker), which
heads a chunk as a builder does (a heavy build begun last would end the
run alone).

The JAX package's tests keep no limit, with one exception that this
plugin adds from outside its file: REFERENCE_TESTS, the reference's
tests whose stall has been seen and whose cause lies in the reference
(ROADMAP, "Faults of the reference"). Such a test fails at its fixed
limit (table `reference`; no re-arming) instead of holding the whole
run until the command is cut; a test that passes is not touched.
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
import threading
import time
import traceback

import pytest

LIMITS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "torch_time_limits.json")
PLUGIN = "torch_watchdog"
SHARED_SETUP = "watchdog_shared_setup_s"
SHARED_READ = "watchdog_shared_read_s"
LONGEST_STILL = "watchdog_longest_still_s"
START = "watchdog_start_s"
WORKER = "watchdog_worker"
POLL = 1.0          # seconds between two looks at the test's stack
READ_SLACK = 5.0    # a waiting reader's own watchdog runs this far past S,
                    # so that its check of the builder's marker fires first
BEGIN_WAIT = 15.0   # seconds build_begun waits for a build to begin
HEAVY_SETUP = 60.0  # a file's measured setup that puts its builds first
# tests/test_io.py::test_native_png_decoder_and_prefetch waits forever
# in native/dataloader.cpp's in-order delivery under load (vl_next at
# vins_tpu/io/native_loader.py:82, called from tests/test_io.py:100).
REFERENCE_TESTS = ("tests/test_io.py::test_native_png_decoder_and_prefetch",)

_table = None
_stderr_fd = None
_session_start = None
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
    """The cap: seconds for the item's setup, call and teardown together,
    the time it waits for another process's build left out; at least the
    table's floor."""
    key = _reference_key(item)
    if key in REFERENCE_TESTS:
        return float(table()["reference"][key])
    own = getattr(item.module, "TIME_LIMITS", {}).get(item.name)
    if own is not None:
        return float(own)
    entry = table()["files"].get(item.path.name, {})
    seconds = entry.get("tests", {}).get(item.name, table()["default"])
    return float(max(table()["floor"],
                     seconds + (entry.get("setup", 0) if shared else 0)))


def stall_of(item, cap: float) -> float:
    """The stall limit S (a reference test's is its cap: no re-arming)."""
    if _reference_key(item) in REFERENCE_TESTS:
        return cap
    return float(getattr(item.module, "STALL_LIMIT", table()["stall"]))


def _signature(frame) -> tuple:
    """The stack from frame outwards, by code and line."""
    sig = []
    while frame is not None:
        sig.append((frame.f_code, frame.f_lineno))
        frame = frame.f_back
    return tuple(sig)


class _Watchdog:
    """faulthandler's timer for the running test, re-armed with the stall
    limit by a sampler thread while the test's stack changes, and never
    past the test's cap (module docstring). One per process."""

    def __init__(self):
        self.lock = threading.Lock()
        self.sampler = None
        self.armed = False
        self.stall = None
        self.building = None    # the start marker of a build in progress
        self.deadline = float("inf")
        self.waiting, self.progress = False, 0

    def start(self, fd, cap: float, stall: float) -> None:
        with self.lock:
            now = time.monotonic()
            self.fd, self.stall, self.deadline = fd, stall, now + cap
            self.ident = threading.get_ident()
            self.sig, self.changed, self.longest = None, now, 0.0
            self.waiting, self.progress = False, 0
            self.armed, self.armed_at = True, None
            self._arm(now)
        if self.sampler is None:
            self.sampler = threading.Thread(target=self._sample, daemon=True,
                                            name="torch_watchdog sampler")
            self.sampler.start()

    def stop(self) -> float:
        """Cancel the timer; the longest still interval of the test."""
        with self.lock:
            if self.armed:
                faulthandler.cancel_dump_traceback_later()
                self.armed = False
                self.longest = max(self.longest,
                                   time.monotonic() - self.changed)
            return self.longest

    def _arm(self, now: float) -> None:
        """Arm the timer to fire S after now, or at the cap if that comes
        first (left as it is when it fires there already)."""
        stall = self.stall + (READ_SLACK if self.waiting else 0.0)
        fires = min(now + stall, self.deadline)
        if self.armed_at is not None and fires <= self.fires:
            return
        faulthandler.dump_traceback_later(max(fires - now, 0.001),
                                          exit=True, file=self.fd)
        self.armed_at, self.fires = now, fires

    def _sample(self) -> None:
        while True:
            time.sleep(POLL)
            with self.lock:
                if not self.armed:
                    continue
                sig = (("waiting", self.progress) if self.waiting else
                       _signature(sys._current_frames().get(self.ident)))
                if sig == self.sig:
                    continue
                now = time.monotonic()
                self.longest = max(self.longest, now - self.changed)
                self.sig, self.changed = sig, now
                if self.building is not None:
                    with contextlib.suppress(OSError):
                        os.utime(self.building)
                if now < self.deadline:
                    self._arm(now)

    def wait_step(self, seconds: float, moved: bool) -> None:
        """A reader's poll: its cap moves on by the time it waited, and
        it counts as progress when the builder's marker moved."""
        with self.lock:
            self.waiting = True
            self.deadline += seconds
            self.progress += bool(moved)
            if self.armed and self.fires >= self.deadline - seconds:
                self._arm(time.monotonic())     # the timer ends at the cap

    def wait_done(self) -> None:
        with self.lock:
            self.waiting = False


_dog = _Watchdog()


def run_folder(config):
    """The folder every process of this xdist run shares: the
    controller's pytest basetemp, the parent of each worker's (None
    outside a worker)."""
    if getattr(config, "workerinput", None) is None:
        return None
    return str(config._tmp_path_factory.getbasetemp().parent)


def _process_start(pid: int):
    """The process's start as a time.time() value (None off Linux)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime "))
    except (OSError, ValueError, IndexError, StopIteration):
        return None
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def session_start(config) -> float:
    """When the run began: the start of the xdist controller (a worker's
    parent process), or of this process outside xdist."""
    global _session_start
    if _session_start is None:
        worker = getattr(config, "workerinput", None) is not None
        _session_start = (_process_start(os.getppid() if worker
                                         else os.getpid()) or time.time())
    return _session_start


def _marker(item):
    """The file a watched test leaves while it runs in an xdist worker
    (None outside one, where a stall ends the session)."""
    folder = run_folder(item.config)
    if folder is None:
        return None
    return os.path.join(folder, "torch_watchdog", hashlib.sha1(
        item.nodeid.encode()).hexdigest())


def _leave(marker: str) -> None:
    """Create the marker, and its folder, which another worker's _drop
    may remove between the two."""
    while True:
        os.makedirs(os.path.dirname(marker), exist_ok=True)
        with contextlib.suppress(FileNotFoundError):
            open(marker, "w").close()
            return


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


def _read_text(path: str) -> str:
    with contextlib.suppress(OSError), open(path) as f:
        return f.read().strip()
    return "?"


def _try_lock(lock) -> bool:
    try:
        fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except BlockingIOError:
        return False
    return True


def _build(request, path: str, build) -> None:
    """Build under the lock: the start marker names this process and its
    test, and the sampler touches it while the build moves."""
    worker = getattr(request.config, "workerinput", {}).get("workerid", "?")
    with open(path + ".started", "w") as f:
        f.write(f"{worker} (pid {os.getpid()}) in "
                f"{request._pyfuncitem.nodeid}")
    _dog.building = path + ".started"
    try:
        value = build()
    except BaseException:
        _write(path + ".pkl", (False, traceback.format_exc()))
        raise
    finally:
        _dog.building = None
    _write(path + ".pkl", (True, value))


def once_per_run(request, build):
    """build()'s value, built once per test run (module docstring): by
    this process if no other has, else read from the run's folder; always
    through a pickle round trip. Keyed by the module and the fixture's
    name (request: the fixture's)."""
    global _read_s
    path = _once_path(request, request.fixturename)
    if path is None:
        return pickle.loads(pickle.dumps(build(),
                                         protocol=pickle.HIGHEST_PROTOCOL))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    name = os.path.basename(path)
    stall = stall_limit()
    t0 = time.perf_counter()
    built, seen = False, None   # seen: the marker's last mtime
    try:
        with open(path + ".lock", "a") as lock:
            while not os.path.exists(path + ".pkl"):
                if not _try_lock(lock):
                    try:
                        mtime = os.stat(path + ".started").st_mtime
                    except FileNotFoundError:
                        mtime = None    # the builder has just taken it
                    if mtime is not None and time.time() - mtime > stall:
                        pytest.fail(
                            f"{name}: its build made no progress for "
                            f"{time.time() - mtime:.0f} s (stall limit "
                            f"{stall:.0f} s) in "
                            f"{_read_text(path + '.started')}",
                            pytrace=False)
                    _dog.wait_step(POLL / 2, mtime != seen)
                    seen = mtime
                    time.sleep(POLL / 2)
                    continue
                try:
                    if os.path.exists(path + ".pkl"):
                        break
                    if os.path.exists(path + ".started"):
                        pytest.fail(
                            f"{name}: the process that was building it died "
                            f"(past its time limit, or a crash): "
                            f"{_read_text(path + '.started')}",
                            pytrace=False)
                    built = True
                    _build(request, path, build)
                finally:
                    fcntl.flock(lock, fcntl.LOCK_UN)
    finally:
        _dog.wait_done()
    with open(path + ".pkl", "rb") as f:
        ok, value = pickle.load(f)
    if not built:
        _read_s += time.perf_counter() - t0
    if not ok:
        pytest.fail(f"{name}: its build failed in another process of this "
                    f"run:\n{value}", pytrace=False)
    return value


def stall_limit() -> float:
    """The stall limit S of the running test (the table's outside one)."""
    return _dog.stall if _dog.stall is not None else float(table()["stall"])


def wait_until(done, progress, what: str) -> None:
    """Wait until done(), as a once_per_run reader waits on a build: the
    watchdog re-armed only when progress() (any value) changes, the cap
    moved on by the wait, and a failure at once, naming `what`, when
    progress() has not changed for the stall limit."""
    stall = stall_limit()
    seen, since = progress(), time.monotonic()
    try:
        while not done():
            now = progress()
            moved = now != seen
            if moved:
                seen, since = now, time.monotonic()
            elif time.monotonic() - since > stall:
                pytest.fail(f"{what} made no progress for "
                            f"{time.monotonic() - since:.0f} s (stall limit "
                            f"{stall:.0f} s)", pytrace=False)
            _dog.wait_step(POLL / 2, moved)
            time.sleep(POLL / 2)
    finally:
        _dog.wait_done()


def _once_path(request, fixturename: str):
    """The path (less its suffix) of the module's once_per_run fixture
    `fixturename` in the run's folder (None outside a worker)."""
    folder = run_folder(request.config)
    if folder is None:
        return None
    return os.path.join(folder, "once_per_run",
                        f"{request.module.__name__}.{fixturename}")


def shared_dir(request, name: str) -> str:
    """A folder that every process of the run sees under the module and
    `name` (in the run's folder; outside xdist, in the session's
    basetemp), for what a once_per_run build writes while it runs."""
    folder = (run_folder(request.config)
              or str(request.config._tmp_path_factory.getbasetemp()))
    path = os.path.join(folder, "once_per_run",
                        f"{request.module.__name__}.{name}.stream")
    os.makedirs(path, exist_ok=True)
    return path


def build_begun(request, fixturename: str) -> bool:
    """Whether a process of this xdist run has begun the once_per_run
    build of the module's fixture `fixturename`, waiting up to
    BEGIN_WAIT seconds for it (its builder heads another worker's first
    chunk, so it starts when this test does); False outside xdist."""
    path = _once_path(request, fixturename)
    if path is None:
        return False
    t0 = time.monotonic()
    while time.monotonic() - t0 < BEGIN_WAIT:
        if os.path.exists(path + ".started") or os.path.exists(path + ".pkl"):
            return True
        time.sleep(POLL / 4)
    return False


def follow_build(request, fixturename: str, ready) -> None:
    """Wait until ready() while another process of the run builds the
    module's once_per_run fixture `fixturename` (build_begun), whose build
    writes what ready() reads as it goes: as a once_per_run reader waits,
    re-armed while the builder's start marker moves, failing at once
    when the marker is older than the stall limit, when the builder died,
    or when the build ended, failed or not, without making ready()
    true. The wait counts as the test's read (watchdog_shared_read_s), as
    a once_per_run reader's does."""
    path = _once_path(request, fixturename)
    name = f"{request.module.__name__}.{fixturename}"
    if ready():
        return
    if path is None:
        pytest.fail(f"{name}: no other process of this run builds it",
                    pytrace=False)

    def done() -> bool:
        if ready():
            return True
        if os.path.exists(path + ".pkl"):
            if ready():     # it may have written it since the look above
                return True
            with open(path + ".pkl", "rb") as f:
                ok, value = pickle.load(f)
            pytest.fail(f"{name}: its build ended before this one had what "
                        f"it needs" + ("" if ok else f":\n{value}"),
                        pytrace=False)
        with open(path + ".lock", "a") as lock:
            if _try_lock(lock):
                fcntl.flock(lock, fcntl.LOCK_UN)
                if not os.path.exists(path + ".pkl"):
                    pytest.fail(f"{name}: the process that was building it "
                                f"died: {_read_text(path + '.started')}",
                                pytrace=False)
        return False

    def moved():
        with contextlib.suppress(FileNotFoundError):
            return os.stat(path + ".started").st_mtime

    global _read_s
    t0 = time.perf_counter()
    wait_until(done, moved, f"{name}'s build, in "
               f"{_read_text(path + '.started')},")
    _read_s += time.perf_counter() - t0


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


def _module_fixtures(item) -> list:
    """(name, built with once_per_run) of every fixture of a wider scope
    than the function's in the item's closure."""
    info = getattr(item, "_fixtureinfo", None)
    if info is None:
        return []
    defs = info.name2fixturedefs
    return [(name, "once_per_run" in getattr(getattr(
                defs[name][-1].func, "__code__", None), "co_names", ()))
            for name in item.fixturenames
            if defs.get(name) and defs[name][-1].scope != "function"]


def build_first_order(items: list, workers: int, chunk: int,
                      weight) -> list:
    """items reordered for xdist's `--dist load` with `workers` workers
    and initial chunks of `chunk` items (module docstring): the first item
    of each build (by module and fixture name: a once_per_run fixture, or
    a module fixture of an item that uses none and weighs HEAVY_SETUP or
    more) at the
    head of a chunk, heaviest first (weight(item) seconds), each to the
    chunk with the least weight so far; the other items of a once_per_run
    fixture at the end; every other item in its order."""
    first, readers = {}, set()
    for i, item in enumerate(items):
        fixtures = _module_fixtures(item)
        per_worker = (not any(once for _, once in fixtures)
                      and weight(item) >= HEAVY_SETUP)
        for name, once in fixtures:
            if not once and not per_worker:
                continue
            key = (item.path, name)
            if once and key in first and first[key] != i:
                readers.add(i)
            first.setdefault(key, i)
    builders = sorted(set(first.values()), key=lambda i: (-weight(items[i]),
                                                          i))
    readers -= set(builders)
    load = [0.0] * workers
    heads = [[] for _ in range(workers)]
    for i in builders:
        w = min(range(workers), key=lambda k: (load[k], len(heads[k]), k))
        if len(heads[w]) < chunk:
            heads[w].append(i)
            load[w] += weight(items[i])
    placed = {i for head in heads for i in head}
    rest = iter([i for i in range(len(items))
                 if i not in placed and i not in readers]
                + sorted(readers))
    slot = {w * chunk + j: i for w, head in enumerate(heads)
            for j, i in enumerate(head)}
    return [items[slot[p]] if p in slot else items[next(rest)]
            for p in range(len(items))]


def _dist_mode(config) -> str:
    """The run's `--dist` (xdist sets a worker's own option to "no"; with
    `-n` and no `--dist` it is "load")."""
    mode = "load"
    args = [str(a) for a in config.invocation_params.args]
    for i, arg in enumerate(args):
        if arg == "--dist" and i + 1 < len(args):
            mode = args[i + 1]
        elif arg.startswith("--dist="):
            mode = arg.split("=", 1)[1]
    return mode


@pytest.hookimpl(trylast=True)
def pytest_collection_modifyitems(config, items):
    """Under xdist's `--dist load`, the builders first (build_first_order),
    with the chunk that xdist 3's LoadScheduling gives each worker."""
    workerinput = getattr(config, "workerinput", None)
    if workerinput is None or _dist_mode(config) != "load":
        return
    workers = int(workerinput["workercount"])
    if len(items) < 2 * workers:
        return
    chunk = max(min(len(items) // workers // 4,
                    config.getoption("maxschedchunk", None) or len(items)),
                2)
    files = table()["files"]
    items[:] = build_first_order(
        items, workers, chunk,
        lambda item: files.get(item.path.name, {}).get("setup_measured", 0))


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
    workerinput = getattr(item.config, "workerinput", None) or {}
    item.user_properties.append(
        (START, round(time.time() - session_start(item.config), 2)))
    item.user_properties.append(
        (WORKER, int(workerinput.get("workerid", "gw-1")[2:])))
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
        _leave(marker)
    cap = limit_of(item, shared)
    _dog.start(_real_stderr(item.config), cap, stall_of(item, cap))
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
            item.user_properties.append(
                (LONGEST_STILL, round(_dog.stop(), 2)))
            if marker:
                _drop(marker)
