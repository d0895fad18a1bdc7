"""The port tests' time limits (tests/torch_watchdog.py): a planted stall
fails alone, with its stack, and the run goes on, under `--dist loadfile`
and under the Tier-1 command's `--dist load`; the card's command
(chip_smoke.CARD_TEST_ARGS) arms the same limits; every port test file
names the watchdog and every test in it has a limit of at least the
table's factor times its measured time. A module fixture built with
torch_watchdog.once_per_run is built once in a run of two workers and
read by the other, whose tests run their own assertions on it; a build
that fails fails every test that reads it. The stall rule: a build that
moves runs past three times its stall limit and its readers pass; a
build that blocks, or a test whose stack stands still, dies within the
stall limit and one poll, its readers failing at once with the
builder's name; a test that moves dies at its cap all the same. A build
can follow another as it goes (follow_build). Under --dist load every
worker collects the same reordered list, the builders at the heads of
the first chunks."""
import ast
import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from types import SimpleNamespace

import pytest

pytest_plugins = ["torch_watchdog"]

SHARED_SETUP, SHARED_READ = "watchdog_shared_setup_s", "watchdog_shared_read_s"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")

# A test that sleeps past its 2 s limit, then one that passes.
PLANTED = '''
import time
import pytest
pytest_plugins = ["torch_watchdog"]
TIME_LIMITS = {"test_sleeps_past_its_limit": 2, "test_after_the_stall": 30}

@pytest.mark.gpu
def test_sleeps_past_its_limit():
    time.sleep(120)

@pytest.mark.gpu
def test_after_the_stall():
    assert True
'''


# A module fixture built once per run: its build appends the building
# process's pid to PLANTED_BUILDS and fails if PLANTED_FAIL is set; each test
# appends (its pid, the building process's) to PLANTED_RAN and asserts the value.
PLANTED_SHARED = '''
import os
import time
import pytest
import torch_watchdog
pytest_plugins = ["torch_watchdog"]
TIME_LIMITS = {f"test_reads_the_shared_value[{i}]": 60 for i in range(4)}

def build():
    with open(os.environ["PLANTED_BUILDS"], "a") as f:
        f.write(f"{os.getpid()}\\n")
    time.sleep(3)
    if os.environ.get("PLANTED_FAIL"):
        raise RuntimeError("planted build failure")
    return dict(value=[1, 2, 3], pid=os.getpid())

@pytest.fixture(scope="module")
def shared(request):
    return torch_watchdog.once_per_run(request, build)

@pytest.mark.parametrize("i", range(4))
def test_reads_the_shared_value(shared, i):
    with open(os.environ["PLANTED_RAN"], "a") as f:
        f.write(f"{os.getpid()} {shared['pid']}\\n")
    assert shared["value"] == [1, 2, 3]
'''


def _run_planted(tmp_path, args, source=PLANTED, env=None, test=""):
    (tmp_path / "test_torch_planted.py").write_text(source)
    env = dict(os.environ, PYTHONPATH=TESTS, **(env or {}))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-c",
         os.path.join(ROOT, "pytest.ini"), "--rootdir", str(tmp_path),
         *args, "test_torch_planted.py" + test],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    return proc, proc.stdout + proc.stderr, time.monotonic() - t0


def test_planted_stall_fails_alone_and_the_run_goes_on(tmp_path):
    """Under pytest-xdist with --dist loadfile (the Tier-1 command's
    runner): the stalled test dumps its threads' stacks and fails, its
    worker is replaced, the new worker refuses the stalled test at once
    (xdist hands it over again with the rest of its file), the next test
    runs and passes, and the whole child takes well under 60 s."""
    proc, out, seconds = _run_planted(
        tmp_path, ["-p", "no:cacheprovider", "-o", "addopts=", "-p", "xdist",
                   "-n", "1", "--dist", "loadfile", "-q", "-rA"])
    assert proc.returncode == 1, out
    assert "Timeout (0:00:02)!" in out, out
    assert "in test_sleeps_past_its_limit" in out, out
    assert ("crashed while running 'test_torch_planted.py::"
            "test_sleeps_past_its_limit'") in out, out
    assert "FAILED test_torch_planted.py::test_sleeps_past_its_limit" in out
    assert "an earlier worker died in this test" in out, out
    assert out.count("Timeout (0:00:02)!") == 1, out
    assert "PASSED test_torch_planted.py::test_after_the_stall" in out, out
    assert "1 failed, 1 passed, 1 error" in out, out
    assert seconds < 45, seconds


def test_planted_stall_under_dist_load(tmp_path):
    """Under the Tier-1 command's --dist load: the stalled test dumps its
    threads' stacks and fails, its worker is replaced, and xdist hands
    the rest of its queue (not the stalled test) to the new worker, where
    the next test runs and passes; nothing refuses a test, and the whole
    child takes well under 60 s."""
    proc, out, seconds = _run_planted(
        tmp_path, ["-p", "no:cacheprovider", "-o", "addopts=", "-p", "xdist",
                   "-n", "1", "--dist", "load", "-q", "-rA"])
    assert proc.returncode == 1, out
    assert out.count("Timeout (0:00:02)!") == 1, out
    assert "in test_sleeps_past_its_limit" in out, out
    assert ("crashed while running 'test_torch_planted.py::"
            "test_sleeps_past_its_limit'") in out, out
    assert "an earlier worker died in this test" not in out, out
    assert "PASSED test_torch_planted.py::test_after_the_stall" in out, out
    assert "1 failed, 1 passed in" in out, out
    assert seconds < 45, seconds


def _shared_run(tmp_path, fail):
    builds, ran = tmp_path / "builds", tmp_path / "ran"
    env = dict(PLANTED_BUILDS=str(builds), PLANTED_RAN=str(ran))
    if fail:
        env["PLANTED_FAIL"] = "1"
    proc, out, _ = _run_planted(
        tmp_path, ["-p", "no:cacheprovider", "-o", "addopts=", "-p", "xdist",
                   "-n", "2", "--dist", "load", "-q", "-rA",
                   "--junitxml", str(tmp_path / "junit.xml")],
        source=PLANTED_SHARED, env=env)
    props = {}
    for case in ET.parse(tmp_path / "junit.xml").getroot().iter("testcase"):
        props[case.get("name")] = {
            p.get("name"): float(p.get("value")) for p in case.iter("property")}
    read = lambda path: (path.read_text().split("\n")[:-1]
                         if path.exists() else [])
    return proc, out, read(builds), read(ran), props


def test_once_per_run_builds_once_and_every_reader_asserts(tmp_path):
    """Two workers under --dist load, four tests of one module fixture
    built with once_per_run: one build in the whole run; both workers ran
    tests (the second got the first's value through the run's folder),
    each test ran its own assertion and passed; the junit properties
    record one build (watchdog_shared_setup_s over the build's 3 s sleep)
    and a read of about as long in the other worker."""
    proc, out, builds, ran, props = _shared_run(tmp_path, fail=False)
    assert proc.returncode == 0, out
    assert "4 passed" in out, out
    assert len(builds) == 1, builds
    pids = {line.split()[0] for line in ran}
    assert len(ran) == 4 and len(pids) == 2, ran
    assert {line.split()[1] for line in ran} == set(builds), (ran, builds)
    built = [p for p in props.values() if p[SHARED_SETUP] > 2.5]
    read = [p for p in props.values() if p[SHARED_READ] > 0.0]
    assert len(built) == 1 and len(read) >= 1, props
    assert all(p[SHARED_SETUP] < 1.0 for p in read), props


def test_once_per_run_build_failure_fails_every_reader(tmp_path):
    """The same run with the build raising: built once, and all four
    tests fail, in the other worker with the build's error named."""
    proc, out, builds, ran, _ = _shared_run(tmp_path, fail=True)
    assert proc.returncode == 1, out
    assert len(builds) == 1 and not ran, (builds, ran)
    assert "4 error" in out, out
    assert "planted build failure" in out, out
    assert "its build failed in another process of this run" in out, out


def test_card_command_arms_the_limits(tmp_path):
    """chip_smoke.CARD_TEST_ARGS (no conftest, no addopts, no xdist, -m
    gpu) load the watchdog from the test file: the stalled test dumps its
    stacks and ends the session with exit code 1 well under 60 s."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    proc, out, seconds = _run_planted(tmp_path,
                                      list(chip_smoke.CARD_TEST_ARGS))
    assert proc.returncode == 1, out
    assert "Timeout (0:00:02)!" in out, out
    assert "in test_sleeps_past_its_limit" in out, out
    assert seconds < 45, seconds


# A heartbeat the planted tests leave: "start T" when the watched code
# begins, then the time every 0.1 s until the process ends; the last line
# is about when the watchdog ended the process.
HEARTBEAT = '''
import os
import threading
import time

def heartbeat(label):
    path = os.environ["PLANTED_BEATS"] + "." + label
    with open(path, "a") as f:
        f.write(f"start {time.time()}\\n")

    def beat():
        while True:
            with open(path, "a") as f:
                f.write(f"{time.time()}\\n")
            time.sleep(0.1)

    threading.Thread(target=beat, daemon=True).start()

def moving(seconds):
    """Busy for `seconds`, the stack a different depth at every look."""
    def step(n):
        if n:
            return step(n - 1)
        time.sleep(0.2)
    for i in range(int(seconds / 0.2)):
        step(i % 7)
'''

# A module fixture built once per run by a build that moves for MOVE_S
# seconds (three times the module's stall limit of 3 s) or, with
# PLANTED_BLOCK set, blocks for good; four tests read it, and a test of
# its own runs beside them.
PLANTED_SLOW_BUILD = HEARTBEAT + '''
import pytest
import torch_watchdog
pytest_plugins = ["torch_watchdog"]
STALL_LIMIT = 3
MOVE_S = 9
TIME_LIMITS = {**{f"test_reads[{i}]": 60 for i in range(4)},
               "test_beside": 60}

def build():
    heartbeat("build")
    if os.environ.get("PLANTED_BLOCK"):
        threading.Event().wait()
    moving(MOVE_S)
    return dict(value=[1, 2, 3], pid=os.getpid())

@pytest.fixture(scope="module")
def shared(request):
    return torch_watchdog.once_per_run(request, build)

@pytest.mark.parametrize("i", range(4))
def test_reads(shared, i):
    assert shared["value"] == [1, 2, 3]

def test_beside():
    assert True
'''

# A test whose stack stays still, and one that keeps moving past its cap.
PLANTED_STILL = HEARTBEAT + '''
import pytest
pytest_plugins = ["torch_watchdog"]
STALL_LIMIT = 3
TIME_LIMITS = {"test_still": 60, "test_moves_past_its_cap": 5}

def test_still():
    heartbeat("still")
    time.sleep(120)

def test_moves_past_its_cap():
    heartbeat("cap")
    moving(120)
'''


def _beats(tmp_path, label):
    """(start, last beat) of the planted heartbeat `label`."""
    lines = (tmp_path / f"beats.{label}").read_text().split("\n")[:-1]
    return float(lines[0].split()[1]), float(lines[-1])


def _xdist(n, junit=None):
    args = ["-p", "no:cacheprovider", "-o", "addopts=", "-p", "xdist",
            "-n", str(n), "--dist", "load", "-q", "-rA"]
    return args + (["--junitxml", str(junit)] if junit else [])


def test_slow_build_that_moves_passes_and_so_do_its_readers(tmp_path):
    """Two workers: a build that moves for three times its 3 s stall
    limit is not ended (its sampler re-arms the watchdog at every change
    and touches its marker), and its four readers, in either worker,
    wait on the marker's moves and pass, as does the test beside them;
    every test records its worker and its longest still interval, under
    the stall limit."""
    proc, out, _ = _run_planted(
        tmp_path, _xdist(2, tmp_path / "junit.xml"),
        source=PLANTED_SLOW_BUILD,
        env=dict(PLANTED_BEATS=str(tmp_path / "beats")))
    assert proc.returncode == 0, out
    assert "5 passed" in out and "Timeout" not in out, out
    start, last = _beats(tmp_path, "build")
    assert last - start > 3 * 3, (start, last)
    props = [{p.get("name"): float(p.get("value"))
              for p in case.iter("property")}
             for case in ET.parse(tmp_path / "junit.xml").getroot().iter(
                 "testcase")]
    assert max(p[SHARED_SETUP] for p in props) > 3 * 3, props
    assert all(0 <= p["watchdog_longest_still_s"] < 3 for p in props), props
    assert {p["watchdog_worker"] for p in props} == {0, 1}, props


def test_blocked_build_dies_within_the_stall_limit(tmp_path):
    """The same run with the build blocked in threading.Event().wait():
    its worker dies within the 3 s stall limit plus one poll of the
    build's start, its stack (the wait, in build) on stderr; its readers
    fail at once, naming the builder's test; the test beside them
    passes."""
    import torch_watchdog

    proc, out, seconds = _run_planted(
        tmp_path, _xdist(2), source=PLANTED_SLOW_BUILD,
        env=dict(PLANTED_BEATS=str(tmp_path / "beats"), PLANTED_BLOCK="1"))
    assert proc.returncode == 1, out
    start, last = _beats(tmp_path, "build")
    assert last - start < 3 + torch_watchdog.POLL + 0.5, last - start
    assert out.count("Timeout (0:00:03)!") == 1, out
    assert "in build" in out and "in wait" in out, out
    builder = re.findall(r"crashed while running '([^']+)'", out)
    assert len(builder) == 1 and "::test_reads[" in builder[0], out
    readers = [line for line in out.splitlines()
               if line.startswith("test_torch_planted.shared: ")]
    assert len(readers) == 3, out
    assert all(line.endswith(f" in {builder[0]}") for line in readers), \
        readers
    assert "PASSED test_torch_planted.py::test_beside" in out, out
    assert "1 passed" in out, out
    assert seconds < 45, seconds


@pytest.mark.parametrize("test", ["test_still", "test_moves_past_its_cap"])
def test_still_test_dies_at_the_stall_limit_moving_one_at_its_cap(
        tmp_path, test):
    """One xdist worker: a test whose stack never changes dies within its
    3 s stall limit plus one poll; a test that keeps moving is re-armed
    past the stall limit and dies at its 5 s cap all the same. Each
    dumps its stack and fails alone."""
    import torch_watchdog

    proc, out, _ = _run_planted(
        tmp_path, _xdist(1), source=PLANTED_STILL,
        env=dict(PLANTED_BEATS=str(tmp_path / "beats")), test=f"::{test}")
    assert proc.returncode == 1, out
    assert f"crashed while running 'test_torch_planted.py::{test}'" in out
    assert out.count("Timeout (") == 1 and f"in {test}" in out, out
    start, last = _beats(tmp_path, "still" if test == "test_still"
                         else "cap")
    if test == "test_still":
        assert last - start < 3 + torch_watchdog.POLL + 0.5, last - start
    else:
        assert 3 + torch_watchdog.POLL < last - start < 5 + 0.5, \
            last - start


# Two once_per_run fixtures, the second's build following the first's as
# it writes its steps to torch_watchdog.shared_dir (the revisit lockstep's
# two halves); with PLANTED_DIE the first's builder dies after step 1.
PLANTED_FOLLOW = '''
import os
import time
import pytest
import torch_watchdog
pytest_plugins = ["torch_watchdog"]
TIME_LIMITS = {"test_first": 60, "test_second": 60}

def steps(folder):
    return len(os.listdir(folder))

def build_first(folder):
    for k in range(6):
        open(os.path.join(folder, str(k)), "w").close()
        if k == 1 and os.environ.get("PLANTED_DIE"):
            os._exit(1)
        time.sleep(0.5)
    return "first"

@pytest.fixture(scope="module")
def first(request):
    folder = torch_watchdog.shared_dir(request, "first")
    return torch_watchdog.once_per_run(request, lambda: build_first(folder))

@pytest.fixture(scope="module")
def second(request):
    folder = torch_watchdog.shared_dir(request, "first")
    assert torch_watchdog.build_begun(request, "first")

    def build():
        torch_watchdog.follow_build(request, "first",
                                    lambda: steps(folder) >= 5)
        return ("second", steps(folder))

    return torch_watchdog.once_per_run(request, build)

def test_first(first):
    assert first == "first"

def test_second(second):
    assert second[0] == "second" and second[1] >= 5
'''


@pytest.mark.parametrize("case", ["moves", "dies"])
def test_follow_build_reads_another_build_as_it_goes(tmp_path, case):
    """Two workers under --dist load, each heading with one of two
    once_per_run builds: the second's build follows the first's steps in
    torch_watchdog.shared_dir as they come (follow_build) and both pass,
    the two builds running at once, the second's wait recorded as its
    read; when the first's builder dies, the second fails at once, naming
    it."""
    env = dict(PLANTED_DIE="1") if case == "dies" else {}
    proc, out, seconds = _run_planted(
        tmp_path, _xdist(2, tmp_path / "junit.xml"), source=PLANTED_FOLLOW,
        env=env)
    props = {case.get("name"): {p.get("name"): float(p.get("value"))
                                for p in case.iter("property")}
             for case in ET.parse(tmp_path / "junit.xml").getroot().iter(
                 "testcase")}
    if case == "moves":
        assert proc.returncode == 0 and "2 passed" in out, out
        first, second = props["test_first"], props["test_second"]
        assert {first["watchdog_worker"], second["watchdog_worker"]} \
            == {0, 1}, props
        assert abs(first["watchdog_start_s"] - second["watchdog_start_s"]) \
            < 2.0, props
        assert first[SHARED_SETUP] > 2.0 and second[SHARED_READ] > 1.5, \
            props
    else:
        assert proc.returncode == 1, out
        assert "crashed while running 'test_torch_planted.py::test_first'" \
            in out, out
        assert ("test_torch_planted.first: the process that was building "
                "it died: gw") in out, out
        assert "in test_torch_planted.py::test_first" in out, out
        assert seconds < 45, seconds


# Writes each worker's collection to PLANTED_ORDER.<worker> (a plugin
# given with -p).
RECORD_COLLECTION = '''
import os

def pytest_collection_finish(session):
    worker = getattr(session.config, "workerinput", {}).get("workerid")
    with open(os.environ["PLANTED_ORDER"] + "." + worker, "w") as f:
        f.write("\\n".join(item.nodeid for item in session.items))
'''

# A module whose fixture `shared` is built once per run; {tests} follow.
PLANTED_BUILDERS = '''
import pytest
import torch_watchdog
pytest_plugins = ["torch_watchdog"]
TIME_LIMITS = {{f"test_{{k}}": 60 for k in range(8)}}

@pytest.fixture(scope="module")
def shared(request):
    return torch_watchdog.once_per_run(request, lambda: {tag!r})

{tests}
'''


def test_builders_go_first_and_every_worker_collects_the_same(tmp_path):
    """Two workers under --dist load, two modules with a once_per_run
    fixture each: both workers collect the same reordered list, whose
    xdist chunks (2 items each here) open with the two builders, the
    readers at the end and every other test in its order; the run
    passes. build_first_order itself, on stand-in items: heaviest first,
    each builder at the head of the least loaded worker's chunk, the first
    test of a heavy per-worker module fixture too (its other tests stay
    in order), a light one's not."""
    import torch_watchdog

    reads = "\n".join(f"def test_{k}(shared):\n    assert shared\n"
                      for k in range(3))
    plain = "\n".join(f"def test_{k}():\n    assert True\n"
                      for k in range(3, 6))
    (tmp_path / "test_torch_planted_a.py").write_text(
        PLANTED_BUILDERS.format(tag="a", tests=reads))
    (tmp_path / "test_torch_planted_b.py").write_text(
        PLANTED_BUILDERS.format(tag="b", tests=plain + "\n" + reads))
    (tmp_path / "record_collection.py").write_text(RECORD_COLLECTION)
    env = dict(os.environ, PYTHONPATH=f"{TESTS}:{tmp_path}",
               PLANTED_ORDER=str(tmp_path / "order"))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-c",
         os.path.join(ROOT, "pytest.ini"), "--rootdir", str(tmp_path),
         *_xdist(2), "-p", "record_collection",
         "test_torch_planted_a.py", "test_torch_planted_b.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0 and "9 passed" in out, out
    orders = [(tmp_path / f"order.gw{w}").read_text().split("\n")
              for w in range(2)]
    assert orders[0] == orders[1], orders
    a, b = "test_torch_planted_a.py::test_", "test_torch_planted_b.py::test_"
    # 9 items, 2 workers: chunks of max(9 // 2 // 4, 2) = 2 items.
    assert orders[0] == [a + "0", b + "3", b + "0", b + "4", b + "5",
                         a + "1", a + "2", b + "1", b + "2"], orders[0]

    def item(name, weight, fixture="once"):
        func = {"once": lambda request: torch_watchdog.once_per_run(
                    request, None),
                "per worker": lambda request: None}.get(fixture)
        defs = {"shared": [SimpleNamespace(scope="module", func=func)]}
        return SimpleNamespace(
            name=name, weight=weight, path=name.split(":")[0],
            fixturenames=["shared"] if func else [],
            _fixtureinfo=SimpleNamespace(name2fixturedefs=defs))

    items = ([item(f"f{k}:0", w) for k, w in enumerate((10, 40, 30, 20))]
             + [item(f"o:{k}", 0, fixture=None) for k in range(6)]
             + [item(f"h:{k}", 70, fixture="per worker") for k in range(2)]
             + [item("l:0", 5, fixture="per worker")]
             + [item(f"f{k}:1", 0) for k in range(4)])
    # A heavy file's per-worker fixture beside a once_per_run one (f3's
    # reader also builds "derived" per worker): no builder of its own.
    derived = SimpleNamespace(scope="module", func=lambda request: None)
    items[-1]._fixtureinfo.name2fixturedefs = dict(
        items[-1]._fixtureinfo.name2fixturedefs, derived=[derived])
    items[-1].fixturenames = ["shared", "derived"]
    items[-1].weight = 70
    got = [i.name for i in torch_watchdog.build_first_order(
        items, 3, 3, lambda i: i.weight)]
    # h:0 (70, a heavy per-worker fixture: its other test stays) -> w0,
    # f1 (40) -> w1, f2 (30) -> w2, f3 (20) -> w2, f0 (10) -> w1.
    assert got == ["h:0", "o:0", "o:1", "f1:0", "f0:0", "o:2",
                   "f2:0", "f3:0", "o:3", "o:4", "o:5", "h:1", "l:0",
                   "f0:1", "f1:1", "f2:1", "f3:1"], got


def _port_files():
    return sorted(f for f in os.listdir(TESTS)
                  if f.startswith("test_torch_") and f.endswith(".py"))


@pytest.mark.parametrize("name", _port_files())
def test_every_port_test_has_a_limit(name):
    """The file names the watchdog in pytest_plugins, and every test
    function in it has a limit in tests/torch_time_limits.json (each of
    its cases, by the function's name) of at least the table's factor
    times its measured time; the file's shared setup limit is the factor
    times its measured setup."""
    import torch_watchdog

    with open(os.path.join(TESTS, name)) as f:
        tree = ast.parse(f.read())
    plugins = [node.value for node in tree.body
               if isinstance(node, ast.Assign)
               and any(getattr(t, "id", None) == "pytest_plugins"
                       for t in node.targets)]
    assert plugins and torch_watchdog.PLUGIN in ast.literal_eval(plugins[0])
    with open(torch_watchdog.LIMITS_PATH) as f:
        table = json.load(f)
    entry = table["files"][name]
    cases = {}
    for case in entry["tests"]:
        cases.setdefault(case.split("[")[0], []).append(case)
    functions = [node.name for node in tree.body
                 if isinstance(node, ast.FunctionDef)
                 and node.name.startswith("test_")]
    missing = [fn for fn in functions if fn not in cases]
    assert not missing, f"no time limit for {missing}: run tools/" \
        "torch_tier1_soak.py --size (README)"
    for case, limit in entry["tests"].items():
        assert limit >= table["factor"] * entry["measured"][case], case
    assert entry["setup"] >= table["factor"] * entry["setup_measured"]


def _soak():
    spec = importlib.util.spec_from_file_location(
        "torch_tier1_soak", os.path.join(ROOT, "tools", "torch_tier1_soak.py"))
    soak = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(soak)
    return soak


def test_sizing_splits_the_shared_setup_from_each_test(tmp_path):
    """tools/torch_tier1_soak.py --size: a test's limit is 3x its own time
    (its time less the shared setup the watchdog recorded as built and as
    read from another worker); its file's setup limit 3x the largest
    build; the largest of two reports counts; a test no report lists
    takes 0 (its cap is the floor), or, with an earlier table to keep,
    where every report skipped it, that table's measured time; the stall
    limit 3x the longest still interval of any port test, at least the
    floor, a slow run's too (whose times size nothing); a heavy build's setup limit is the room left beside the
    file's largest test limit where that is more; a report of an older
    tree (old) sizes no build of a file the tree rebuilt, and every
    test's own time all the same. limit_shares
    reads each test's share of its cap (its time less its wait for
    another worker's build; the cap its limit, the file's setup included
    where its setup built or read, at least the floor)."""
    soak = _soak()
    case = ('<testcase classname="tests.test_torch_x" name="{}" time="{}">'
            '<properties><property name="watchdog_shared_setup_s" '
            'value="{}"/><property name="watchdog_shared_read_s" '
            'value="{}"/></properties></testcase>')
    reports = []
    runs = [[("test_a", 130.0, 100.0, 0.0), ("test_b[1]", 5.0, 0.0, 0.0),
             ("test_d", 95.0, 0.0, 90.0)],
            [("test_a", 90.0, 0.0, 0.0), ("test_b[1]", 30.0, 0.0, 0.0)]]
    for k, rows in enumerate(runs):
        path = tmp_path / f"r{k}.xml"
        path.write_text("<testsuites><testsuite>" + "".join(
            case.format(*row) for row in rows) + "</testsuite></testsuites>")
        reports.append(str(path))
    order = [f"tests/test_torch_x.py::{name}"
             for name in ("test_a", "test_b[1]", "test_c", "test_d")]
    table = soak.size_limits(reports, order, (), 3.0, 60.0, 600.0)
    entry = table["files"]["test_torch_x.py"]
    assert entry["setup"] == 300 and entry["setup_measured"] == 100.0
    assert entry["measured"] == {"test_a": 90.0, "test_b[1]": 30.0,
                                 "test_c": 0.0, "test_d": 5.0}
    assert entry["tests"] == {"test_a": 270, "test_b[1]": 90, "test_c": 0,
                              "test_d": 20}
    skipped = tmp_path / "skipped.xml"
    skipped.write_text(
        '<testsuites><testsuite><testcase classname="tests.test_torch_x" '
        'name="test_c" time="0.01"><skipped/></testcase></testsuite>'
        '</testsuites>')
    keep = {"files": {"test_torch_x.py": {"measured": {"test_c": 40.0,
                                                       "test_a": 500.0}}}}
    kept = soak.size_limits(reports + [str(skipped)], order, (), 3.0, 60.0,
                            600.0, keep)["files"]["test_torch_x.py"]
    assert kept["measured"]["test_c"] == 40.0 and kept["tests"]["test_c"] \
        == 120 and kept["tests"]["test_a"] == 270
    assert (table["stall"], table["stall_measured"]) == (60, 0.0)
    still = tmp_path / "still.xml"
    still.write_text(
        '<testsuites><testsuite><testcase classname="tests.test_torch_x" '
        'name="test_a" time="50"><properties><property '
        'name="watchdog_longest_still_s" value="31.5"/></properties>'
        '</testcase></testsuite></testsuites>')
    stalls = soak.size_limits(reports + [str(still)], order, (), 3.0, 60.0,
                              600.0)
    assert (stalls["stall"], stalls["stall_measured"], stalls["stall_test"]) \
        == (100, 31.5, "tests/test_torch_x.py::test_a")
    slow = soak.size_limits(reports, order, (), 3.0, 60.0, 600.0,
                            slow=(str(still),))
    assert (slow["stall"], slow["files"]["test_torch_x.py"]["measured"]) \
        == (100, entry["measured"])
    roomy = soak.size_limits(reports, order, (), 3.0, 60.0, 600.0,
                             room=(700.0, 50.0))["files"]["test_torch_x.py"]
    assert roomy["setup"] == 700 - 270 and roomy["tests"] == entry["tests"]
    rebuilt = soak.size_limits(reports, order, (), 3.0, 60.0, 600.0,
                               old=(reports[0],),
                               rebuilt=("test_torch_x.py",))
    entry = rebuilt["files"]["test_torch_x.py"]
    assert (entry["setup"], entry["setup_measured"]) == (0, 0.0)
    assert entry["measured"]["test_a"] == 90.0
    shares = soak.limit_shares(soak.junit_cases(reports[0]), table)
    assert [(round(x, 3), nid.split("::")[1]) for x, _, _, nid in shares] \
        == [(0.228, "test_a"), (0.056, "test_b[1]"), (0.016, "test_d")]


def test_no_limit_below_factor_times_its_measured_time():
    """Across tests/torch_time_limits.json: every port test's limit, every
    file's setup limit, every limited reference test's limit and the
    stall limit is at least the table's factor times its measured time,
    with factor, floor and default as tools/torch_tier1_soak.py sizes
    them; the watchdog's cap of every test (torch_watchdog.limit_of: its
    limit, plus its file's setup where it builds or reads) and the stall
    limit are at least the floor."""
    import torch_watchdog

    soak = _soak()
    with open(torch_watchdog.LIMITS_PATH) as f:
        table = json.load(f)
    assert (table["factor"], table["floor"], table["default"]) == (
        soak.FACTOR, soak.FLOOR, soak.DEFAULT)
    low = []
    for name, entry in table["files"].items():
        for case, limit in entry["tests"].items():
            if limit < table["factor"] * entry["measured"][case]:
                low.append((name, case, limit, entry["measured"][case]))
            for shared in (False, True):
                item = SimpleNamespace(path=pathlib.Path(name), name=case,
                                       module=SimpleNamespace())
                cap = torch_watchdog.limit_of(item, shared)
                if cap < max(table["floor"], limit + shared * entry["setup"]):
                    low.append((name, case, shared, cap))
        if entry["setup"] < table["factor"] * entry["setup_measured"]:
            low.append((name, "setup", entry["setup"],
                        entry["setup_measured"]))
    for nid, limit in table["reference"].items():
        if limit < table["factor"] * table["reference_measured"][nid]:
            low.append((nid, limit, table["reference_measured"][nid]))
    if table["stall"] < max(table["factor"] * table["stall_measured"],
                            table["floor"]):
        low.append(("stall", table["stall"], table["stall_measured"]))
    assert not low, low


def test_no_setup_and_test_limit_near_the_run_timeout():
    """No file's setup limit plus one of its test limits reaches
    tools/torch_tier1_soak.py's RUN_SHARE of the Tier-1 command's own
    timeout (ROADMAP's Tier-1 verify line), nor does a limited reference
    test's limit: a stall in the heaviest fixture is ended by the
    watchdog and fails alone while the run still has time to end."""
    import torch_watchdog

    soak = _soak()
    cap = soak.RUN_SHARE * soak.command_timeout(
        soak.tier1_command(os.path.join(ROOT, "ROADMAP.md")))
    with open(torch_watchdog.LIMITS_PATH) as f:
        table = json.load(f)
    over = [(name, case, entry["setup"] + limit)
            for name, entry in table["files"].items()
            for case, limit in entry["tests"].items()
            if entry["setup"] + limit >= cap]
    over += [(nid, limit) for nid, limit in table["reference"].items()
             if limit >= cap]
    assert not over, (cap, over)
