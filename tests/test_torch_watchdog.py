"""The port tests' time limits (tests/torch_watchdog.py): a planted stall
fails alone, with its stack, and the run goes on, under `--dist loadfile`
and under the Tier-1 command's `--dist load`; the card's command
(chip_smoke.CARD_TEST_ARGS) arms the same limits; every port test file
names the watchdog and every test in it has a limit of at least the
table's factor times its measured time. A module fixture built with
torch_watchdog.once_per_run is built once in a run of two workers and
read by the other, whose tests run their own assertions on it; a build
that fails fails every test that reads it."""
import ast
import importlib.util
import json
import os
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

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


def _run_planted(tmp_path, args, source=PLANTED, env=None):
    (tmp_path / "test_torch_planted.py").write_text(source)
    env = dict(os.environ, PYTHONPATH=TESTS, **(env or {}))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-c",
         os.path.join(ROOT, "pytest.ini"), "--rootdir", str(tmp_path),
         *args, "test_torch_planted.py"],
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


def _port_files():
    return sorted(f for f in os.listdir(TESTS)
                  if f.startswith("test_torch_") and f.endswith(".py"))


@pytest.mark.parametrize("name", _port_files())
def test_every_port_test_has_a_limit(name):
    """The file names the watchdog in pytest_plugins, and every test
    function in it has a limit in tests/torch_time_limits.json (each of
    its cases, by the function's name) of at least the table's factor
    times its measured time and at least its floor; the file's
    shared setup limit is the factor times its measured setup."""
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
        assert limit >= max(table["factor"] * entry["measured"][case],
                            table["floor"]), case
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
    read from another worker), at least the floor; its file's setup limit
    3x the largest build; the largest of two reports counts; a test no
    report lists takes the floor, or, with an earlier table to keep, where
    every report skipped it, that table's measured time. limit_shares
    reads each test's share of its limit, the file's setup included where
    its setup built or read."""
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
    assert entry["tests"] == {"test_a": 270, "test_b[1]": 90, "test_c": 60,
                              "test_d": 60}
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
    shares = soak.limit_shares(soak.junit_cases(reports[0]), table)
    assert [(round(x, 3), nid.split("::")[1]) for x, _, _, nid in shares] \
        == [(0.264, "test_d"), (0.228, "test_a"), (0.056, "test_b[1]")]


def test_no_limit_below_factor_times_its_measured_time():
    """Across tests/torch_time_limits.json: every port test's limit, every
    file's setup limit and every limited reference test's limit is at
    least the table's factor times its measured time (and a test's at
    least the floor), with factor, floor and default as
    tools/torch_tier1_soak.py sizes them."""
    import torch_watchdog

    soak = _soak()
    with open(torch_watchdog.LIMITS_PATH) as f:
        table = json.load(f)
    assert (table["factor"], table["floor"], table["default"]) == (
        soak.FACTOR, soak.FLOOR, soak.DEFAULT)
    low = []
    for name, entry in table["files"].items():
        for case, limit in entry["tests"].items():
            if limit < max(table["factor"] * entry["measured"][case],
                           table["floor"]):
                low.append((name, case, limit, entry["measured"][case]))
        if entry["setup"] < table["factor"] * entry["setup_measured"]:
            low.append((name, "setup", entry["setup"],
                        entry["setup_measured"]))
    for nid, limit in table["reference"].items():
        if limit < table["factor"] * table["reference_measured"][nid]:
            low.append((nid, limit, table["reference_measured"][nid]))
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
