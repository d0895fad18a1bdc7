"""The port tests' time limits (tests/torch_watchdog.py): a planted stall
fails alone, with its stack, and the run goes on; the card's command
(chip_smoke.CARD_TEST_ARGS) arms the same limits; every port test file
names the watchdog and every test in it has a limit of at least three
times its measured time."""
import ast
import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest

pytest_plugins = ["torch_watchdog"]

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


def _run_planted(tmp_path, args):
    (tmp_path / "test_torch_planted.py").write_text(PLANTED)
    env = dict(os.environ, PYTHONPATH=TESTS)
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
    (3) times its measured time and at least its floor; the file's
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


def test_sizing_splits_the_shared_setup_from_each_test(tmp_path):
    """tools/torch_tier1_soak.py --size: a test's limit is 3x its own time
    (its time less the shared setup the watchdog recorded), at least the
    floor; its file's setup limit 3x the largest shared setup; the
    largest of two reports counts; a test no report lists takes the
    floor."""
    spec = importlib.util.spec_from_file_location(
        "torch_tier1_soak", os.path.join(ROOT, "tools", "torch_tier1_soak.py"))
    soak = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(soak)
    case = ('<testcase classname="tests.test_torch_x" name="{}" time="{}">'
            '<properties><property name="watchdog_shared_setup_s" '
            'value="{}"/></properties></testcase>')
    reports = []
    runs = [[("test_a", 130.0, 100.0), ("test_b[1]", 5.0, 0.0)],
            [("test_a", 90.0, 0.0), ("test_b[1]", 30.0, 0.0)]]
    for k, rows in enumerate(runs):
        path = tmp_path / f"r{k}.xml"
        path.write_text("<testsuites><testsuite>" + "".join(
            case.format(*row) for row in rows) + "</testsuite></testsuites>")
        reports.append(str(path))
    order = [f"tests/test_torch_x.py::{name}"
             for name in ("test_a", "test_b[1]", "test_c")]
    table = soak.size_limits(reports, order, (), 3.0, 60.0, 600.0)
    entry = table["files"]["test_torch_x.py"]
    assert entry["setup"] == 300 and entry["setup_measured"] == 100.0
    assert entry["measured"] == {"test_a": 90.0, "test_b[1]": 30.0,
                                 "test_c": 0.0}
    assert entry["tests"] == {"test_a": 270, "test_b[1]": 90, "test_c": 60}
