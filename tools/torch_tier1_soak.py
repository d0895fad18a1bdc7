"""Run the repo's Tier-1 command several times and report each run; size
the port tests' time limits from such runs.

    python tools/torch_tier1_soak.py [--runs 5] [--concurrent 2]
        [--tree DIR] [--out DIR]

The command is the tree's ROADMAP.md "Tier-1 verify" line with
`--dist load` in place of its `--dist loadfile`, as the Tier-1 runs are
made (ROADMAP, the note below that line), run with bash from the root
of a fresh copy of the tree for every run, holding
only what git would commit (tracked and untracked files that
.gitignore does not list), so every run renders its fixtures anew as a
fresh checkout does. Its fixed log and junit paths (/tmp/_t1.log,
/tmp/_t1.xml) are moved into the run's own folder under --out, so that
copies can run side by side, and `-o faulthandler_timeout=300` is added
to the pytest arguments: pytest's faulthandler then dumps every
thread's stack into the log when one test runs past 300 s.

--concurrent K starts K copies of the command at once, each in its own
copy, for every run; each copy is reported. One JSON line per copy:
the run and copy index, rc, seconds, DOTS_PASSED and WORKERS_DOWN as
the command prints them, the failed tests named in the junit report,
the first lines of every stack that was dumped (faulthandler's
"Timeout" dumps: pytest's and the port's watchdog's), the five
slowest tests by the junit report, the largest share of its time
limit (the tree's tests/torch_time_limits.json, the file's setup
included where the test's setup built or read a shared fixture) that
any port test used, and every port test above 60% of its limit. Each run's output (_t1.out) and
junit report (_t1.xml) stay under --out.

    python tools/torch_tier1_soak.py --size XML [XML ...]
        [--keep OLD_TABLE] > tests/torch_time_limits.json

writes the port tests' time limits (tests/torch_watchdog.py) from junit
reports of runs under the watchdog (the runs' _t1.xml; a card run's
report, e.g. chip_smoke.py's smoke_out/card_tests.xml). Each test's
time is its setup, call and teardown together; the watchdog's
properties `watchdog_shared_setup_s` (the part of it that built module
fixtures) and `watchdog_shared_read_s` (the part that waited for and
read a fixture another worker built, torch_watchdog.once_per_run) are
left out of its own time: a build sizes the file's setup limit, and a
read waits at most for a build. A test's limit is FACTOR (2) times the
most its own time took in any report, and at least FLOOR (60)
seconds; a file's setup limit is the factor times its largest build.
A time in a report then uses at most half its limit, under the SHARE
(60%) a run is held to. No file's setup limit and test limit together
may pass RUN_SHARE (2/3) of the Tier-1 command's own timeout: a stall
in a file's heaviest fixture, begun when the run starts, is then ended
by the watchdog with a third of the run left, and fails alone. A
test that no report ran (a `gpu` case in CPU runs) takes the measured
time of the table --keep names, else the floor; a test the table does
not list at all, DEFAULT (600). The reference's
tests that the watchdog also limits (torch_watchdog.REFERENCE_TESTS)
are sized the same way.
"""
import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXTRA = "-o faulthandler_timeout=300"
FACTOR, FLOOR, DEFAULT = 2.0, 60.0, 600.0
SHARE = 0.6     # the most of its limit a port test may use in a run
RUN_SHARE = 2 / 3   # the most of the command's timeout a setup + test limit

_DUMP_START = re.compile(r"Timeout \(\d+:\d\d:\d\d\)!|Fatal Python error")


def tier1_command(roadmap: str) -> str:
    """The command between backticks on ROADMAP's Tier-1 verify line."""
    with open(roadmap) as f:
        for line in f:
            if line.startswith("**Tier-1 verify:**"):
                return line.split("`", 1)[1].rsplit("`", 1)[0]
    raise SystemExit(f"no Tier-1 verify line in {roadmap}")


def command_timeout(command: str) -> float:
    """The seconds the command's `timeout` gives the whole run."""
    found = re.search(r"\btimeout (?:-k \S+ )?(\d+(?:\.\d+)?)\b", command)
    if not found:
        raise SystemExit(f"no timeout in {command!r}")
    return float(found.group(1))


def adapt(command: str, run_dir: str) -> str:
    """The command with its log and junit in run_dir, EXTRA, and
    `--dist load`."""
    return (re.sub(r"--dist \S+", "--dist load", command)
            .replace("/tmp/_t1.log", f"{run_dir}/_t1.log")
            .replace("/tmp/_t1.xml", f"{run_dir}/_t1.xml")
            .replace("python -m pytest tests/",
                     f"python -m pytest tests/ {EXTRA}", 1))


def copy_tree(src: str, dst: str) -> None:
    """Copy what git would commit (or, outside git, e.g. a `git archive`
    of another commit, all but what its test runs cache)."""
    listed = subprocess.run(
        ["git", "-C", src, "ls-files", "-co", "--exclude-standard", "-z"],
        capture_output=True)
    if listed.returncode != 0:
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
            "__pycache__", ".render_cache", "_build"))
        return
    for rel in listed.stdout.decode().split("\0"):
        if not rel or not os.path.isfile(os.path.join(src, rel)):
            continue
        os.makedirs(os.path.join(dst, os.path.dirname(rel)), exist_ok=True)
        shutil.copy2(os.path.join(src, rel), os.path.join(dst, rel))


def dumps(log: str, head: int = 30) -> list:
    """The first `head` lines of every stack dump in the log."""
    lines = log.splitlines()
    return ["\n".join(lines[i:i + head]) for i, line in enumerate(lines)
            if _DUMP_START.search(line)]


def junit_cases(xml_path: str) -> list:
    """(node id, seconds, shared setup seconds built, failed, seconds
    read from another worker, skipped) of every test."""
    if not os.path.exists(xml_path):
        return []
    cases = []
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        path = case.get("classname", "").replace(".", "/") + ".py"
        props = {p.get("name"): float(p.get("value"))
                 for p in case.iter("property")
                 if p.get("name", "").startswith("watchdog_shared_")}
        failed = (case.find("failure") is not None
                  or case.find("error") is not None)
        cases.append((f"{path}::{case.get('name')}",
                      float(case.get("time", 0.0)),
                      props.get("watchdog_shared_setup_s", 0.0), failed,
                      props.get("watchdog_shared_read_s", 0.0),
                      case.find("skipped") is not None))
    return cases


def limit_shares(cases: list, table: dict) -> list:
    """(share of its limit, seconds, limit, node id) of every port test
    in cases, largest first: its limit is the table's for it, plus its
    file's setup where the test's setup built or read a shared
    fixture."""
    out = []
    for nid, seconds, shared, _, read, _ in cases:
        file, name = nid.split("::", 1)
        entry = table["files"].get(os.path.basename(file))
        if entry is None:
            continue
        limit = entry["tests"].get(name, table["default"])
        if shared > 0 or read > 0:
            limit += entry["setup"]
        out.append((seconds / limit, seconds, limit, nid))
    return sorted(out, reverse=True)


def _key(text: str, name: str):
    m = re.search(rf"{name}=(\d+)$", text, re.M)
    return int(m.group(1)) if m else None


def report(run: int, copy: int, rc: int, seconds: float,
           run_dir: str, table: dict) -> dict:
    with open(os.path.join(run_dir, "_t1.out"), errors="replace") as f:
        out = f.read()
    cases = junit_cases(os.path.join(run_dir, "_t1.xml"))
    slowest = sorted(cases, key=lambda c: -c[1])[:5]
    shares = limit_shares(cases, table)
    return {"run": run, "copy": copy, "rc": rc,
            "seconds": round(seconds, 1),
            "dots_passed": _key(out, "DOTS_PASSED"),
            "workers_down": _key(out, "WORKERS_DOWN"),
            "failed": [c[0] for c in cases if c[3]],
            "dumps": dumps(out),
            "slowest": [[round(c[1], 2), c[0]] for c in slowest],
            "largest_limit_share": round(shares[0][0], 3) if shares else None,
            "over_share": [[round(x, 3), round(t, 1), lim, nid]
                           for x, t, lim, nid in shares if x > SHARE],
            "dir": run_dir}


def port_tests(tree: str) -> list:
    """Node ids of the port's tests in collection order."""
    files = sorted(f for f in os.listdir(os.path.join(tree, "tests"))
                   if f.startswith("test_torch_") and f.endswith(".py"))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "-o", "addopts=",
         *[os.path.join("tests", f) for f in files]],
        cwd=tree, capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    ids = [ln.strip() for ln in proc.stdout.splitlines() if "::" in ln]
    if proc.returncode != 0 or not ids:
        raise SystemExit(proc.stdout[-3000:] + proc.stderr[-3000:])
    return ids


def _ceil10(x: float) -> int:
    return int(-(-x // 10) * 10)


def size_limits(reports: list, order: list, reference: tuple,
                factor: float, floor: float, default: float,
                keep: dict = None) -> dict:
    """The time-limit table (tests/torch_watchdog.py) of the port's tests
    (node ids in `order`) and the reference's tests in `reference` from
    the junit reports. keep: an earlier table, whose measured time a test
    takes where no report ran it (every report that lists it skipped it:
    a `gpu` case in CPU runs)."""
    own = {nid: 0.0 for nid in (*order, *reference)}
    ran = set()
    shared: dict = {}
    for path in reports:
        for nid, seconds, shared_s, _, read_s, skipped in junit_cases(path):
            if nid not in own:
                continue
            ran.update(() if skipped else (nid,))
            own[nid] = max(own[nid], seconds - shared_s - read_s)
            file = os.path.basename(nid.split("::", 1)[0])
            shared[file] = max(shared.get(file, 0.0), shared_s)
    limit = lambda t: max(int(floor), _ceil10(factor * t))
    files: dict = {}
    for nid in order:
        file, name = nid.split("::", 1)
        file = os.path.basename(file)
        entry = files.setdefault(file, {
            "setup": _ceil10(factor * shared.get(file, 0.0)),
            "setup_measured": round(shared.get(file, 0.0), 2),
            "tests": {}, "measured": {}})
        if keep and nid not in ran:
            own[nid] = keep["files"].get(file, {}).get(
                "measured", {}).get(name, own[nid])
        entry["tests"][name] = limit(own[nid])
        entry["measured"][name] = round(own[nid], 2)
    return {"factor": factor, "floor": floor, "default": default,
            "sources": len(reports), "files": files,
            "reference": {nid: limit(own[nid]) for nid in reference},
            "reference_measured": {nid: round(own[nid], 2)
                                   for nid in reference}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", nargs="+", metavar="XML",
                    help="write the port tests' time limits from these "
                         "junit reports and exit")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--concurrent", type=int, default=1,
                    help="copies of the command started at once per run")
    ap.add_argument("--tree", default=ROOT, help="the tree to test")
    ap.add_argument("--keep", metavar="TABLE",
                    help="--size: an earlier table whose measured time a "
                         "test no report ran keeps (the gpu cases)")
    ap.add_argument("--out", default=None,
                    help="folder for logs and copies (default: a temp dir)")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    if args.size:
        sys.path.insert(0, os.path.join(tree, "tests"))
        from torch_watchdog import REFERENCE_TESTS
        keep = None
        if args.keep:
            with open(args.keep) as f:
                keep = json.load(f)
        table = size_limits(args.size, port_tests(tree), REFERENCE_TESTS,
                            FACTOR, FLOOR, DEFAULT, keep)
        print(json.dumps(table, indent=1, sort_keys=True))
        return 0
    command = tier1_command(os.path.join(tree, "ROADMAP.md"))
    with open(os.path.join(tree, "tests", "torch_time_limits.json")) as f:
        table = json.load(f)
    out = os.path.abspath(args.out or tempfile.mkdtemp(prefix="tier1_soak_"))
    os.makedirs(out, exist_ok=True)
    worst = 0
    for run in range(args.runs):
        procs = []
        for copy in range(args.concurrent):
            run_dir = os.path.join(out, f"run{run}_copy{copy}")
            shutil.rmtree(run_dir, ignore_errors=True)
            os.makedirs(run_dir)
            cwd = os.path.join(run_dir, "tree")
            copy_tree(tree, cwd)
            tmp = os.path.join(run_dir, "tmp")
            os.makedirs(tmp)
            env = dict(os.environ, TMPDIR=tmp)
            with open(os.path.join(run_dir, "_t1.out"), "wb") as log:
                p = subprocess.Popen(
                    ["bash", "-c", adapt(command, run_dir)],
                    cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True)
            procs.append((copy, run_dir, p, time.monotonic()))
        ended = {}
        while len(ended) < len(procs):
            for copy, _, p, t0 in procs:
                if copy not in ended and p.poll() is not None:
                    ended[copy] = time.monotonic() - t0
            time.sleep(1.0)
        for copy, run_dir, p, _ in procs:
            line = report(run, copy, p.returncode, ended[copy], run_dir,
                          table)
            worst = worst or p.returncode
            print(json.dumps(line), flush=True)
            shutil.rmtree(os.path.join(run_dir, "tree"), ignore_errors=True)
    return 0 if worst == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
