"""Run the repo's Tier-1 command several times and report each run; size
the port tests' time limits from such runs.

    python tools/torch_tier1_soak.py [--runs 5] [--concurrent 2]
        [--timeout SECONDS] [--tree DIR] [--out DIR]

The command is the tree's ROADMAP.md "Tier-1 verify" line with
`--dist load` in place of its `--dist loadfile`, as the Tier-1 runs are
made (ROADMAP, the note below that line), run with bash from the root
of a fresh copy of the tree for every run, holding
only what git would commit (tracked and untracked files that
.gitignore does not list; all of a tree outside git, such as a `git
archive` of another commit, but its caches), so every run renders its
fixtures anew as a fresh checkout does. Its fixed log and junit paths
(/tmp/_t1.log, /tmp/_t1.xml) are moved into the run's own folder under
--out, so that copies can run side by side, and `-o
faulthandler_timeout=300` is added to the pytest arguments: pytest's
faulthandler then dumps every thread's stack into the log when a test
the port's watchdog does not watch runs past 300 s. --timeout replaces
the command's own timeout (1,470 s), so that runs made slow on purpose
can reach their end; the watchdog's limits stay the table's. --tree
runs another tree (a parent commit's archive), so that two trees can
run in turns.

--concurrent K starts K copies of the command at once, each in its own
copy, for every run; each copy is reported. One JSON line per copy:
the run and copy index, rc, seconds, DOTS_PASSED and WORKERS_DOWN as
the command prints them, the failed tests named in the junit report,
the tests in which a worker died ("killed": the watchdog's ends and
crashes), the first lines of every stack that was dumped
(faulthandler's "Timeout" dumps: pytest's and the port's watchdog's),
the five slowest tests by the junit report, the largest share of its
cap (the tree's tests/torch_time_limits.json, the file's setup included
where the test's setup built or read a shared fixture; the time it
waited for another worker's build left out) that any port test used,
every port test above 60% of its cap, the ten longest still intervals
(`watchdog_longest_still_s`: the longest time the watchdog saw a test's
stack unchanged), and the run's timeline. The timeline, from the
watchdog's junit properties (start, worker, build and read seconds of
every test): the run's end in seconds since the controller started;
per worker the seconds busy with its own tests, reading (waiting for
and reading another worker's build) and idle (the rest, up to the end:
the start-up, and a worker that ran out of tests before the end); each
shared build's test, worker, start and end; the summed read wait; and
the critical path, walked back from the test that ended last: through
the tests before it on its worker, and from a test that waited for a
build to that build; as segments [worker, from, to, tests, the builds
in it]. A run that waits little on builds has readers with small read
seconds and a critical path that stays on one worker. Each run's
output (_t1.out), junit report (_t1.xml) and timeline.json (the line,
with every test's longest still interval) stay under --out.

    python tools/torch_tier1_soak.py --size XML [XML ...]
        [--keep OLD_TABLE] [--old XML ... [--rebuilt FILE ...]]
        [--slow XML ...] > tests/torch_time_limits.json

writes the port tests' time limits (tests/torch_watchdog.py) from junit
reports of runs under the watchdog (the runs' _t1.xml; a card run's
report, e.g. chip_smoke.py's smoke_out/card_tests.xml). Each test's
time is its setup, call and teardown together; the watchdog's
properties `watchdog_shared_setup_s` (the part of it that built module
fixtures) and `watchdog_shared_read_s` (the part that waited for and
read a fixture another worker built, torch_watchdog.once_per_run) are
left out of its own time: a build sizes the file's setup limit, and a
read waits on a build that has a watchdog of its own. A test's limit is
FACTOR (2) times the most its own time took in any report; a file's
setup limit is the factor times its largest build, or, for a build of
HEAVY_SETUP (60) seconds or more, the room the run-share rule below
leaves beside the file's largest test limit (less ROOM_MARGIN),
whichever is more (a heavy build is slow on a slow host, and the stall
limit, not the cap, ends one that stops); the watchdog's cap of a test,
its limit plus its file's setup limit where its setup builds or reads a
shared fixture, is at least FLOOR (120) seconds; the stall
limit S (`stall`) is the factor times the longest still interval of any
port test in any report (a long XLA compile of the reference is one),
at least the floor. A time in a report then uses
at most half its limit, under the SHARE (60%) a run is held to. No
file's setup limit and test limit together may pass RUN_SHARE (2/3) of
the Tier-1 command's own timeout: a build that runs away while it
moves, begun when the run starts, is then ended by the watchdog with a
third of the run left, and fails alone (one that stalls is ended S
after it stopped). A test that no report ran (a `gpu` case in CPU runs)
takes the measured time of the table --keep names, else 0 (its cap the
floor); a test the table does not list at all, DEFAULT (600). The
reference's
tests that the watchdog also limits (torch_watchdog.REFERENCE_TESTS)
are sized the same way, at least REFERENCE_FLOOR (60) seconds (their
limit is fixed: no re-arming). --old
adds reports of an older tree (a Tier-1 run of the parent commit, its
/tmp/_t1.xml): every test's time there counts,
but not the builds of the files --rebuilt names, whose shared build the
tree changed since (a build measured there is not the tree's). --slow
adds reports of runs made slow on purpose (--concurrent), whose still
intervals count toward S and nothing else: a long compile stands still
longer on a slow host, and S must not end it, where the caps sized from
such runs could not fit under the run-share rule.
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
from typing import NamedTuple

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXTRA = "-o faulthandler_timeout=300"
FACTOR, FLOOR, DEFAULT = 2.0, 120.0, 600.0
REFERENCE_FLOOR = 60.0  # the reference's limited tests: a stall of the
                        # reference fails at 60 s (ROADMAP item 32)
SHARE = 0.6     # the most of its limit a port test may use in a run
RUN_SHARE = 2 / 3   # the most of the command's timeout a setup + test limit
ROOM_MARGIN = 10.0  # seconds a heavy build's cap keeps under that share

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


def adapt(command: str, run_dir: str, timeout: float = None) -> str:
    """The command with its log and junit in run_dir, EXTRA, `--dist
    load`, and `timeout` seconds in place of its own if given."""
    if timeout is not None:
        command = re.sub(r"(\btimeout (?:-k \S+ )?)\d+(?:\.\d+)?",
                         lambda m: f"{m.group(1)}{timeout:g}", command,
                         count=1)
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


class Case(NamedTuple):
    """One test of a junit report: the watchdog's properties (None where
    the report has none)."""
    nid: str
    seconds: float      # setup, call and teardown together
    setup: float        # watchdog_shared_setup_s: built a shared fixture
    failed: bool
    read: float         # watchdog_shared_read_s: waited for another's build
    skipped: bool
    start: float = None     # watchdog_start_s
    worker: int = None      # watchdog_worker
    still: float = None     # watchdog_longest_still_s


def junit_cases(xml_path: str) -> list:
    """Every test of the report, as Case."""
    if not os.path.exists(xml_path):
        return []
    cases = []
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        path = case.get("classname", "").replace(".", "/") + ".py"
        props = {p.get("name"): float(p.get("value"))
                 for p in case.iter("property")
                 if p.get("name", "").startswith("watchdog_")}
        failed = (case.find("failure") is not None
                  or case.find("error") is not None)
        worker = props.get("watchdog_worker")
        cases.append(Case(
            f"{path}::{case.get('name')}", float(case.get("time", 0.0)),
            props.get("watchdog_shared_setup_s", 0.0), failed,
            props.get("watchdog_shared_read_s", 0.0),
            case.find("skipped") is not None,
            props.get("watchdog_start_s"),
            None if worker is None else int(worker),
            props.get("watchdog_longest_still_s")))
    return cases


def limit_shares(cases: list, table: dict) -> list:
    """(share of its limit, seconds, limit, node id) of every port test
    in cases, largest first: its limit is the table's for it, plus its
    file's setup where the test's setup built or read a shared fixture;
    its seconds leave out the time it waited for another worker's build,
    which the watchdog does not count against the cap."""
    out = []
    for c in cases:
        file, name = c.nid.split("::", 1)
        entry = table["files"].get(os.path.basename(file))
        if entry is None:
            continue
        limit = entry["tests"].get(name, table["default"])
        if c.setup > 0 or c.read > 0:
            limit += entry["setup"]
        limit = max(limit, table.get("floor", 0))
        out.append(((c.seconds - c.read) / limit, c.seconds - c.read, limit,
                    c.nid))
    return sorted(out, reverse=True)


def _file(nid: str) -> str:
    return os.path.basename(nid.split("::", 1)[0])


def critical_path(timed: list) -> list:
    """The chain of tests that ends last, walked back from the test that
    ends last: from a test that waited for another worker's build, to
    that build; else to the test before it on its worker. Merged into
    segments [worker, from s, to s, tests, the builds in it]."""
    end = lambda c: c.start + c.seconds
    runs = {}
    for c in sorted(timed, key=lambda c: c.start):
        runs.setdefault(c.worker, []).append(c)
    before = {id(c): (run[i - 1] if i else None)
              for run in runs.values() for i, c in enumerate(run)}
    chain, seen, cur = [], set(), max(timed, key=end)
    while cur is not None and id(cur) not in seen:
        chain.append(cur)
        seen.add(id(cur))
        nxt = None
        if cur.read > 1.0:
            ready = cur.start + cur.read
            builds = [c for c in timed if c.setup > 0 and c is not cur
                      and _file(c.nid) == _file(cur.nid) and c.start < ready]
            nxt = min(builds, key=lambda c: abs(c.start + c.setup - ready),
                      default=None)
        cur = nxt if nxt is not None else before[id(cur)]
    segments = []
    for c in reversed(chain):
        if segments and segments[-1][0] == f"gw{c.worker}":
            seg = segments[-1]
            seg[2] = round(end(c), 1)
            seg[3] += 1
        else:
            seg = [f"gw{c.worker}", round(c.start, 1), round(end(c), 1), 1,
                   []]
            segments.append(seg)
        if c.setup > 0:
            seg[4].append(c.nid)
    return segments


def timeline(cases: list):
    """The run's timeline from the watchdog's properties (None where the
    report has none): its end, in seconds since the controller started;
    per worker the seconds busy (own test time), reading (waiting for and
    reading another worker's build) and idle (the rest, up to the end);
    each shared build's worker, start and end; the summed read wait; the
    critical path."""
    timed = [c for c in cases if c.start is not None and c.worker is not None]
    if not timed:
        return None
    end = max(c.start + c.seconds for c in timed)
    workers = {}
    for c in timed:
        w = workers.setdefault(f"gw{c.worker}", dict(busy=0.0, reading=0.0))
        w["busy"] += c.seconds - c.read
        w["reading"] += c.read
    for w in workers.values():
        w["idle"] = end - w["busy"] - w["reading"]
        for k in w:
            w[k] = round(w[k], 1)
    builds = [[c.nid, f"gw{c.worker}", round(c.start, 1),
               round(c.start + c.setup, 1)]
              for c in sorted(timed, key=lambda c: c.start) if c.setup > 0]
    return dict(end=round(end, 1), read_s=round(sum(c.read for c in timed), 1),
                workers=dict(sorted(workers.items())), builds=builds,
                critical_path=critical_path(timed))


def kills(log: str) -> list:
    """The tests in which the log says a worker died (the watchdog, or a
    crash)."""
    return re.findall(r"crashed while running '([^']+)'", log)


def _key(text: str, name: str):
    m = re.search(rf"{name}=(\d+)$", text, re.M)
    return int(m.group(1)) if m else None


def report(run: int, copy: int, rc: int, seconds: float,
           run_dir: str, table: dict) -> dict:
    """The run's JSON line; its timeline and every test's longest still
    interval go to timeline.json in run_dir as well."""
    with open(os.path.join(run_dir, "_t1.out"), errors="replace") as f:
        out = f.read()
    cases = junit_cases(os.path.join(run_dir, "_t1.xml"))
    slowest = sorted(cases, key=lambda c: -c.seconds)[:5]
    shares = limit_shares(cases, table)
    still = sorted(([c.still, c.nid] for c in cases if c.still is not None),
                   reverse=True)
    line = {"run": run, "copy": copy, "rc": rc,
            "seconds": round(seconds, 1),
            "dots_passed": _key(out, "DOTS_PASSED"),
            "workers_down": _key(out, "WORKERS_DOWN"),
            "failed": [c.nid for c in cases if c.failed],
            "killed": kills(out),
            "dumps": dumps(out),
            "slowest": [[round(c.seconds, 2), c.nid] for c in slowest],
            "largest_limit_share": round(shares[0][0], 3) if shares else None,
            "over_share": [[round(x, 3), round(t, 1), lim, nid]
                           for x, t, lim, nid in shares if x > SHARE],
            "longest_still": still[:10],
            "timeline": timeline(cases),
            "dir": run_dir}
    with open(os.path.join(run_dir, "timeline.json"), "w") as f:
        json.dump(dict(line, longest_still=still), f, indent=1)
    return line


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
                keep: dict = None, old: tuple = (),
                rebuilt: tuple = (), room: tuple = None,
                slow: tuple = ()) -> dict:
    """The time-limit table (tests/torch_watchdog.py) of the port's tests
    (node ids in `order`) and the reference's tests in `reference` from
    the junit reports. keep: an earlier table, whose measured time a test
    takes where no report ran it (every report that lists it skipped it:
    a `gpu` case in CPU runs), and whose measured still interval stands
    where no report has one. old: those of the reports that ran an older
    tree, whose builds of the files in `rebuilt` (files whose shared
    build the tree has changed since) do not count. room: (seconds,
    heavy): a file whose largest build took `heavy` seconds or more gets
    as its setup limit what `seconds` (the most a setup plus test cap may
    take) leaves beside its largest test limit, where that is more than
    the factor times the build. slow: reports of runs made slow on
    purpose (--concurrent), whose still intervals size the stall limit
    and whose times size nothing."""
    own = {nid: 0.0 for nid in (*order, *reference)}
    ran = set()
    shared: dict = {}
    still, still_nid = 0.0, None
    for path in reports:
        for c in junit_cases(path):
            if c.nid not in own:
                continue
            ran.update(() if c.skipped else (c.nid,))
            own[c.nid] = max(own[c.nid], c.seconds - c.setup - c.read)
            file = _file(c.nid)
            if path not in old or file not in rebuilt:
                shared[file] = max(shared.get(file, 0.0), c.setup)
            if c.nid not in reference and (c.still or 0.0) > still:
                still, still_nid = c.still, c.nid
    for c in (c for path in slow for c in junit_cases(path)):
        if c.nid in order and (c.still or 0.0) > still:
            still, still_nid = c.still, c.nid
    if still_nid is None and keep:
        still, still_nid = keep.get("stall_measured", 0.0), keep.get(
            "stall_test")
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
        entry["tests"][name] = _ceil10(factor * own[nid])
        entry["measured"][name] = round(own[nid], 2)
    if room is not None:
        seconds, heavy = room
        for entry in files.values():
            if entry["setup_measured"] >= heavy:
                entry["setup"] = max(entry["setup"], int(
                    seconds - max(entry["tests"].values())) // 10 * 10)
    return {"factor": factor, "floor": floor, "default": default,
            "sources": len(reports), "files": files,
            "stall": limit(still), "stall_measured": round(still, 2),
            "stall_test": still_nid,
            "reference": {nid: max(int(REFERENCE_FLOOR),
                                   _ceil10(factor * own[nid]))
                          for nid in reference},
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
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds in place of the command's own timeout "
                         "(runs made slow on purpose)")
    ap.add_argument("--keep", metavar="TABLE",
                    help="--size: an earlier table whose measured time a "
                         "test no report ran keeps (the gpu cases)")
    ap.add_argument("--old", nargs="+", metavar="XML", default=(),
                    help="--size: further reports, of an older tree (a "
                         "Tier-1 run of the parent commit)")
    ap.add_argument("--slow", nargs="+", metavar="XML", default=(),
                    help="--size: reports of runs made slow on purpose, "
                         "whose still intervals size the stall limit")
    ap.add_argument("--rebuilt", nargs="+", metavar="FILE", default=(),
                    help="--size: test files whose shared build the tree "
                         "changed since the --old reports: their builds "
                         "there do not count")
    ap.add_argument("--out", default=None,
                    help="folder for logs and copies (default: a temp dir)")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    if args.size:
        sys.path.insert(0, os.path.join(tree, "tests"))
        from torch_watchdog import HEAVY_SETUP, REFERENCE_TESTS
        keep = None
        if args.keep:
            with open(args.keep) as f:
                keep = json.load(f)
        cap = RUN_SHARE * command_timeout(
            tier1_command(os.path.join(tree, "ROADMAP.md")))
        table = size_limits([*args.size, *args.old], port_tests(tree),
                            REFERENCE_TESTS, FACTOR, FLOOR, DEFAULT, keep,
                            tuple(args.old), tuple(args.rebuilt),
                            (cap - ROOM_MARGIN, HEAVY_SETUP),
                            tuple(args.slow))
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
                    ["bash", "-c", adapt(command, run_dir, args.timeout)],
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
