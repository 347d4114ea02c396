"""Where the Tier-1 run's wall clock goes: which worker ran each test file
when, what ran beside the long pole, how many rank processes were alive,
and the CPU the whole command burned.

    # run a command (the Tier-1 line, or that line with tests/test_torch_*.py
    # in place of tests/) and record it in DIR:
    python tests/tier1_timeline.py run DIR -- bash -c '<command>'
    python tests/tier1_timeline.py report DIR [--junit FILE] [--pole tests/test_polar.py]

`run` loads this file into every pytest process of the command as a
plugin (PYTEST_ADDOPTS -p, PYTHONPATH), which writes each test's worker,
start, end, phase durations, the module and session fixtures set up for
it and its process's count of 8-rank worlds started to
DIR/tests/<worker>.jsonl; samples every half second the rank processes
alive and running (children of multiprocessing's spawn and fork server)
into DIR/ranks.jsonl; and writes the command's wall time, exit code and
the user and system CPU seconds of every process it waited for into
DIR/run.json. `report` prints each file's start, end (seconds from the
start), worker, items and busy seconds, the file that ended last, every
call over SLOW_CALL seconds, the long pole's window and the files beside
it; per worker each module's first item, the runs its items came in, the
fixtures they set up and the worlds they started, with the totals; the
peak of rank processes; and from a junit file the summed test time of
the port's files and of the rest.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import resource
import subprocess
import sys
import threading
import time
import xml.etree.ElementTree as ET

_start: dict = {}
_phases: dict = {}
_fixtures: list = []  # module and session fixtures set up for the current item
_relay = [False]  # the xdist controller: it only relays the workers' reports
SLOW_CALL = 60.0  # seconds: `report` lists every call longer


# --------------------------------------------------------------- the plugin

def pytest_configure(config):
    _relay[0] = (not os.environ.get("PYTEST_XDIST_WORKER")
                 and bool(getattr(config.option, "numprocesses", None)))


def pytest_runtest_logstart(nodeid, location):
    _start[nodeid] = time.time()
    _fixtures.clear()


def pytest_fixture_setup(fixturedef, request):
    if fixturedef.scope in ("module", "session"):
        _fixtures.append(fixturedef.argname)


def pytest_runtest_logreport(report):
    ph = _phases.setdefault(report.nodeid, {})
    ph[report.when] = round(report.duration, 3)
    if report.outcome != "passed":
        ph[report.when + "_outcome"] = report.outcome


def pytest_runtest_logfinish(nodeid, location):
    out = os.environ.get("TIER1_TIMELINE_DIR")
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    if not out or _relay[0]:
        return
    os.makedirs(os.path.join(out, "tests"), exist_ok=True)
    row = {"id": nodeid, "w": worker, "s": _start.pop(nodeid, None),
           "e": time.time(), **_phases.pop(nodeid, {})}
    if _fixtures:
        row["fx"] = list(_fixtures)
    ranks = sys.modules.get("torch_mesh_ranks")
    if ranks is not None:
        row["worlds"] = ranks.World.starts
    with open(os.path.join(out, "tests", worker + ".jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")


# ------------------------------------------------------------------ run

def _ranks(stop: threading.Event, path: str) -> None:
    with open(path, "a") as out:
        while not stop.is_set():
            alive = running = 0
            for pid in os.listdir("/proc"):
                if not pid.isdigit():
                    continue
                try:
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        cmd = f.read()
                    if not (b"spawn_main" in cmd
                            or b"multiprocessing.forkserver" in cmd):
                        continue
                    with open(f"/proc/{pid}/stat") as f:
                        state = f.read().rsplit(")", 1)[1].split()[0]
                except OSError:
                    continue
                alive += 1
                running += state == "R"
            out.write(json.dumps({"t": time.time(), "alive": alive,
                                  "running": running}) + "\n")
            out.flush()
            stop.wait(0.5)


def run(out_dir: str, cmd: list) -> int:
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, TIER1_TIMELINE_DIR=os.path.abspath(out_dir))
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, env.get("PYTHONPATH")) if p)
    env["PYTEST_ADDOPTS"] = " ".join(
        p for p in (env.get("PYTEST_ADDOPTS"), "-p tier1_timeline") if p)
    stop = threading.Event()
    sampler = threading.Thread(target=_ranks, daemon=True, args=(
        stop, os.path.join(out_dir, "ranks.jsonl")))
    t0 = time.time()
    sampler.start()
    rc = subprocess.call(cmd, env=env)
    wall = time.time() - t0
    stop.set()
    sampler.join()
    use = resource.getrusage(resource.RUSAGE_CHILDREN)
    rec = {"t0": t0, "wall_s": round(wall, 1), "rc": rc,
           "user_s": round(use.ru_utime, 1), "sys_s": round(use.ru_stime, 1)}
    with open(os.path.join(out_dir, "run.json"), "w") as f:
        json.dump(rec, f)
    print(json.dumps(rec))
    return rc


# --------------------------------------------------------------- report

def _workers(rows: list, t0: float) -> None:
    """Per worker, each module in the order it first ran there: its first
    item's start, items, the runs of consecutive items it came in (each
    run sets its module fixtures up anew), the module and session
    fixtures set up and the 8-rank worlds started during its items; then
    the totals over workers."""
    setups: collections.Counter = collections.Counter()
    worlds = 0
    by_worker = collections.defaultdict(list)
    for r in rows:
        by_worker[r["w"]].append(r)
    for w in sorted(by_worker):
        mods: dict = {}
        prev_mod, seen = None, 0
        for r in sorted(by_worker[w], key=lambda r: r["s"]):
            mod = r["id"].split("::")[0]
            x = mods.setdefault(mod, {"s": r["s"], "first": r["id"], "n": 0,
                                      "runs": 0, "fx": collections.Counter(),
                                      "worlds": 0})
            x["n"] += 1
            x["runs"] += mod != prev_mod
            prev_mod = mod
            x["fx"].update(r.get("fx", []))
            now = r.get("worlds", seen)
            x["worlds"] += now - seen
            seen = now
        worlds += seen
        print(f"{w}: {len(by_worker[w])} items, {seen} worlds started")
        for mod, x in mods.items():
            fx = " ".join(f"{k}x{v}" for k, v in sorted(x["fx"].items()))
            print(f"  {x['s'] - t0:7.1f} {x['n']:4d} items {x['runs']:3d} runs"
                  f" {x['worlds']:2d} worlds  {x['first'].split('::', 1)[1]}"
                  f" ({mod})  {fx}")
            for k, v in x["fx"].items():
                setups[(mod, k)] += v
    print(f"8-rank worlds started: {worlds}")
    print("module and session fixtures set up more than once:")
    for (mod, k), v in sorted(setups.items()):
        if v > 1:
            print(f"  {v:3d} {os.path.basename(mod)}::{k}")


def report(out_dir: str, junit: str | None, pole: str) -> None:
    with open(os.path.join(out_dir, "run.json")) as f:
        t0 = json.load(f)["t0"]
    files: dict = collections.defaultdict(
        lambda: {"s": float("inf"), "e": 0.0, "w": set(), "n": 0, "busy": 0.0})
    rows = []
    tdir = os.path.join(out_dir, "tests")
    for name in sorted(os.listdir(tdir)):
        with open(os.path.join(tdir, name)) as f:
            rows += [json.loads(line) for line in f]
    for r in rows:
        x = files[r["id"].split("::")[0]]
        x["s"], x["e"] = min(x["s"], r["s"]), max(x["e"], r["e"])
        x["w"].add(r["w"])
        x["n"] += 1
        x["busy"] += r["e"] - r["s"]
    print("  start     end worker items   busy file")
    for name, x in sorted(files.items(), key=lambda kv: kv[1]["s"]):
        print(f"{x['s'] - t0:7.1f} {x['e'] - t0:7.1f} {','.join(sorted(x['w'])):6s}"
              f" {x['n']:5d} {x['busy']:6.1f} {name}")
    last = max(files, key=lambda k: files[k]["e"])
    print(f"ends last: {last} at {files[last]['e'] - t0:.1f} s")
    print(f"calls over {SLOW_CALL:g} s:")
    for r in sorted(rows, key=lambda r: -r.get("call", 0)):
        if r.get("call", 0) > SLOW_CALL:
            print(f"  {r['call']:7.1f} {r['w']} {r['id']}")
    if pole in files:
        p = files[pole]
        beside = sorted(os.path.basename(k) for k, x in files.items()
                        if k != pole and x["s"] < p["e"] and x["e"] > p["s"])
        port = [b for b in beside if b.startswith("test_torch_")]
        print(f"{pole}: start {p['s'] - t0:.1f} end {p['e'] - t0:.1f} worker "
              f"{','.join(sorted(p['w']))} items done {p['n']}")
        print(f"beside it ({len(beside)}, {len(port)} of the port's): "
              + " ".join(beside))
    _workers(rows, t0)
    with open(os.path.join(out_dir, "ranks.jsonl")) as f:
        samples = [json.loads(line) for line in f]
    for key in ("alive", "running"):
        m = max(samples, key=lambda r: r[key])
        print(f"peak rank processes {key}: {m[key]} at {m['t'] - t0:.1f} s")
    if junit:
        summed = collections.Counter()
        for case in ET.parse(junit).getroot().iter("testcase"):
            mod = case.get("classname", "").rpartition(".")[2]
            summed["port" if mod.startswith("test_torch_") else "other"] += \
                float(case.get("time", 0))
        print("junit summed test time:", {k: round(v, 1)
                                          for k, v in summed.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    r = sub.add_parser("run")
    r.add_argument("dir")
    r.add_argument("cmd", nargs=argparse.REMAINDER)
    p = sub.add_parser("report")
    p.add_argument("dir")
    p.add_argument("--junit")
    p.add_argument("--pole", default="tests/test_polar.py")
    a = ap.parse_args(argv)
    if a.what == "run":
        cmd = a.cmd[1:] if a.cmd[:1] == ["--"] else a.cmd
        return run(a.dir, cmd)
    report(a.dir, a.junit, a.pole)
    return 0


if __name__ == "__main__":
    sys.exit(main())
