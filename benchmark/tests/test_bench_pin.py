"""Two benchmark processes on one machine never pin to the same core: a
process passes over a core that another holds."""

import os
import socket
import subprocess
import sys

from benchmark import harness, spec

PIN = ("import os, sys; from benchmark import harness; c = harness.pin(0); "
       "print(c, sorted(os.sched_getaffinity(0)), flush=True); "
       "sys.stdin.read()")


def _start():
    p = subprocess.Popen([sys.executable, "-c", PIN], cwd=spec.ROOT,
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         text=True)
    core, allowed = p.stdout.readline().split(" ", 1)
    return p, core, allowed.strip()


def _stop(p):
    p.communicate("", timeout=60)
    assert p.returncode == 0


def test_a_core_another_process_holds_is_passed_over():
    first = sorted(os.sched_getaffinity(0), reverse=True)[0]
    held = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        held.bind(harness.CORE_LOCK.format(first))
    except OSError:
        pass  # another process holds it already: held all the same
    try:
        p, core, allowed = _start()
        _stop(p)
    finally:
        held.close()
    assert core != str(first)
    if core != "None":
        assert allowed == f"[{core}]"


def test_two_processes_pin_to_different_cores():
    a, core_a, allowed_a = _start()
    try:
        b, core_b, allowed_b = _start()
        _stop(b)
    finally:
        _stop(a)
    if "None" not in (core_a, core_b):
        assert core_a != core_b
        assert (allowed_a, allowed_b) == (f"[{core_a}]", f"[{core_b}]")
