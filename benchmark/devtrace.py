"""Read a torch.profiler chrome trace of the traced calls: the device's
busy time (the union of kernel, copy and fill intervals, a frozen copy of
the arithmetic of capital_tpu_torch.tracing.device_busy_ms), device time
by operation name, and the device's idle gaps by what the host was doing.

The traced window runs from the start of the first traced call to the
end of the last one's synchronise: the benchmark's own `bench::call`
ranges bound it.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
CALL = "bench::call"
BETWEEN = "bench::between_calls"
_SCAN = 400  # host events looked back through for the innermost one


def spans(events) -> list:
    """Sorted (start, end) of the device's work, in microseconds."""
    return sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                  if e.get("cat") in DEVICE_WORK and e.get("ph") == "X")


def union(intervals, lo: float, hi: float) -> list:
    """The busy intervals: the union of `intervals` inside [lo, hi]."""
    out = []
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def gaps(busy, lo: float, hi: float) -> list:
    """The idle intervals of [lo, hi] between the busy ones."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def _short(name: str) -> str:
    """An operation's name without its argument list and return type:
    `void (anonymous namespace)::trmm_wgmma_kernel<2, 1>(CUtensorMap, ...)`
    becomes `(anonymous namespace)::trmm_wgmma_kernel<2, 1>`."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if i > 0:
                    name = name[:i].rstrip()
                break
    if name.startswith("void "):
        name = name[5:]
    return name[:160]


class _Host:
    """The host's ranges of one category, for the innermost one that
    holds an instant."""

    def __init__(self, events):
        self.ev = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                         for e in events)
        self.starts = [e[0] for e in self.ev]

    def at(self, t: float) -> str | None:
        i = bisect.bisect_right(self.starts, t)
        for j in range(i - 1, max(-1, i - 1 - _SCAN), -1):
            a, b, name = self.ev[j]
            if a <= t < b:
                return name
        return None


def summarize(events) -> dict | None:
    """What the traced calls show: the window, the device's busy time in
    it, device seconds in it by operation name (a kernel the device's
    clock puts across the window's edge counts for its part inside, as
    in the busy time), and idle seconds by what the
    host was doing: each idle gap, cut where a traced call starts or
    ends, is named by the host's innermost phase and operation at the
    start of each piece (`bench::between_calls` outside the calls). None
    when the trace holds no traced call."""
    calls = [e for e in events if e.get("ph") == "X"  # the host's ranges
             and e.get("cat") == "user_annotation" and e.get("name") == CALL]
    if not calls:
        return None
    lo = min(e["ts"] for e in calls)
    hi = max(e["ts"] + e.get("dur", 0) for e in calls)
    tid = calls[0].get("tid")
    dev = spans(events)
    busy = union(dev, lo, hi)
    by_name = defaultdict(float)  # the part inside, as the union clips it
    for e in events:
        if e.get("cat") in DEVICE_WORK and e.get("ph") == "X":
            inside = min(e["ts"] + e.get("dur", 0), hi) - max(e["ts"], lo)
            if inside > 0:
                by_name[_short(e["name"])] += inside / 1e6
    host = [e for e in events if e.get("ph") == "X" and e.get("tid") == tid]
    phases = _Host([e for e in host if e.get("cat") == "user_annotation"
                    and e["name"] != CALL])
    ops = _Host([e for e in host if e.get("cat") == "cpu_op"])
    in_call = _Host([e for e in host if e.get("name") == CALL])
    cuts = sorted({t for e in calls for t in (e["ts"], e["ts"] + e["dur"])})
    idle = defaultdict(float)
    for a, b in gaps(busy, lo, hi):
        inner = cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]
        for x, y in zip([a, *inner], [*inner, b]):
            if in_call.at(x) is None:
                label = BETWEEN
            else:
                label = " / ".join(p for p in (phases.at(x), ops.at(x)) if p)
                label = label or CALL
            idle[label] += (y - x) / 1e6
    return {"window_s": (hi - lo) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "device_s": dict(by_name), "idle_s": dict(idle)}


def top(d: dict, k: int = 10) -> list:
    return [[name, s] for name, s in
            sorted(d.items(), key=lambda kv: -kv[1])[:k]]


def read_profile(prof) -> dict | None:
    """summarize() of a finished torch.profiler.profile, through a chrome
    trace written to and removed from the temporary directory."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events)
