"""Instrumentation: analytic cost model + profiler hooks (counterpart of
capital_tpu/tracing.py, the critter analog).

The recursion runs eagerly in Python, so the same cost vectors the JAX
package records while tracing are recorded here while running: every
summa call records its flops and per-link bytes for the grid it runs on,
and phases are bracketed with the reference's names (CI::factor_diag,
CI::trsm, CI::tmu, CI::inv). A phase is also a
`torch.profiler.record_function` range, and an NVTX range once CUDA is
in use, so the names appear in profiler traces.

Collective cost formulas (bytes a single device moves on its links),
bidirectional ring per grid axis:

  all_gather(bytes_out on axis of size p):  (p-1)/p * bytes_out
  psum (all-reduce):                        2 * (p-1)/p * bytes
  psum_scatter / reduce_scatter:            (p-1)/p * bytes
  ppermute (transpose partner exchange):    bytes (one send + one recv)
"""

from __future__ import annotations

import contextlib
import threading
from collections import defaultdict
from dataclasses import dataclass

import torch


@dataclass
class Costs:
    """Per-phase cost vector (critter's exec/comp/comm rows)."""

    flops: float = 0.0          # flops on one device
    comm_bytes: float = 0.0     # bytes one device moves over its links
    msgs: int = 0               # number of collective launches
    calls: int = 0

    def add(self, flops=0.0, comm_bytes=0.0, msgs=0):
        self.flops += flops
        self.comm_bytes += comm_bytes
        self.msgs += msgs
        self.calls += 1


@dataclass(frozen=True)
class Rates:
    """A card's peak rates for Tracer.model_time: flop/s by precision
    level ('highest' the f32 FFMA route, 'high' three bf16 tensor-core
    passes, 'default' one) and the link's bytes/s in one direction."""

    card: str
    flops_per_s: dict
    link_bytes_per_s: float


# NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power limit, NVIDIA's data
# sheet, dense: 67 TFLOP/s FFMA f32, 989 TFLOP/s bf16 tensor cores,
# NVLink 4 at 450 GB/s a direction. The autotuner's and bench/scaling.py's
# cost model; on one device every recorded link byte is 0.
H100 = Rates(card="NVIDIA H100 80GB HBM3, 700 W",
             flops_per_s={"highest": 67e12, "high": 989e12 / 3,
                          "default": 989e12},
             link_bytes_per_s=450e9)


class Tracer:
    """Accumulates analytic costs per phase.

    Usage:
        with tracing.trace() as t:
            cholinv.factor(grid, a)
        print(t.report())
    """

    def __init__(self):
        self.by_phase: dict[str, Costs] = defaultdict(Costs)
        self._stack: list[str] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        self._stack.append(name)
        try:
            with _ranges(name):
                yield self
        finally:
            self._stack.pop()

    @property
    def current_phase(self) -> str:
        return self._stack[-1] if self._stack else "<top>"

    def record(self, kind: str, flops=0.0, comm_bytes=0.0, msgs=0):
        self.by_phase[f"{self.current_phase}/{kind}"].add(flops, comm_bytes,
                                                         msgs)
        self.by_phase["<total>"].add(flops, comm_bytes, msgs)

    def totals(self) -> Costs:
        return self.by_phase["<total>"]

    def report(self) -> str:
        rows = sorted(k for k in self.by_phase if k != "<total>")
        w = max([len(r) for r in rows] + [12])
        out = [f"{'phase':<{w}}  {'GFLOP':>10}  {'link MiB':>10}  "
               f"{'msgs':>6}  {'calls':>6}"]
        for k in rows + ["<total>"]:
            c = self.by_phase[k]
            out.append(
                f"{k:<{w}}  {c.flops/1e9:>10.3f}  {c.comm_bytes/2**20:>10.3f}"
                f"  {c.msgs:>6d}  {c.calls:>6d}")
        return "\n".join(out)

    def model_time(self, flops_per_s: float, ici_bytes_per_s: float,
                   latency_s: float = 1e-6) -> float:
        """Roofline estimate max(flops / rate, link bytes / link rate) +
        latency * messages: the cost model the autotuner scores a
        candidate with (the JAX package's formula; the rates are the
        caller's, e.g. H100 below)."""
        t = self.totals()
        return max(t.flops / flops_per_s, t.comm_bytes / ici_bytes_per_s) + (
            latency_s * t.msgs)


_tls = threading.local()


def active() -> Tracer | None:
    return getattr(_tls, "tracer", None)


@contextlib.contextmanager
def trace():
    prev = active()
    t = Tracer()
    _tls.tracer = t
    try:
        yield t
    finally:
        _tls.tracer = prev


@contextlib.contextmanager
def _ranges(name: str):
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def phase(name: str):
    """Phase bracket; only a profiler range when no tracer is active."""
    t = active()
    if t is None:
        with _ranges(name):
            yield None
    else:
        with t.phase(name):
            yield t


def record(kind: str, *, flops=0.0, comm_bytes=0.0, msgs=0):
    t = active()
    if t is not None:
        t.record(kind, flops=flops, comm_bytes=comm_bytes, msgs=msgs)


def all_gather_bytes(shard_bytes: float, p: int) -> float:
    return shard_bytes * (p - 1)


def psum_bytes(full_bytes: float, p: int) -> float:
    return 2.0 * full_bytes * (p - 1) / p


def reduce_scatter_bytes(full_bytes: float, p: int) -> float:
    return full_bytes * (p - 1) / p


def ppermute_bytes(shard_bytes: float) -> float:
    return 2.0 * shard_bytes  # one send + one recv


_DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy_ms(events) -> float:
    """Time in ms during which the device ran a kernel, copy or fill: the
    union of those chrome-trace events' intervals. Phase ranges on the
    device's timeline (`gpu_user_annotation`) are not work and are left
    out; key_averages() counts them as device time beside the kernels."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in _DEVICE_WORK and e.get("ph") == "X")
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3


@contextlib.contextmanager
def profile(logdir: str):
    """Capture a torch.profiler trace (CPU + CUDA) into logdir as a chrome
    trace (trace.json; phase names above appear as ranges inside it) and
    the time per operation and kernel, sorted by device time
    (ops.txt), headed by the window's wall time and the device's busy
    time in it (device_busy_ms; the rest is the idle share)."""
    import json
    import os
    import time

    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield prof
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        busy_ms = device_busy_ms(json.load(f)["traceEvents"])
    ops = prof.key_averages()
    head = (f"profiled window: wall {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    print(head, flush=True)
    with open(os.path.join(logdir, "ops.txt"), "w") as f:
        f.write(head + "\n")
        f.write(ops.table(sort_by="self_cuda_time_total", row_limit=40))
