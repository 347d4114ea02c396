"""One run of a cell on this rank: set-up, the measured window, the
traced calls, and the check of the sampled answer against the plain
reference once the window has closed.

The window is a closed loop of one caller: calls go back to back over
the operand pool, each ending in a synchronise, from the window's start
until a call ends past `seconds`. Each call's host times are kept: its
start, its return (before the synchronise: the dispatch span) and its
end. With `trace`, torch.profiler records a steady run of calls from 40 %
of the window on (at least PROFILE_CALLS and PROFILE_S seconds, at most
PROFILE_MAX calls), with the program's launch counters and its computed
link bytes over the same calls.

In a world of ranks every rank runs this, rank 0 decides for all when
the window and the traced calls start and stop (a gloo broadcast on the
host after each call), and the reference's sums go over gloo too.
"""

from __future__ import annotations

import contextlib
import os
import socket
import sys
import time
from dataclasses import asdict, dataclass, field

import torch

from benchmark import devtrace, spec, traffic
from benchmark.reference import plain

PROFILE_AT = 0.4
PROFILE_CALLS = 3
PROFILE_S = 1.0
PROFILE_MAX = 40
FORBIDDEN = ("jax", "jaxlib", "flax", "capital_tpu")
CORE_LOCK = "\0capital-benchmark-core-{}"  # an abstract socket a core
_HELD: list = []


def forbidden_modules() -> list:
    """Modules loaded in this process whose whole top-level name is JAX's,
    its libraries' or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class RankResult:
    """What one rank reports, in plain types (it crosses a pipe)."""

    rank: int
    device_name: str
    t_window0: float
    calls: list = field(default_factory=list)
    window_s: float = 0.0
    peak_window: int = 0
    peak_run: int = 0
    numbers: dict = field(default_factory=dict)
    sample: int = -1
    profiled: int = 0
    launches: int | None = None
    link_bytes: float | None = None
    trace: dict | None = None
    check_s: float = 0.0
    found: list = field(default_factory=list)


class OneRank(plain.OneDevice):
    """The decisions and sums of a run on one device."""

    rank = 0

    def decide(self, code: list) -> list:
        return code

    def barrier(self) -> None:
        pass


class WorldComm:
    """Rank 0's decisions and the reference's sums over a gloo group on
    the host, apart from the program's own groups and the cards."""

    def __init__(self):
        import torch.distributed as dist

        self.dist = dist
        self.rank = dist.get_rank()
        self.group = dist.new_group(backend="gloo")

    def decide(self, code: list) -> list:
        t = torch.tensor(code, dtype=torch.int64)
        self.dist.broadcast(t, src=0, group=self.group)
        return t.tolist()

    def barrier(self) -> None:
        self.dist.barrier(group=self.group)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        c = t.detach().to("cpu", torch.float64).clone()
        self.dist.all_reduce(c, op=op, group=self.group)
        return c.to(t.device, t.dtype)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, self.dist.ReduceOp.SUM)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, self.dist.ReduceOp.MAX)


def pin(rank: int = 0) -> int | None:
    """Keep this thread, and the threads it starts, on one core that no
    other benchmark process on this machine holds, with one intra-op
    thread: the host's share of a call then moves less from run to run.

    Rank r tries the cores it was allowed from the r-th from the end on.
    A process holds a core by binding an abstract Unix socket named after
    it, which lasts as long as the process and writes nothing to disk.
    Where another process holds every allowed core, this one keeps them
    all and says so. Returns the core, or None."""
    for lock in _HELD:
        lock.close()
    _HELD.clear()
    torch.set_num_threads(1)
    cores = sorted(os.sched_getaffinity(0), reverse=True)
    k = rank % len(cores)
    for core in cores[k:] + cores[:k]:
        lock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            lock.bind(CORE_LOCK.format(core))
        except OSError:
            lock.close()
            continue
        _HELD.append(lock)
        os.sched_setaffinity(0, {core})
        return core
    print(f"cores {sorted(cores)} are all held by other benchmark "
          "processes: this one is not pinned", file=sys.stderr)
    return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> int:
    """Kernel launches and fallbacks so far (the program's counters)."""
    from capital_tpu_torch import ops

    return sum(v for v in ops.counters().values() if isinstance(v, int))


class _Traced:
    """The profiler, the launch counters and the cost tracer over the
    traced calls. The profiler starts a call before them (`arm` after
    it): the first call under a freshly started profiler can lose its
    kernels' events."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.stack = contextlib.ExitStack()
        self.prof = self.stack.enter_context(
            torch.profiler.profile(activities=acts))
        self.armed = False

    def arm(self) -> None:
        from capital_tpu_torch import tracing

        self.tracer = self.stack.enter_context(tracing.trace())
        self.launches0 = _launches()
        self.armed = True

    def close(self) -> tuple:
        launches = _launches() - self.launches0
        link = self.tracer.totals().comm_bytes
        self.stack.close()
        return launches, link


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, comm=None) -> dict:
    """One run of `cell` on this rank (its block of every operand): the
    RankResult as a dict."""
    comm = comm or OneRank()
    ranks = cell.chips if not isinstance(comm, OneRank) else 1
    dims = traffic.shape(cell.config, cell.traffic)
    pool = traffic.operands(cell.config, cell.traffic, seed, device,
                            comm.rank, ranks)
    entry = spec.entry_module(cell.entry).Entry(cell.config, dims, device,
                                                world=ranks > 1)
    xs = [entry.operand(a) for a in pool]
    out = entry(xs[0])  # the warm-up: kernels built, shapes seen
    _sync(device)
    del out
    cuda = device.type == "cuda"
    if trace:  # the profiler's own start-up (CUPTI) before the window
        _Traced(device).stack.close()
    res = RankResult(rank=comm.rank, t_window0=0.0,
                     device_name=(torch.cuda.get_device_name(device)
                                  if cuda else "cpu"))
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    sample = traffic.sample_index(cell.traffic, seed)
    held = held_i = traced = finished = None
    prof_t0 = 0.0
    comm.barrier()
    res.t_window0 = time.time()
    t0 = time.perf_counter()
    i = 0
    while True:
        x = xs[i % len(xs)]
        profiled = traced is not None and traced.armed
        with (torch.profiler.record_function(devtrace.CALL) if profiled
              else contextlib.nullcontext()):
            ts = time.perf_counter()
            out = entry(x)
            tr = time.perf_counter()
            _sync(device)
            te = time.perf_counter()
        res.calls.append((ts - t0, tr - t0, te - t0, profiled))
        res.profiled += profiled
        if i == sample:
            held, held_i = out, i
        i += 1
        now = te - t0
        go = now < seconds
        start = (trace and go and traced is None and finished is None
                 and now >= PROFILE_AT * seconds)
        stop = traced is not None and traced.armed and (
            not go or res.profiled >= PROFILE_MAX
            or (res.profiled >= PROFILE_CALLS and now - prof_t0 >= PROFILE_S))
        go, start, stop = (bool(v) for v in comm.decide([go, start, stop]))
        if stop:
            res.launches, res.link_bytes = traced.close()
            finished, traced = traced, None
        elif traced is not None and not traced.armed and go:
            traced.arm()
            prof_t0 = now
        if not go:
            break
        out = None
        if start:
            traced = _Traced(device)
    if traced is not None:  # the window closed before a traced call
        traced.stack.close()
    res.window_s = res.calls[-1][2]
    if held is None:
        held, held_i = out, i - 1
    del out
    if cuda:
        res.peak_window = torch.cuda.max_memory_allocated(device)
        res.peak_run = max(peak_setup, res.peak_window)
    if finished is not None:
        res.trace = devtrace.read_profile(finished.prof)
    res.sample = held_i
    a = pool[held_i % len(pool)]
    outputs = entry.outputs(held)
    del entry, xs, held, x
    pool.clear()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    res.numbers = spec.reference_module(cell.entry).check(
        a, outputs, cell.config, comm)
    res.check_s = time.perf_counter() - t_check
    res.found = forbidden_modules()
    return asdict(res)


def rank_main(cell: spec.Cell, seed: int, seconds: float,
              trace: bool) -> dict:
    """run() on a rank of the world parallel/launch.py started: this
    rank's device, its block of each operand."""
    from capital_tpu_torch.parallel import launch

    comm = WorldComm()
    pin(comm.rank)
    return run(cell, seed, seconds, trace, launch.world_device(), comm)


@dataclass
class Readings:
    """What the metrics' readers read: the cell, the set-up time and
    every rank's RankResult (rank 0 first)."""

    cell: spec.Cell
    setup_s: float
    ranks: list

    @property
    def rank0(self) -> dict:
        return self.ranks[0]

    @property
    def calls(self) -> list:
        """Rank 0's calls: (start, return, end, traced) in seconds from
        the window's start."""
        return self.rank0["calls"]

    @property
    def flops_per_call(self) -> float:
        from benchmark import flops

        return flops.per_call(self.cell.config,
                              traffic.shape(self.cell.config,
                                            self.cell.traffic))
