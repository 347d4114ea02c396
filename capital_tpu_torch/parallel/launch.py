"""Start a world of ranks: one process per device, the PyTorch idiom for
what the JAX package does in one controller over a mesh.

    results = launch(fn, 8, arg, device="cpu")     # 8 gloo ranks
    results = launch(fn, torch.cuda.device_count(), arg)   # NCCL, a card each

`launch` spawns the ranks, initialises the process group (NCCL for CUDA
ranks, gloo for CPU ranks, unless `backend` says otherwise) over a
`file://` rendezvous in a fresh temporary directory (so worlds started at
the same time never meet), runs `fn(*args)` on every rank and returns the
ranks' results in rank order. `fn` must be picklable: a spawned rank
re-imports the module that defines it. Tensors in a result come back as
numpy arrays. A failure on any rank (an exception, or a rank that dies)
stops the others and raises RuntimeError with that rank's traceback.

Under `torchrun` the world is already described by the environment:
`init_from_env()` initialises it there (the benches call it).

An entry point over a device list (the tuner's grid sweep, the scaling
sweep, the multi-device dry run) takes its devices from
`devices_for(device, n)` and runs through `run_on(fn, devices, *args)`:
one rank a device, in the world this process is a rank of, or in one
launched for the call.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from multiprocessing.connection import wait

import torch
import torch.distributed as dist

_WORLD_DEVICE: torch.device | None = None
CPU_RANKS = 8  # CPU ranks by default: the JAX package's 8 virtual devices


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def world_device() -> torch.device:
    """This rank's device: the one its world was started for (`launch`,
    `init_from_env`), else the current CUDA device under NCCL and the CPU
    under any other backend."""
    if _WORLD_DEVICE is not None:
        return _WORLD_DEVICE
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _init(device: torch.device, backend: str | None, **kw) -> None:
    global _WORLD_DEVICE
    if device.type == "cuda":
        if device.index is None:
            rank = kw.get("rank", int(os.environ.get("LOCAL_RANK", 0)))
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend or backend_for(device.type), **kw)
    _WORLD_DEVICE = device


def init_from_env(device="cuda") -> bool:
    """Initialise the world `torchrun` describes (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, LOCAL_RANK in the environment), each rank
    on cuda:LOCAL_RANK, or on the CPU over gloo when device is 'cpu'.
    False, and nothing done, when the environment holds no world."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    _init(dev, None, init_method="env://")
    return True


def _to_host(obj):
    """Tensors -> numpy, recursively through lists, tuples and dicts."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank: int, world: int, init: str, device: str, backend,
               fn, args, env, threads, timeout_s, conn) -> None:
    try:
        for k, v in (env or {}).items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        _init(dev, backend, init_method=init, world_size=world, rank=rank,
              timeout=timedelta(seconds=timeout_s))
        conn.send((True, _to_host(fn(*args))))
    except Exception:  # noqa: BLE001 - every failure goes to the parent
        conn.send((False, traceback.format_exc()))
        return
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - the result is already delivered
        pass


def _collect(conns, procs, timeout: float) -> tuple[dict, str | None]:
    """Every rank's answer, (True, result) or (False, traceback), from its
    end of a pipe (conns[r] for procs[r]), waiting on all the pipes at
    once for up to `timeout` seconds (a rank that dies closes its pipe):
    ({rank: result}, None), or with what went wrong first (a failed rank,
    a rank that died, the ranks still running at the deadline)."""
    got: dict = {}
    waiting = {c: r for r, c in enumerate(conns)}
    deadline = time.monotonic() + timeout
    while waiting:
        ready = wait(list(waiting), max(0.0, deadline - time.monotonic()))
        if not ready:
            return got, (f"the world did not finish in {timeout:g} s; ranks "
                         f"still running: {sorted(waiting.values())}")
        for c in ready:
            r = waiting.pop(c)
            try:
                ok, payload = c.recv()
            except EOFError:  # the rank died before it answered
                procs[r].join(1)
                return got, f"rank {r} exited with code {procs[r].exitcode}"
            if not ok:
                return got, f"rank {r} failed:\n{payload}"
            got[r] = payload
    return got, None


def launch(fn, nprocs: int, *args, device="cuda", backend: str | None = None,
           env: dict | None = None, threads: int | None = None,
           timeout: float = 900.0) -> list:
    """fn(*args) on `nprocs` spawned ranks; their results in rank order.

    device: 'cuda' (rank r on cuda:r mod the card count), 'cuda:0' (every
    rank on that card) or 'cpu'. backend: None picks NCCL for CUDA ranks
    and gloo for CPU ranks. env: variables to set in every rank before fn
    runs (a value of None unsets one). threads: torch.set_num_threads in
    every rank. timeout: seconds for the whole call, also the process
    group's timeout for one collective."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="capital_world_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    pipes = [ctx.Pipe(duplex=False) for _ in range(nprocs)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, init, str(device), backend, fn,
                               args, env, threads, timeout, pipes[r][1]))
             for r in range(nprocs)]
    got, failure = {}, None
    try:
        for p in procs:
            p.start()
        for _, w in pipes:
            w.close()
        got, failure = _collect([r for r, _ in pipes], procs, timeout)
        if failure is None:  # let every rank leave its process group
            end = time.monotonic() + 30
            for p in procs:
                p.join(max(0.0, end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
        for rd, _ in pipes:
            rd.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"launch({getattr(fn, '__name__', fn)}, "
                           f"{nprocs}): {failure}")
    return [got[r] for r in range(nprocs)]


def devices_for(device: str = "cuda", n: int | None = None,
                cpu_ranks: int = CPU_RANKS) -> list:
    """The devices of an entry point over ranks, one rank each. In the
    world this process is a rank of (torchrun's, which this initialises:
    init_from_env), one entry a rank, each rank standing for its own
    device; n, when given, must be the world's size. Else n gloo CPU
    ranks (default cpu_ranks) for 'cpu', or the cards cuda:0 .. n-1
    (default every visible card) for 'cuda', raising RuntimeError when
    fewer are visible: a rank never moves to the CPU unasked."""
    if init_from_env(device):
        world = dist.get_world_size()
        if n not in (None, world):
            raise ValueError(f"{n} devices asked for in a world of {world} "
                             "ranks")
        return [world_device()] * world
    if device == "cpu":
        return [torch.device("cpu")] * (n or cpu_ranks)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n or visible
    if not 0 < n <= visible:
        raise RuntimeError(("no CUDA device: " if not visible else "")
                           + f"{n or 'some'} cards asked for, {visible} "
                           "visible")
    return [torch.device("cuda", i) for i in range(n)]


def world_of(devices) -> tuple[int, str]:
    """(ranks, launch device) of a device list: CPU devices are gloo CPU
    ranks ('cpu'); CUDA devices one NCCL rank a card ('cuda'), each a
    different visible card. Raises ValueError for a mix of kinds, a card
    named twice, and RuntimeError for a card that is not visible: a rank
    never quietly shares a card or moves to the CPU."""
    devs = [torch.device(d) for d in devices]
    kinds = {d.type for d in devs}
    if not devs or len(kinds) != 1:
        raise ValueError(f"one kind of device a world, got {devices}")
    if kinds == {"cpu"}:
        return len(devs), "cpu"
    idx = [d.index if d.index is not None else i for i, d in enumerate(devs)]
    if len(set(idx)) != len(idx):
        raise ValueError(f"a card named twice in {devices}")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if max(idx) >= visible or idx != list(range(len(idx))):
        raise RuntimeError(f"{len(devs)} ranks need cards cuda:0.."
                           f"{len(devs) - 1}, {visible} visible")
    return len(devs), "cuda"


def run_on(fn, devices, *args, timeout: float = 900.0):
    """fn(device, *args) on one rank a device of `devices`; rank 0's
    result. Inside a world it runs here, on every rank, each getting its
    own result, with device None (the grid constructors build on the
    world's ranks); the world must have one rank a device, and each rank
    stands for its own, so `devices` may name one device a rank (under
    NCCL each rank's cuda:LOCAL_RANK). Outside one, a single device runs
    here with no world and device that device (its one-device grids are
    built on it); more run on a world launched for the call (world_of:
    CPU ranks share the host's cores, one thread each at least), with
    device None."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != len(devices):
            raise ValueError(f"{len(devices)} devices asked for in a world "
                             f"of {dist.get_world_size()} ranks")
        return fn(None, *args)
    n, device = world_of(devices)
    if n == 1:
        return fn(torch.device(devices[0]), *args)
    threads = max(1, (os.cpu_count() or 1) // n) if device == "cpu" else None
    return launch(fn, n, None, *args, device=device, threads=threads,
                  timeout=timeout)[0]
