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
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

_WORLD_DEVICE: torch.device | None = None


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
               fn, args, env, threads, timeout_s, results) -> None:
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
        out = fn(*args)
        results.put((rank, True, _to_host(out)))
    except Exception:  # noqa: BLE001 - every failure goes to the parent
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - the result is already delivered
        pass


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
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, init, str(device), backend, fn,
                               args, env, threads, timeout, results))
             for r in range(nprocs)]
    got: dict = {}
    failure = None
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(got) < nprocs and failure is None:
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode}")
                elif time.monotonic() > deadline:
                    failure = f"the world did not finish in {timeout} s"
                continue
            if ok:
                got[rank] = payload
            else:
                failure = f"rank {rank} failed:\n{payload}"
        if failure is None:
            for p in procs:
                p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"launch({getattr(fn, '__name__', fn)}, "
                           f"{nprocs}): {failure}")
    return [got[r] for r in range(nprocs)]
