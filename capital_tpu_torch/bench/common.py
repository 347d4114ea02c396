"""Shared driver machinery (counterpart of capital_tpu/bench/common.py):
build Grid -> generate DistMatrix -> warm up -> timed loop -> JSON/text
report, plus the analytic cost table.

On a GPU a call is timed with CUDA events around it, after a
torch.cuda.synchronize(); on the CPU with the host clock.

Under torchrun (`torchrun --nproc-per-node=N -m capital_tpu_torch.bench.
cholinv --c ...`) the benches build their grid on the world the
environment describes (`world_grid`), one rank a device, and only rank 0
prints the report.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from capital_tpu_torch.ops import precision


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--c", type=int, default=1,
                   help="depth/replication factor (one device: 1)")
    p.add_argument("--layout", type=int, default=0,
                   help="device-order permutation (one device: 0)")
    p.add_argument("--num-iter", type=int, default=3,
                   help="timed iterations")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--precision", default="highest",
                   choices=["highest", "high", "default"],
                   help="highest=f32 FFMA, high=3 bf16 tensor-core passes, "
                        "default=1 bf16 pass")
    p.add_argument("--no-validate", action="store_true",
                   help="skip residual checks")
    p.add_argument("--costs", action="store_true",
                   help="print the analytic cost table")
    p.add_argument("--json", action="store_true", help="one JSON line only")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler chrome trace into this dir")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on cuda:0 (default) or the CPU")
    return p


def device_of(args) -> torch.device:
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is present")
        return torch.device("cuda", 0)
    return torch.device("cpu")


def world_grid(args, kind: str = "square"):
    """(grid, device) of a bench: on the world torchrun describes (NCCL
    ranks on the cards, gloo ranks with --device cpu), the square grid
    (c, d, d) over every rank or the rect grid of c, at --layout; with no
    world, the one-device grid on device_of(args)."""
    from capital_tpu_torch.grid import Grid
    from capital_tpu_torch.parallel import launch

    if launch.init_from_env(args.device):
        import atexit

        import torch.distributed as dist

        atexit.register(dist.destroy_process_group)
        make = Grid.rect if kind == "rect" else Grid.square
        grid = make(c=args.c, layout=args.layout)
        return grid, grid.device
    dev = device_of(args)
    return Grid.square(c=args.c, d=1, device=dev, layout=args.layout), dev


def is_root() -> bool:
    """False on every rank of a world but rank 0."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def force(device: torch.device) -> None:
    """Wait for the device to finish the queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _perturb(args, i: int):
    """Fresh inputs for timed call i: every floating tensor of the tuple
    scaled by 1 + (i + 1) * 1e-7 (a new tensor; the caller's are kept),
    other entries as they are."""
    from capital_tpu_torch.parallel.darray import DArray

    s = 1.0 + (i + 1) * 1e-7

    def fresh(x):
        if isinstance(x, DArray):
            return x.with_local(fresh(x.local))
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x * s
        return x

    return tuple(fresh(x) for x in args)


def apply_precision(args):
    """Context in which --precision holds (the driver's whole run)."""
    return precision.default_matmul_precision(
        getattr(args, "precision", "highest"))


def time_call(fn, device: torch.device) -> tuple[float, object]:
    """(seconds, result) of one call of fn(), the device's queue drained
    before and after."""
    force(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3, out
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def _across(grid) -> bool:
    return grid.mesh is not None and grid.num_devices > 1


def grid_barrier(grid) -> None:
    """Wait for every rank of the grid (nothing to wait for on one)."""
    if _across(grid):
        import torch.distributed as dist

        from capital_tpu_torch.grid import ALL_AXES

        dist.barrier(group=grid.mesh.group(ALL_AXES))


def slowest(grid, x: float) -> float:
    """The largest x over the grid's ranks (a time: the slowest rank's)."""
    if not _across(grid):
        return x
    from capital_tpu_torch.grid import ALL_AXES
    from capital_tpu_torch.parallel import collectives as coll

    t = torch.tensor([x], dtype=torch.float64, device=grid.device)
    return float(coll.pmax(t, grid.mesh, ALL_AXES)[0])


def timed_loop(fn, device: torch.device, num_iter: int, warmup: int = 1):
    """Warm up + timed loop; returns (min_secs, times, last_out). Each
    iteration's output is freed before the next call."""
    out = None
    for _ in range(warmup):
        del out
        out = fn()
    force(device)
    times = []
    for _ in range(num_iter):
        del out
        secs, out = time_call(fn, device)
        times.append(secs)
    return min(times), times, out


def report(name: str, *, secs: float, flops: float | None = None,
           extra: dict | None = None, as_json: bool = False):
    rec = {"bench": name, "time_s": round(secs, 6)}
    if flops is not None:
        rec["gflops"] = round(flops / secs / 1e9, 2)
    rec.update(extra or {})
    if not is_root():
        return rec
    if as_json:
        print(json.dumps(rec))
    else:
        parts = [f"{name}: {secs*1e3:.3f} ms"]
        if flops is not None:
            parts.append(f"{rec['gflops']} GFLOP/s")
        parts += [f"{k}={v}" for k, v in (extra or {}).items()]
        print("  ".join(parts))
    return rec
