"""Shared driver machinery (counterpart of capital_tpu/bench/common.py):
build Grid -> generate DistMatrix -> warm up -> timed loop -> JSON/text
report, plus the analytic cost table.

On a GPU a call is timed with CUDA events around it, after a
torch.cuda.synchronize(); on the CPU with the host clock.
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


def force(device: torch.device) -> None:
    """Wait for the device to finish the queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    if as_json:
        print(json.dumps(rec))
    else:
        parts = [f"{name}: {secs*1e3:.3f} ms"]
        if flops is not None:
            parts.append(f"{rec['gflops']} GFLOP/s")
        parts += [f"{k}={v}" for k, v in (extra or {}).items()]
        print("  ".join(parts))
    return rec
