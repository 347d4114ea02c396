"""Config-space sweep harness (counterpart of capital_tpu/autotune/tune.py).

Each candidate config is

  1. run once inside tracing.trace(): the warm-up call, which records the
     analytic cost vector as it runs (the JAX package records it while
     tracing under jax.eval_shape; the port has no abstract evaluation,
     and its costs are the same records, candidate for candidate),
  2. timed on fresh inputs (bench.common._perturb), best of num_iter,

and the sweep emits the JAX package's reference-style tables, a JSON
records list and the argmin-by-measured-time candidate.

The cost model scores a candidate with Tracer.model_time at the rates of
tracing.H100 (NVIDIA H100 80GB HBM3, 700 W): the flop rate of the
candidate's precision level and the NVLink rate, which adds nothing on one
device, where every recorded link byte is 0.

Search axes are the JAX package's: bc_mult, split, complete_inv, base
method, base policy, workspace, summa impl and chunking, precision for
cholinv; path, gram policy, gram kernel and formq_chunks for cacqr; nb and
lookahead for LU; base_n and sign_l0 for eigh. The one-device spaces are
the JAX package's own one-device spaces, except that `gram_kernel` sweeps
['dot', 'tri'] on 'gpu' as the JAX package does on 'tpu' (the port's
'auto' sends an f32 Gram to the SYRK kernel there, as the JAX package's
does on a TPU). Grid shapes of more than one device raise
NotImplementedError: the tuner's sweep over world grids waits (ROADMAP
queue M).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Sequence

import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.grid import Grid, default_device
from capital_tpu_torch.ops.precision import default_matmul_precision

_NOT_PORTED = ("the tuner's grid shapes over more than one device and its "
               "multi-device CPU mesh are not ported: the world grids of "
               "M9b and M10 exist, the tuner's sweep over them waits "
               "(ROADMAP queue M)")


@dataclass
class Candidate:
    params: dict
    time_s: float = float("inf")
    costs: dict = field(default_factory=dict)
    model_time_s: float = 0.0
    error: str | None = None

    def record(self):
        return {"params": self.params, "time_s": self.time_s,
                "model_time_s": self.model_time_s, **self.costs,
                **({"error": self.error} if self.error else {})}


def _costs(t: tracing.Tracer, level: str) -> tuple[dict, float]:
    tot = t.totals()
    costs = {"gflop": tot.flops / 1e9, "link_mib": tot.comm_bytes / 2**20,
             "msgs": tot.msgs}
    return costs, t.model_time(flops_per_s=tracing.H100.flops_per_s[level],
                               ici_bytes_per_s=tracing.H100.link_bytes_per_s)


def _trace_costs(fn, args, level: str) -> tuple[dict, float]:
    """(costs, model seconds) of one warm-up call fn(*args), recorded as it
    runs."""
    with tracing.trace() as t:
        out = fn(*args)
    del out
    return _costs(t, level)


def _measure(fn, args, num_iter: int) -> float:
    """Best seconds of num_iter calls, each on fresh inputs and timed with
    the device's queue drained before and after (after the warm-up call
    of _trace_costs)."""
    from capital_tpu_torch.bench.common import _perturb, time_call

    device = next(x.device for x in args if isinstance(x, torch.Tensor))
    best = float("inf")
    for i in range(num_iter):
        fresh = _perturb(args, i)
        secs, out = time_call(lambda: fn(*fresh), device)
        del out, fresh
        best = min(best, secs)
    return best


# What a config that does not fit the shape, grid or card raises: the
# Config and shape checks' ValueError / TypeError / NotImplementedError, and
# a card whose memory cannot hold the candidate. Anything else (a kernel
# that fails to build or launch, a CUDA error) is a fault, not a config
# result, and propagates.
_INVALID_CONFIG = (ValueError, TypeError, NotImplementedError,
                   torch.cuda.OutOfMemoryError)


def _sweep(space: dict, run) -> list[Candidate]:
    """Every point of the product of space's lists: run(params, cand)
    fills the candidate; an _INVALID_CONFIG exception is recorded as its
    error."""
    out = []
    keys = list(space)
    for vals in itertools.product(*(space[k] for k in keys)):
        params = dict(zip(keys, vals))
        cand = Candidate(params=params)
        try:
            run(params, cand)
        except _INVALID_CONFIG as e:
            cand.error = f"{type(e).__name__}: {e}"
        out.append(cand)
    return out


def sweep_cholinv(grid: Grid, a, space: dict | None = None,
                  num_iter: int = 2) -> list[Candidate]:
    """Sweep cholinv configs on a fixed grid and matrix.

    space keys (each a list): cholinv.Config fields (bc_mult, split,
    complete_inv, base_method, base_policy, summa_*), workspace ('block'
    = cholinv.factor, 'cyclic' = cholinv_cyclic.factor) and precision."""
    from capital_tpu_torch.algs import cholinv

    one = grid.num_devices == 1
    space = space or {
        "bc_mult": [0, 1, 2],
        "split": [1],
        "complete_inv": [True],
        "base_method": ["auto"],
        "summa_impl": ["gspmd"] if one else ["shard_map", "ring"],
        "summa_chunks": [1] if one else [1, 2],
        "summa_collect_chunks": [1] if grid.c <= 1 else [1, 2],
        "summa_throttle": [False] if one else [False, True],
        "base_policy": ["replicated"] if one else ["replicated", "layer"],
        "workspace": (["block", "cyclic"] if not one and grid.is_square
                      else ["block"]),
        "precision": ["highest", "high"],
    }

    def run(params, cand):
        level = params.get("precision", "highest")
        cfg = cholinv.Config(**{k: v for k, v in params.items()
                                if k not in ("precision", "workspace")})
        if params.get("workspace", "block") == "cyclic":
            from capital_tpu_torch.algs import cholinv_cyclic

            factor = cholinv_cyclic.factor
        else:
            factor = cholinv.factor
        with default_matmul_precision(level):
            fn = lambda x: factor(grid, x, cfg)  # noqa: E731
            cand.costs, cand.model_time_s = _trace_costs(fn, (a,), level)
            cand.time_s = _measure(fn, (a,), num_iter)

    return _sweep(space, run)


def cacqr_paths(grid: Grid) -> list[str]:
    """Feasible cacqr dispatch paths for a grid."""
    paths = ["1d"]
    if grid.is_square and grid.num_devices > 1:
        paths.append("3d")
    if grid.c == grid.d2 and grid.c > 1:
        paths.append("hybrid")
    return paths


def sweep_cacqr(grid: Grid, a, space: dict | None = None,
                num_iter: int = 2) -> list[Candidate]:
    """Sweep CholeskyQR configs: `path` selects factor_1d / factor_3d /
    factor_hybrid; the other keys are cacqr.Config fields and precision.
    A is left as it was (the sweep never passes overwrite_a)."""
    from capital_tpu_torch.algs import cacqr

    space = space or {
        "path": cacqr_paths(grid),
        "num_iter": [2],
        "gram_policy": ["allreduce", "two_stage", "packed"],
        "gram_kernel": ["dot", "tri"] if grid.platform == "gpu" else ["auto"],
        "formq_chunks": [1, 4],
        "base_method": ["auto"],
        "precision": ["highest", "high"],
    }
    fns = {"1d": cacqr.factor_1d, "3d": cacqr.factor_3d,
           "hybrid": cacqr.factor_hybrid, "auto": cacqr.factor}

    def run(params, cand):
        level = params.get("precision", "highest")
        cfg = cacqr.Config(**{k: v for k, v in params.items()
                              if k not in ("precision", "path")})
        factor = fns[params.get("path", "auto")]
        with default_matmul_precision(level):
            fn = lambda x: factor(grid, x, cfg)  # noqa: E731
            cand.costs, cand.model_time_s = _trace_costs(fn, (a,), level)
            cand.time_s = _measure(fn, (a,), num_iter)

    return _sweep(space, run)


def sweep_lu(grid: Grid, a, space: dict | None = None,
             num_iter: int = 2) -> list[Candidate]:
    """Sweep the LU panel width and Schur-engine knobs; `lookahead` sets
    CAPITAL_LU_LOOKAHEAD for the candidate and restores it after."""
    from capital_tpu_torch.algs import lu

    space = space or {
        "nb": [512, 1024, 2048],
        "summa_impl": (["gspmd"] if grid.num_devices == 1
                       else ["shard_map", "ring"]),
        "precision": ["highest", "high"],
        "lookahead": [False, True],
    }

    def run(params, cand):
        level = params.get("precision", "highest")
        prev_la = os.environ.get("CAPITAL_LU_LOOKAHEAD")
        try:
            cfg = lu.Config(**{k: v for k, v in params.items()
                               if k not in ("precision", "lookahead")})
            if "lookahead" in params:
                os.environ["CAPITAL_LU_LOOKAHEAD"] = \
                    "1" if params["lookahead"] else "0"
            with default_matmul_precision(level):
                fn = lambda x: lu.factor(grid, x, cfg)  # noqa: E731
                cand.costs, cand.model_time_s = _trace_costs(fn, (a,), level)
                cand.time_s = _measure(fn, (a,), num_iter)
        finally:
            if prev_la is None:
                os.environ.pop("CAPITAL_LU_LOOKAHEAD", None)
            else:
                os.environ["CAPITAL_LU_LOOKAHEAD"] = prev_la

    return _sweep(space, run)


def sweep_eigh(grid: Grid, a, space: dict | None = None,
               num_iter: int = 1) -> list[Candidate]:
    """Sweep the divide-and-conquer eigensolver's knobs. The traced call's
    result is held to validate.eig_residual (chunked over columns), the
    `residual` quality column: a candidate that degrades must not win on
    time alone."""
    from capital_tpu_torch import validate
    from capital_tpu_torch.algs import cholinv, eigh, polar

    space = space or {
        "base_n": [1024, 2048] if grid.num_devices == 1 else [256, 512],
        "summa_impl": (["gspmd"] if grid.num_devices == 1
                       else ["shard_map", "gspmd"]),
        "sign_l0": [None, 1e-5],
        "precision": ["highest", "high"],
    }

    def run(params, cand):
        level = params.get("precision", "highest")
        chol = cholinv.Config(summa_impl=params["summa_impl"],
                              base_method="auto")
        cfg = eigh.Config(
            base_n=params["base_n"], sign_l0=params["sign_l0"],
            polar=polar.Config(compute_h=False, chol=chol))
        with default_matmul_precision(level):
            fn = lambda x: eigh.eigh(grid, x, cfg)  # noqa: E731
            with tracing.trace() as t:
                w, v = fn(a)
            cand.costs, cand.model_time_s = _costs(t, level)
            cand.costs["residual"] = float(validate.eig_residual(
                grid, a, w, v, chunks=max(1, a.shape[0] // 2048)))
            del w, v
            cand.time_s = _measure(fn, (a,), num_iter)

    return _sweep(space, run)


def _devices(devices) -> list:
    if devices is not None:
        return list(devices)
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [default_device()]  # raises: no card, no device asked for


def grid_candidates(devices=None):
    """Feasible grid shapes for the device count as (kind, c, d) triples:
    (square, 1, 1) on one device. More devices raise NotImplementedError
    (the JAX package's square and rect sub-grid shapes wait)."""
    p = len(_devices(devices))
    if p > 1:
        raise NotImplementedError(f"grid shapes over {p} devices: "
                                  f"{_NOT_PORTED}")
    return [("square", 1, 1)]


def _operand(alg: str, grid: Grid, n: int, m: int):
    """The sweep's operand, seed 0: SPD for cholinv, a spread spectrum for
    eigh (the honest divide-and-conquer workload), square for LU,
    tall-skinny for cacqr."""
    from capital_tpu_torch import matrix

    if alg == "cholinv":
        return matrix.symmetric(grid, n, 0, align=128).data
    if alg == "eigh":
        return matrix.symmetric(grid, n, 0, diag_shift=0.0, align=128).data
    if alg == "lu":
        return matrix.rand(grid, n, n, 0, row_tile=128 * grid.d1,
                           col_tile=128 * grid.d2).data
    return matrix.tall_skinny(grid, m, n, 0).data


_SWEEPS = {"cholinv": sweep_cholinv, "cacqr": sweep_cacqr, "lu": sweep_lu,
           "eigh": sweep_eigh}


def sweep_grids(alg: str = "cholinv", n: int = 4096, m: int = 1 << 18,
                shapes=None, space: dict | None = None, num_iter: int = 2,
                devices=None) -> list[Candidate]:
    """Outer sweep over grid shapes, inner sweep over the algorithm's
    config space; each candidate's params carry the grid tag and device
    count. A grid of more than one device raises NotImplementedError."""
    devs = _devices(devices)
    shapes = shapes or grid_candidates(devs)
    out: list[Candidate] = []
    for kind, c, d in shapes:
        if kind == "square":
            grid = Grid.square(c=c, d=d, devices=devs[: c * d * d])
        else:
            grid = Grid.rect(c=c, devices=devs)
        if alg in ("eigh", "lu") and kind != "square":
            continue  # their 2d stages want a square slice
        tag = f"{kind}-c{c}x{grid.d1}x{grid.d2}"
        cands = _SWEEPS[alg](grid, _operand(alg, grid, n, m), space,
                             num_iter=num_iter)
        for cand in cands:
            cand.params = {"grid": tag, "devices": grid.num_devices,
                           **cand.params}
        out.extend(cands)
    return out


def best(cands: Sequence[Candidate]) -> Candidate:
    return min(cands, key=lambda c: c.time_s)


def write_tables(cands: Sequence[Candidate], prefix: str,
                 num_devices: int = 1):
    """The JAX package's report files, link bytes in the ICI column's
    place:

      <prefix>_cp_times.txt     config vs measured/model times
      <prefix>_cp_costs.txt     config vs critical-path cost vector
      <prefix>_cross_times.txt  max-per-process + volumetric times
      <prefix>_cross_costs.txt  max-per-process + volumetric cost vectors
      <prefix>.jsonl            machine-readable records

    Every device runs the same program, so the critical-path and
    max-per-process vectors coincide and volumetric = per-device x P.
    Grid-sweep candidates carry their own device count in params."""
    keys = sorted({k for c in cands for k in c.params})

    def head(f, extra):
        f.write("  ".join(f"{k:>12}" for k in keys) + extra + "\n")

    def row(f, c, extra):
        f.write("  ".join(f"{str(c.params.get(k, '-')):>12}" for k in keys)
                + extra + "\n")

    def nd(c):
        return c.params.get("devices", num_devices)

    with open(f"{prefix}_cp_times.txt", "w") as f:
        head(f, f"  {'time_s':>12}  {'model_s':>12}")
        for c in cands:
            row(f, c, f"  {c.time_s:>12.6f}  {c.model_time_s:>12.6f}")
    with open(f"{prefix}_cp_costs.txt", "w") as f:
        head(f, f"  {'GFLOP':>12}  {'link_MiB':>12}  {'msgs':>8}")
        for c in cands:
            row(f, c, f"  {c.costs.get('gflop', 0):>12.3f}"
                      f"  {c.costs.get('link_mib', 0):>12.3f}"
                      f"  {c.costs.get('msgs', 0):>8}")
    with open(f"{prefix}_cross_times.txt", "w") as f:
        head(f, f"  {'pp_time_s':>12}  {'vol_time_s':>12}")
        for c in cands:
            row(f, c, f"  {c.time_s:>12.6f}  {c.time_s * nd(c):>12.6f}")
    with open(f"{prefix}_cross_costs.txt", "w") as f:
        head(f, f"  {'pp_GFLOP':>12}  {'vol_GFLOP':>12}  {'vol_link_MiB':>12}")
        for c in cands:
            g = c.costs.get("gflop", 0)
            mib = c.costs.get("link_mib", 0)
            row(f, c, f"  {g:>12.3f}  {g * nd(c):>12.3f}"
                      f"  {mib * nd(c):>12.3f}")
    with open(f"{prefix}.jsonl", "w") as f:
        for c in cands:
            f.write(json.dumps(c.record()) + "\n")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="autotune cholinv / cacqr / "
                                            "eigh / lu")
    p.add_argument("--alg", default="cholinv",
                   choices=["cholinv", "cacqr", "eigh", "lu"])
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--m", type=int, default=1 << 18)
    p.add_argument("--num-iter", type=int, default=2)
    p.add_argument("--prefix", default=None,
                   help="table files' prefix (default autotune_torch_<alg>)")
    p.add_argument("--grid", default="auto",
                   help="'sweep' = grid-shape sweep over the feasible "
                        "grids; 'square:C:D'; 'rect:C'; 'auto' = sweep when "
                        "more than one device is visible")
    p.add_argument("--cpu", action="store_true",
                   help="sweep on the virtual multi-device CPU mesh (not "
                        "ported: raises)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda = the visible cards (default), cpu = one CPU "
                        "device")
    args = p.parse_args(argv)
    if args.cpu:
        raise NotImplementedError(f"--cpu: {_NOT_PORTED}")

    devs = (_devices(None) if args.device == "cuda"
            else [torch.device("cpu")])
    gspec = args.grid
    if gspec == "auto":
        gspec = "sweep" if len(devs) > 1 else "square:1:1"
    if gspec == "sweep":
        cands = sweep_grids(args.alg, n=args.n, m=args.m,
                            num_iter=args.num_iter, devices=devs)
        nd = 1
    else:
        parts = gspec.split(":")
        if parts[0] == "square":
            c, d = int(parts[1]), int(parts[2])
            if c * d * d > 1:
                raise NotImplementedError(f"--grid {gspec}: {_NOT_PORTED}")
            grid = Grid.square(c=c, d=d, devices=devs[: c * d * d])
        elif parts[0] == "rect":
            if int(parts[1]) > 1:
                raise NotImplementedError(f"--grid {gspec}: {_NOT_PORTED}")
            grid = Grid.rect(c=int(parts[1]), devices=devs)
        else:
            raise SystemExit(f"bad --grid {args.grid!r}")
        a = _operand(args.alg, grid, args.n, args.m)
        cands = _SWEEPS[args.alg](grid, a, num_iter=args.num_iter)
        del a
        nd = grid.num_devices

    prefix = args.prefix or f"autotune_torch_{args.alg}"
    write_tables(cands, prefix, num_devices=nd)
    errors = [c for c in cands if c.error]
    for c in errors:
        print(f"candidate {json.dumps(c.params)}: {c.error}", file=sys.stderr)
    b = best(cands)
    print(json.dumps({"best": b.params, "time_s": b.time_s,
                      "candidates": len(cands), "errors": len(errors)}))
    return cands


if __name__ == "__main__":
    # a candidate error at the defaults is a config this card cannot run:
    # the tables hold it, and the exit code says so
    sys.exit(1 if any(c.error for c in main()) else 0)
