"""Cholesky + inverse bench driver (counterpart of
capital_tpu/bench/cholinv.py), with the same flags plus --device.

    python -m capital_tpu_torch.bench.cholinv --n 32768 --precision high

GFLOP/s counts the useful flops (2n^3/3: n^3/3 Cholesky + n^3/3 full
triangular inverse) over the best timed call. The report names the
device it ran on.
"""

from __future__ import annotations

import contextlib

import torch

from capital_tpu_torch import matrix, tracing, validate
from capital_tpu_torch.algs import cholinv
from capital_tpu_torch.bench.common import (apply_precision, base_parser,
                                            device_of, report, timed_loop)
from capital_tpu_torch.grid import Grid


def main(argv=None):
    p = base_parser("recursive Cholesky + triangular inverse")
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--complete-inv", type=int, default=1)
    p.add_argument("--split", type=int, default=1)
    p.add_argument("--bc-mult", type=int, default=0,
                   help="base-case size multiplier")
    p.add_argument("--base-method", default="auto",
                   choices=["auto", "xla", "pallas"],
                   help="leaf: pallas = the hand-written fused kernel, "
                        "xla = torch.linalg")
    p.add_argument("--summa-impl", default="gspmd",
                   choices=["gspmd", "shard_map", "ring"])
    p.add_argument("--summa-chunks", type=int, default=1)
    p.add_argument("--summa-throttle", action="store_true")
    p.add_argument("--base-policy", default="replicated",
                   choices=["replicated", "layer", "gather"])
    p.add_argument("--remat", action="store_true")
    p.add_argument("--donate", action="store_true")
    args = p.parse_args(argv)
    # the JAX driver's distributed-schedule flags: on one device a value
    # other than the default would change nothing, so it is refused
    idle = [flag for flag, on in (
        ("--layout", args.layout != 0),
        ("--summa-impl", args.summa_impl != "gspmd"),
        ("--summa-chunks", args.summa_chunks != 1),
        ("--summa-throttle", args.summa_throttle),
        ("--base-policy", args.base_policy != "replicated"),
        ("--remat", args.remat),
        ("--donate", args.donate)) if on]
    if idle:
        p.error(f"{', '.join(idle)}: no effect on one device (factor "
                "always copies A into its workspace); multi-device "
                "schedules are ROADMAP queue M")
    with apply_precision(args):
        return _run(args)


def _run(args):
    dev = device_of(args)
    grid = Grid.square(c=args.c, d=1, device=dev)
    dtype = getattr(torch, args.dtype)
    a = matrix.symmetric(grid, args.n, 0, dtype=dtype, align=128)

    cfg = cholinv.Config(
        split=args.split, bc_mult=args.bc_mult,
        complete_inv=bool(args.complete_inv),
        base_method=args.base_method, summa_impl=args.summa_impl,
    )

    def run():
        return cholinv.factor(grid, a, cfg)

    prof = (tracing.profile(args.profile_dir) if args.profile_dir
            else contextlib.nullcontext())
    with tracing.trace() as t:  # the warm-up call records the costs
        run()
    with prof:
        secs, _, (r, rinv) = timed_loop(run, dev, args.num_iter, warmup=0)
    n = args.n
    flops = 2 * n**3 / 3
    extra = {"n": n, "grid": grid.shape, "bc": cfg.base_dim(grid, n),
             "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu")}
    if not args.no_validate:
        ch = 8 if n >= 16384 else 1
        extra["inv_residual"] = float(validate.inverse_residual(
            grid, r, rinv, chunks=ch, masked=True))
        del rinv
        extra["residual"] = float(validate.cholesky_residual(
            grid, a.data, r, chunks=ch, masked=True))
    rec = report("cholinv", secs=secs, flops=flops, extra=extra,
                 as_json=args.json)
    if args.costs:
        print(t.report())
    return rec


if __name__ == "__main__":
    main()
