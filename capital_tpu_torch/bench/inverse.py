"""Inverse / TRSM bench driver (counterpart of
capital_tpu/bench/inverse.py): recursive triangular inversion (rectri),
Newton-Schulz inversion (newton) or a triangular solve (trsm), with the
same flags plus --device.

    python -m capital_tpu_torch.bench.inverse --alg newton --n 4096

The operand is matrix.symmetric(n, seed 0) (its lower triangle for
rectri and trsm). GFLOP/s counts n^3/3 (rectri) or n^2 m (trsm, the
textbook substitution); newton's flops depend on its iteration count and
are not reported. Residuals at 'highest': ||L X - B|| / ||B|| (trsm),
||S X - I||_F / sqrt(n) otherwise.
"""

from __future__ import annotations

import torch

from capital_tpu_torch import matrix, tracing
from capital_tpu_torch.algs import newton, rectri, trsm
from capital_tpu_torch.bench.common import (apply_precision, base_parser,
                                            device_of, report, timed_loop)
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.ops.precision import dot as _pdot


def main(argv=None):
    p = base_parser("triangular / Newton-Schulz inversion + TRSM solve")
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--alg", default="rectri",
                   choices=["rectri", "newton", "trsm"])
    p.add_argument("--m", type=int, default=1024,
                   help="RHS columns (trsm only)")
    p.add_argument("--nb", type=int, default=1024,
                   help="substitution panel width (trsm only)")
    p.add_argument("--bc-mult", type=int, default=0)
    p.add_argument("--summa-impl", default="gspmd",
                   choices=["gspmd", "shard_map"])
    args = p.parse_args(argv)
    with apply_precision(args):
        return _run(args)


def _run(args):
    dev = device_of(args)
    grid = Grid.square(c=args.c, d=1, device=dev, layout=args.layout)
    dtype = getattr(torch, args.dtype)
    a = matrix.symmetric(grid, args.n, 0, dtype=dtype, align=128).data
    n = a.shape[0]
    b = None
    if args.alg == "rectri":
        t = torch.tril(a)
        cfg = rectri.Config(bc_mult=args.bc_mult, summa_impl=args.summa_impl)

        def run():
            return rectri.invert(grid, t, lower=True, cfg=cfg)

        flops = n**3 / 3
    elif args.alg == "trsm":
        t = torch.tril(a)
        b = matrix.rand(grid, n, args.m, 1, dtype=dtype).data
        cfg = trsm.Config(nb=args.nb,
                          tri=rectri.Config(bc_mult=args.bc_mult,
                                            summa_impl=args.summa_impl))

        def run():
            return trsm.solve(grid, t, b, side="L", lower=True, cfg=cfg)

        flops = float(n) * n * args.m
    else:
        t = a
        cfg = newton.Config(spd=True, summa_impl=args.summa_impl)

        def run():
            return newton.invert(grid, a, cfg)

        flops = None  # the iteration count depends on the data

    with tracing.trace() as tr:  # the warm-up call records the costs
        run()
    secs, times, out = timed_loop(run, dev, args.num_iter, warmup=0)
    extra = {"n": args.n, "alg": args.alg, "grid": grid.shape,
             "ms": [s * 1e3 for s in times],
             "device": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu")}
    if args.alg == "trsm":
        extra["m"] = args.m
        extra["nb"] = cfg.panel(grid, n)
    if args.alg == "newton":
        out, iters, res = out
        extra["iters"] = iters
        extra["ns_residual"] = float(res)
    if not args.no_validate:
        hp = "highest"
        if args.alg == "trsm":
            err = (torch.linalg.norm((_pdot(t, out, precision=hp)
                                      - b).float())
                   / torch.linalg.norm(b.float()))
            extra["solve_residual"] = float(err)
        else:
            eye = torch.eye(n, dtype=a.dtype, device=a.device)
            err = (torch.linalg.norm((_pdot(t, out, precision=hp)
                                      - eye).float()) / n**0.5)
            extra["inv_residual"] = float(err)
    rec = report(f"inverse_{args.alg}", secs=secs, flops=flops, extra=extra,
                 as_json=args.json)
    if args.costs:
        print(tr.report())
    return rec


if __name__ == "__main__":
    main()
