"""SUMMA gemm bench driver (counterpart of
capital_tpu/bench/summa_gemm.py).

    python -m capital_tpu_torch.bench.summa_gemm [--m 8192 --k 8192
        --n 8192] [--impl shard_map|ring|gspmd] [--precision ...] [--costs]
    torchrun --nproc-per-node=8 -m capital_tpu_torch.bench.summa_gemm --c 2

A = matrix.rand(m, k, seed 0), B = matrix.rand(k, n, seed 1); C =
summa.gemm(A, B) (on one device one plain product, precision.dot at
--precision; under torchrun the engine on the square (c, d, d) grid over
every rank, with --num-chunks, --collect-chunks and --throttle). The
warm-up call records the analytic costs; each timed call runs on fresh
inputs (bench.common._perturb). Unless --no-validate,
the first 256 rows of C are held to a product of the last call's inputs
at 'highest' (tile_rel_err: max abs error over max abs entry).
"""

from __future__ import annotations

import torch

from capital_tpu_torch import matrix, tracing
from capital_tpu_torch.bench.common import (
    _perturb, apply_precision, base_parser, report, time_call, world_grid)
from capital_tpu_torch.ops.precision import dot as _pdot
from capital_tpu_torch.parallel import darray, summa


def main(argv=None):
    p = base_parser("2.5D SUMMA gemm")
    p.add_argument("--m", type=int, default=8192)
    p.add_argument("--k", type=int, default=8192)
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--impl", default="shard_map",
                   choices=["shard_map", "ring", "gspmd"])
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--collect-chunks", type=int, default=1)
    p.add_argument("--throttle", action="store_true")
    args = p.parse_args(argv)
    with apply_precision(args):
        return _run(args)


def _run(args):
    grid, dev = world_grid(args)
    dtype = getattr(torch, args.dtype)
    a = matrix.rand(grid, args.m, args.k, 0, dtype=dtype).data
    b = matrix.rand(grid, args.k, args.n, 1, dtype=dtype).data

    def fn(x, y):
        return summa.gemm(grid, x, y, impl=args.impl,
                          num_chunks=args.num_chunks,
                          collect_chunks=args.collect_chunks,
                          throttle=args.throttle)

    with tracing.trace() as t:  # the warm-up call records the costs
        fn(a, b)
    times = []
    for i in range(args.num_iter):
        a_last, b_last = _perturb((a, b), i)
        secs, out = time_call(lambda: fn(a_last, b_last), dev)
        times.append(secs)
        if i + 1 < args.num_iter:
            del out

    m, k = a.shape
    n = b.shape[1]
    extra = {"grid": grid.shape, "impl": args.impl, "device": dev.type}
    if not args.no_validate:
        # one 256-row tile against a product at 'highest', else the
        # reference product's own passes dominate the error
        a_last, b_last = darray.to_global(a_last), darray.to_global(b_last)
        ref = _pdot(a_last[:256], b_last, preferred_element_type=torch.float32,
                    precision="highest")
        out = darray.to_global(out)
        extra["tile_rel_err"] = float(
            torch.max(torch.abs(out[:256].float() - ref))
            / torch.max(torch.abs(ref)))
    rec = report("summa_gemm", secs=min(times), flops=2.0 * m * n * k,
                 extra=extra, as_json=args.json)
    if args.costs:
        print(t.report())
    return rec


if __name__ == "__main__":
    main()
