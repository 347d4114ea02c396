"""Grid-shape scaling sweep (counterpart of capital_tpu/bench/scaling.py),
on one device.

    python -m capital_tpu_torch.bench.scaling --alg cholinv|cacqr|summa|polar
        [--n 1024] [--m 65536] [--weak] [--device cuda|cpu]

One line a (grid shape, algorithm): the measured wall time of one call
(after a warm-up call that records the analytic costs), the cost model's
time at the H100's rates (tracing.H100, at the ambient precision), the
GFLOP and link MiB per device and the algorithm's total GFLOP. On one
device there is one shape, (1, 1, 1). The virtual multi-device CPU mesh
(--cpu) and more than one device (--devices) wait for the distributed
substrate (ROADMAP queue M, item M23b) and raise.
"""

from __future__ import annotations

import argparse
import json

import torch

from capital_tpu_torch import matrix, tracing
from capital_tpu_torch.bench.common import device_of, time_call
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.ops import precision


def _case(alg: str, grid: Grid, args, scale: int, p_: int):
    """(fn, operands, total flops) of one alg at one grid shape."""
    if alg == "cholinv":
        from capital_tpu_torch.algs import cholinv

        n = args.n * scale
        a = matrix.symmetric(grid, n, 0).data
        cfg = cholinv.Config(min_bc=128, base_method="xla",
                             summa_impl="shard_map")
        return (lambda x: cholinv.factor(grid, x, cfg)), (a,), 2 * n**3 / 3
    if alg == "cacqr":
        from capital_tpu_torch.algs import cacqr

        m = args.m * (p_ if args.weak else 1)
        a = matrix.tall_skinny(grid, m, args.n, 0).data
        cfg = cacqr.Config(num_iter=2, base_method="xla")
        return ((lambda x: cacqr.factor_1d(grid, x, cfg)), (a,),
                2 * (4 * m * args.n**2 + 2 * args.n**3 / 3))
    if alg == "polar":
        # spectral-layer proxy: the QDWH sweep dominates eigh and svd
        from capital_tpu_torch.algs import cholinv, polar

        n = args.n * scale
        a = matrix.rand(grid, n, n, 0).data
        pcfg = polar.Config(
            compute_h=False,
            chol=cholinv.Config(min_bc=128, base_method="xla",
                                summa_impl="shard_map"))
        iters = len(polar.qdwh_weights(pcfg.resolve_l0(torch.float32),
                                       torch.float32, pcfg.max_iter))
        return ((lambda x: polar.polar(grid, x, pcfg, layout="2d")), (a,),
                iters * 5 * n**3)
    from capital_tpu_torch.parallel import summa

    n = args.n * scale
    a = matrix.rand(grid, n, n, 0).data
    b = matrix.rand(grid, n, n, 1).data
    return ((lambda x, y: summa.gemm(grid, x, y, impl="shard_map")), (a, b),
            2 * n**3)


def main(argv=None):
    p = argparse.ArgumentParser(description="grid-shape scaling sweep")
    p.add_argument("--alg", default="cholinv",
                   choices=["cholinv", "cacqr", "summa", "polar"])
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--m", type=int, default=1 << 16)
    p.add_argument("--weak", action="store_true",
                   help="scale the problem with the grid (weak scaling)")
    p.add_argument("--cpu", action="store_true",
                   help="the virtual multi-device CPU mesh (not ported: "
                        "raises)")
    p.add_argument("--devices", type=int, default=None,
                   help="devices to sweep over (one device: 1)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on cuda:0 (default) or the CPU")
    args = p.parse_args(argv)
    if args.cpu or (args.devices or 1) > 1:
        raise NotImplementedError(
            "the multi-device scaling sweep (--cpu, --devices > 1) waits "
            "for the distributed substrate (ROADMAP queue M, item M23b)")

    rows = []
    for c, d in [(1, 1)]:
        p_ = c * d * d
        grid = Grid.square(c=c, d=d, device=device_of(args))
        scale = int(p_**0.5) if args.weak else 1
        fn, fargs, flops = _case(args.alg, grid, args, scale, p_)
        with tracing.trace() as t:
            fn(*fargs)
        wall, out = time_call(lambda: fn(*fargs), grid.device)
        del out
        tot = t.totals()
        level = precision.prec()
        rows.append({
            "alg": args.alg, "grid": [c, d, d], "devices": p_,
            "wall_s": round(wall, 5),
            "model_s": round(t.model_time(tracing.H100.flops_per_s[level],
                                          tracing.H100.link_bytes_per_s), 6),
            "gflop_per_dev": round(tot.flops / 1e9, 3),
            "link_mib_per_dev": round(tot.comm_bytes / 2**20, 3),
            "total_gflop": round(flops / 1e9, 3),
        })
        print(json.dumps(rows[-1]))
    return rows


if __name__ == "__main__":
    main()
