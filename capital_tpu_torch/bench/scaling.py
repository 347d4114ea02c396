"""Grid-shape scaling sweep (counterpart of capital_tpu/bench/scaling.py).

    python -m capital_tpu_torch.bench.scaling --alg cholinv|cacqr|summa|polar
        [--n 1024] [--m 65536] [--weak] [--cpu] [--devices N]
        [--device cuda|cpu]

The JAX package's shapes (c, d) = (1, 1), (1, 2), (2, 1), (2, 2) with
c*d*d <= N, each the square c x d x d grid over ranks 0 .. c*d*d - 1 of
one world of N ranks (Grid.square(_prefix=True); a rank outside a
shape's grid waits at a world barrier), its devices launch.devices_for's:
N gloo CPU ranks with --cpu (N = 8 unless --devices says, the JAX
package's virtual CPU mesh) or --device cpu (N = 1 unless --devices
says), one NCCL rank a card with --device cuda (N = the visible cards
unless --devices says; more than are visible raises). Under torchrun the
world is torchrun's.

One line a (grid shape, algorithm): the wall time of one call after a
warm-up call that records the analytic costs (each rank timed from a
barrier of the grid's ranks, the slowest rank's), the cost model's time
at the H100's rates (tracing.H100, at the ambient precision), the GFLOP
and link MiB per device (rank 0's records) and the algorithm's total
GFLOP. --weak scales n by sqrt(p) and m by p, p the shape's ranks.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from capital_tpu_torch import matrix, tracing
from capital_tpu_torch.bench.common import grid_barrier, slowest, time_call
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.ops import precision
from capital_tpu_torch.parallel import launch

SHAPES = ((1, 1), (1, 2), (2, 1), (2, 2))


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


def _row(alg: str, grid: Grid, args, c: int, d: int) -> dict:
    """The shape's row on this rank (rank 0's is reported)."""
    p_ = c * d * d
    scale = int(p_**0.5) if args.weak else 1
    fn, fargs, flops = _case(alg, grid, args, scale, p_)
    with tracing.trace() as t:
        fn(*fargs)
    grid_barrier(grid)
    wall, out = time_call(lambda: fn(*fargs), grid.device)
    del out
    wall = slowest(grid, wall)
    tot = t.totals()
    level = precision.prec()
    return {
        "alg": alg, "grid": [c, d, d], "devices": p_,
        "wall_s": round(wall, 5),
        "model_s": round(t.model_time(tracing.H100.flops_per_s[level],
                                      tracing.H100.link_bytes_per_s), 6),
        "gflop_per_dev": round(tot.flops / 1e9, 3),
        "link_mib_per_dev": round(tot.comm_bytes / 2**20, 3),
        "total_gflop": round(flops / 1e9, 3),
    }


def _sweep(device, args, p: int) -> list:
    """One rank's part of the sweep over p ranks (launch.run_on: device
    None in a world, else the one device); rank 0 returns the rows
    (printing each), every other rank of a world []."""
    rows = []
    root = device is not None or dist.get_rank() == 0
    for c, d in SHAPES:
        if c * d * d > p:
            continue
        grid = Grid.square(c=c, d=d, device=device, _prefix=True)
        if grid.on_this_rank:
            rows.append(_row(args.alg, grid, args, c, d))
            if root:
                print(json.dumps(rows[-1]), flush=True)
        if device is None:
            dist.barrier()  # the ranks outside the grid wait here
    return rows if root else []


def main(argv=None):
    p = argparse.ArgumentParser(description="grid-shape scaling sweep")
    p.add_argument("--alg", default="cholinv",
                   choices=["cholinv", "cacqr", "summa", "polar"])
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--m", type=int, default=1 << 16)
    p.add_argument("--weak", action="store_true",
                   help="scale the problem with the grid (weak scaling)")
    p.add_argument("--cpu", action="store_true",
                   help=f"gloo CPU ranks ({launch.CPU_RANKS} unless "
                        "--devices says), even when a card is visible")
    p.add_argument("--devices", type=int, default=None,
                   help="ranks to sweep over (default: --cpu 8, --device "
                        "cpu 1, --device cuda the visible cards)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="one NCCL rank a card (default) or gloo CPU ranks")
    args = p.parse_args(argv)

    # --cpu: the JAX package's CPU ranks; --device cpu: one CPU device
    # unless --devices says, as in the tuner and the port's other benches
    devs = launch.devices_for("cpu" if args.cpu else args.device,
                              args.devices, launch.CPU_RANKS if args.cpu
                              else 1)
    return launch.run_on(_sweep, devs, args, len(devs))


if __name__ == "__main__":
    main()
