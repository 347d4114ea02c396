"""LU bench driver (counterpart of capital_tpu/bench/lu.py), with the same
flags plus --device.

    python -m capital_tpu_torch.bench.lu --n 32768 --nb 2048
    python -m capital_tpu_torch.bench.lu --n 8192 --sweep    # panel widths

GFLOP/s counts 2n^3/3 over the best timed call. The operand is
torch.randn from a torch.Generator seeded 0 (its values differ from
jax.random's). The report names the device it ran on.
"""

from __future__ import annotations

import contextlib
import os
from unittest import mock

import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.algs import lu
from capital_tpu_torch.bench.common import (apply_precision, base_parser,
                                            device_of, report, timed_loop)
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.ops.precision import default_matmul_precision
from capital_tpu_torch.ops.precision import dot as _pdot
from capital_tpu_torch.parallel import summa


def _chunked_residual(grid, w, perm, a, chunk: int = 2048):
    """||P A - L U||_F via row slabs of L, each multiplied by triu(W) in
    K chunks at 'highest': peak extra memory is a few (chunk x n) slabs,
    never a second n^2 buffer. K chunks right of a slab's diagonal
    multiply zeros of L and are skipped."""
    n = w.shape[0]
    chunk = min(chunk, n)
    while n % chunk:
        chunk //= 2
    dev = w.device
    cols = torch.arange(n, device=dev)[None, :]
    total = torch.zeros((), dtype=torch.float64, device=dev)
    with default_matmul_precision("highest"):
        for i0 in range(0, n, chunk):
            ridx = i0 + torch.arange(chunk, device=dev)[:, None]
            rows = w[i0:i0 + chunk]
            l_slab = torch.where(cols < ridx, rows, 0.0) + (cols == ridx).to(
                rows.dtype)
            lu_rows = torch.zeros((chunk, n), dtype=torch.float32,
                                  device=dev)
            for k0 in range(0, i0 + chunk, chunk):
                kidx = k0 + torch.arange(chunk, device=dev)[:, None]
                tri = torch.where(cols >= kidx, w[k0:k0 + chunk], 0.0)
                lu_rows += _pdot(l_slab[:, k0:k0 + chunk], tri,
                                 preferred_element_type=torch.float32)
            pa_rows = a.index_select(0, perm[i0:i0 + chunk]).float()
            total += torch.sum(torch.square(pa_rows - lu_rows)).double()
    return torch.sqrt(total).float()


def residual(grid, w, perm, a) -> float:
    """||P A - L U|| / ||A||: chunked at n >= 16384, dense below."""
    n = w.shape[0]
    if n >= 16384:
        num = _chunked_residual(grid, w, perm, a)
    else:
        with default_matmul_precision("highest"):
            l, u = lu.unpack(w)
            num = torch.linalg.norm(a.index_select(0, perm)
                                    - _pdot(l, u).to(a.dtype))
    return float(num / torch.linalg.norm(a.float()))


def main(argv=None):
    p = base_parser("LU factorization with partial pivoting")
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--nb", type=int, default=1024, help="panel width")
    p.add_argument("--summa-impl", default="shard_map",
                   choices=["shard_map", "ring", "gspmd"])
    p.add_argument("--solve-k", type=int, default=0,
                   help="also time a k-column solve off the factorization")
    p.add_argument("--factor-dtype", default=None,
                   choices=[None, "bfloat16"],
                   help="solve path: factor a downcast copy of A and refine "
                        "against the original")
    p.add_argument("--refine", type=int, default=2,
                   help="iterative-refinement sweeps in the timed solve")
    p.add_argument("--sweep", action="store_true",
                   help="sweep panel widths instead of one config")
    p.add_argument("--donate", action="store_true")
    p.add_argument("--lookahead", action="store_true",
                   help="split-Schur lookahead (CAPITAL_LU_LOOKAHEAD=1)")
    args = p.parse_args(argv)
    # the JAX driver's distributed-schedule flags and --donate: on one
    # device a value other than the default would change nothing
    idle = [flag for flag, on in (
        ("--layout", args.layout != 0),
        ("--summa-impl", args.summa_impl != "shard_map"),
        ("--donate", args.donate)) if on]
    if idle:
        p.error(f"{', '.join(idle)}: no effect on one device (factor "
                "always copies A into its workspace); multi-device "
                "schedules are ROADMAP queue M")
    env = {"CAPITAL_LU_LOOKAHEAD": "1"} if args.lookahead else {}
    with mock.patch.dict(os.environ, env), apply_precision(args):
        return _run(args, p)


def _run(args, parser):
    dev = device_of(args)
    grid = Grid.square(c=args.c, d=1, device=dev)
    dtype = getattr(torch, args.dtype)
    n = args.n
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=dev).to(dtype)
    flops = 2.0 * n**3 / 3.0
    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")

    nbs = [256, 512, 1024, 2048, 4096] if args.sweep else [args.nb]
    nbs = [nb for nb in nbs if nb <= n]
    if not nbs:
        parser.error(f"no panel width <= n={n} (use --nb <= n)")
    prof = (tracing.profile(args.profile_dir) if args.profile_dir
            else contextlib.nullcontext())
    rec = None
    for nb in nbs:
        cfg = lu.Config(nb=nb, summa_impl=args.summa_impl)

        def run(cfg=cfg):
            return lu.factor(grid, a, cfg)

        with tracing.trace() as t:  # the warm-up call records the costs
            run()
        with prof if nb == nbs[-1] else contextlib.nullcontext():
            secs, _, (w, perm, sign) = timed_loop(run, dev, args.num_iter,
                                                  warmup=0)
        extra = {"n": n, "nb": nb, "dtype": args.dtype,
                 "precision": args.precision, "devices": grid.num_devices,
                 "device": device_name}
        if not args.no_validate:
            extra["residual"] = residual(grid, w, perm, a)
        rec = report(f"lu_n{n}", secs=secs, flops=flops, extra=extra,
                     as_json=args.json)

    if args.solve_k:
        b = torch.randn((n, args.solve_k), generator=gen, device=dev).to(
            dtype)
        if args.factor_dtype:
            fdt = getattr(torch, args.factor_dtype)
            fsecs, _, (wf, perm, _s) = timed_loop(
                lambda: lu.factor(grid, a.to(fdt), cfg), dev, args.num_iter)
            w = wf.to(dtype)
            report(f"lu_factor_{args.factor_dtype}_n{n}", secs=fsecs,
                   flops=flops, extra={"nb": nbs[-1]}, as_json=args.json)

        def solve():
            x = lu.solve_factored(grid, w, perm, b)
            for _ in range(args.refine):
                with default_matmul_precision("highest"):
                    r = b - summa.gemm(grid, a, x)
                x = x + lu.solve_factored(grid, w, perm, r)
            return x

        secs, _, x = timed_loop(solve, dev, args.num_iter)
        extra = {"k": args.solve_k, "refine": args.refine,
                 "device": device_name}
        if not args.no_validate:
            with default_matmul_precision("highest"):
                res = torch.linalg.norm(_pdot(a, x) - b) / torch.linalg.norm(b)
            extra["solve_residual"] = float(res)
        report(f"lu_solve_n{n}", secs=secs, flops=2.0 * n * n * args.solve_k,
               extra=extra, as_json=args.json)

    if args.costs:
        print(t.report())
    return rec


if __name__ == "__main__":
    main()
