"""Solver bench driver (counterpart of capital_tpu/bench/solve.py):
spd_solve or lstsq (CholeskyQR2) with iterative refinement, with the
same flags plus --device, --costs and --profile-dir.

    python -m capital_tpu_torch.bench.solve --n 16384 --k 256 \\
        --precision high --refine 2
    python -m capital_tpu_torch.bench.solve --alg lstsq --m 524288 \\
        --n 1024 --k 64 --refine 1

GFLOP/s counts 2n^3/3 + (2 + 4 refine) n^2 k (spd) or 4mn^2 + (2 + 4
refine) m n k (lstsq) over the best timed call. The residual is taken in
f64 on the host over the first 8 columns: ||A x - b|| / ||b|| (spd) or
the normal-equations residual ||A^T (A x - b)|| / ||b|| (lstsq), so the
check never rides the precision it measures. `vs_library` is the time of
the library call on the same operands (torch.linalg.cholesky +
cholesky_solve; torch.linalg.lstsq) over the port's best time, f32 only.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from capital_tpu_torch import linalg, matrix, tracing
from capital_tpu_torch.algs import cacqr, cholinv
from capital_tpu_torch.bench.common import (apply_precision, base_parser,
                                            device_of, report, time_call,
                                            timed_loop)
from capital_tpu_torch.grid import Grid

RESIDUAL_COLS = 8


def host_f64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def residual_f64(alg: str, a64: np.ndarray, b64: np.ndarray,
                 x: torch.Tensor) -> float:
    """The f64 host residual of x over b64's columns (a64, b64 from
    host_f64; b64 already cut to the columns checked)."""
    ax_b = a64 @ host_f64(x[:, :b64.shape[1]]) - b64
    if alg == "lstsq":  # least-squares optimality: A^T (A x - b) = 0
        ax_b = a64.T @ ax_b
    return float(np.linalg.norm(ax_b) / np.linalg.norm(b64))


def operands(grid: Grid, alg: str, m: int, n: int, k: int, dtype):
    """(A, b) as the JAX bench makes them, from seeds 0 and 1: an SPD
    matrix.symmetric (n, n) and a rand (n, k); or a tall_skinny (m, n) and
    a rand (m, k)."""
    if alg == "spd":
        a = matrix.symmetric(grid, n, 0, dtype=dtype, align=128).data
        return a, matrix.rand(grid, n, k, 1, dtype=dtype).data
    a = matrix.tall_skinny(grid, m, n, 0, dtype=dtype).data
    return a, matrix.rand(grid, m, k, 1, dtype=dtype).data


def library_call(alg: str, a: torch.Tensor, b: torch.Tensor):
    """The call a user would make instead (never used by the port)."""
    if alg == "spd":
        return lambda: torch.cholesky_solve(b, torch.linalg.cholesky(a))
    return lambda: torch.linalg.lstsq(a, b).solution


def main(argv=None):
    p = base_parser("SPD solve / least squares with iterative refinement")
    p.add_argument("--alg", default="spd", choices=["spd", "lstsq"])
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--m", type=int, default=1 << 18,
                   help="rows for lstsq (tall-skinny)")
    p.add_argument("--k", type=int, default=256, help="right-hand sides")
    p.add_argument("--refine", type=int, default=0,
                   help="iterative-refinement sweeps (residual product "
                        "at 'highest')")
    args = p.parse_args(argv)
    with apply_precision(args):
        return _run(args)


def _run(args):
    dev = device_of(args)
    grid = Grid.square(c=args.c, d=1, device=dev)
    dtype = getattr(torch, args.dtype)
    m, n, k = args.m, args.n, args.k
    a, b = operands(grid, args.alg, m, n, k, dtype)
    extra = {"alg": args.alg, "refine": args.refine,
             "precision": args.precision, "n": n}
    if args.alg == "spd":
        cfg = cholinv.Config(summa_impl="gspmd")

        def run():
            return linalg.spd_solve(grid, a, b, cfg, refine=args.refine)

        flops = 2 * n**3 / 3 + (2 + 4 * args.refine) * n**2 * k
    else:
        cfg = cacqr.Config(num_iter=2)

        def run():
            return linalg.lstsq(grid, a, b, cfg, refine=args.refine)

        extra["m"] = m
        flops = 4 * m * n**2 + (2 + 4 * args.refine) * m * n * k
    extra.update(k=k, grid=grid.shape, device=(
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"))

    prof = (tracing.profile(args.profile_dir) if args.profile_dir
            else contextlib.nullcontext())
    with tracing.trace() as t:  # the warm-up call records the costs
        run()
    with prof:
        secs, times, x = timed_loop(run, dev, args.num_iter, warmup=0)
    extra["ms"] = [s * 1e3 for s in times]
    kb = min(k, RESIDUAL_COLS)
    name = "solve_residual" if args.alg == "spd" else "normal_residual"
    if not args.no_validate:
        a64, b64 = host_f64(a), host_f64(b[:, :kb])
        extra[name] = residual_f64(args.alg, a64, b64, x)
    if dtype == torch.float32:
        lib = library_call(args.alg, a, b)
        time_call(lib, dev)  # warm-up
        lib_secs, x_lib = time_call(lib, dev)
        extra["library_ms"] = lib_secs * 1e3
        extra["vs_library"] = lib_secs / secs
        if not args.no_validate:
            extra[f"library_{name}"] = residual_f64(args.alg, a64, b64,
                                                    x_lib)
    rec = report("solve", secs=secs, flops=flops, extra=extra,
                 as_json=args.json)
    if args.costs:
        print(t.report())
    return rec


if __name__ == "__main__":
    main()
