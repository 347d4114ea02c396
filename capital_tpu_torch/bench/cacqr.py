"""CholeskyQR / CholeskyQR2 benchmark (counterpart of
capital_tpu/bench/cacqr.py), with the same flags plus --device and
--gram-kernel.

    python -m capital_tpu_torch.bench.cacqr --m 1048576 --n 1024 --variant 2

Every timed call factors a fresh operand (tall_skinny from seed i + 1;
the warm-up takes seed 0), so Q and R of the last call belong to the
last seed, from which A is regenerated for the residual. GFLOP/s counts
the useful flops, variant * (4mn^2 + 2n^3/3) (Gram, Q and Cholesky of
each sweep), over the best timed call. `vs_library` is the time of
torch.linalg.qr(A, mode='reduced') on that same operand over the port's
best time (null for bf16, which torch.linalg.qr does not take, and
across ranks). Under torchrun the grid is the rect grid of --c over
every rank (A's rows over all of them):

    torchrun --nproc-per-node=8 -m capital_tpu_torch.bench.cacqr --c 2 \
        --path hybrid --gram-policy two_stage
"""

from __future__ import annotations

import functools

import torch

from capital_tpu_torch import matrix, tracing, validate
from capital_tpu_torch.algs import cacqr, cholinv
from capital_tpu_torch.bench.common import (apply_precision, base_parser,
                                            report, time_call, world_grid)


def main(argv=None):
    p = base_parser("CholeskyQR2 (tall-skinny QR)")
    p.add_argument("--m", type=int, default=1 << 20)
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--variant", type=int, default=2,
                   help="1 = CholeskyQR, 2 = CholeskyQR2")
    p.add_argument("--gram-policy", default="allreduce",
                   choices=["allreduce", "two_stage", "packed"])
    p.add_argument("--path", default="auto",
                   choices=["auto", "1d", "3d", "hybrid"],
                   help="auto = 1d; hybrid = factor_hybrid (on one device "
                        "the Gram Cholesky is the recursive cholinv)")
    p.add_argument("--base-method", default="auto",
                   choices=["auto", "xla", "pallas"],
                   help="Gram Cholesky: pallas = the hand-written fused "
                        "leaf, xla = torch.linalg")
    p.add_argument("--formq-chunks", type=int, default=1,
                   help="form Q in place in N row chunks (memory)")
    p.add_argument("--gram-kernel", default="auto",
                   choices=["auto", "tri", "dot"],
                   help="1d Gram: tri = the SYRK kernel, dot = a plain "
                        "product")
    args = p.parse_args(argv)
    with apply_precision(args):
        return _run(args)


def _run(args):
    grid, dev = world_grid(args, "rect")
    dtype = getattr(torch, args.dtype)
    cfg = cacqr.Config(num_iter=args.variant, gram_policy=args.gram_policy,
                       base_method=args.base_method,
                       formq_chunks=args.formq_chunks,
                       gram_kernel=args.gram_kernel,
                       chol=cholinv.Config(base_method=args.base_method))
    # each timed call gets a fresh operand, so the 1D path may write Q
    # over it (--formq-chunks > 1)
    fn = {"3d": cacqr.factor_3d, "hybrid": cacqr.factor_hybrid}.get(
        args.path, functools.partial(cacqr.factor_1d, overwrite_a=True))
    layout = "2d" if args.path == "3d" else "1d"

    def regen(seed: int):
        return matrix.tall_skinny(grid, args.m, args.n, seed,
                                  dtype=dtype).data

    with tracing.trace() as t:  # the warm-up call records the costs
        fn(grid, regen(0), cfg)
    times = []
    for i in range(args.num_iter):
        q = r = None  # Q and a fresh A need not co-fit with the last Q
        x = regen(i + 1)
        secs, (q, r) = time_call(lambda: fn(grid, x, cfg), dev)
        times.append(secs)
        del x  # with --formq-chunks > 1, Q holds its storage
    secs = min(times)
    if args.profile_dir:
        x = regen(0)
        with tracing.profile(args.profile_dir):
            fn(grid, x, cfg)
        del x
    m, n = args.m, args.n
    flops = args.variant * (4 * m * n * n + 2 * n**3 / 3)
    extra = {"m": m, "n": n, "variant": args.variant, "path": args.path,
             "grid": grid.shape, "ms": [s * 1e3 for s in times],
             "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu")}
    a = regen(args.num_iter)
    if not args.no_validate:
        extra["orthogonality"] = float(validate.qr_orthogonality(
            grid, q, layout=layout))
        extra["residual"] = float(validate.qr_residual(grid, a, q, r,
                                                       layout=layout))
    del q, r
    if dtype == torch.float32 and grid.mesh is None:
        time_call(lambda: torch.linalg.qr(a[:4096], mode="reduced"), dev)
        lib_secs, out = time_call(lambda: torch.linalg.qr(a, mode="reduced"),
                                  dev)
        del out
        extra["library_ms"] = lib_secs * 1e3
        extra["vs_library"] = lib_secs / secs
    else:
        extra["library_ms"] = extra["vs_library"] = None
    rec = report("cacqr", secs=secs, flops=flops, extra=extra,
                 as_json=args.json)
    if args.costs:
        print(t.report())
    return rec


if __name__ == "__main__":
    main()
