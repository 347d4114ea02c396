"""QDWH polar decomposition bench driver: A = U H of matrix.rand (m, n),
seed 0, with the common flags (--precision, --costs, --profile-dir,
--device, ...).

    python -m capital_tpu_torch.bench.polar --m 262144 --n 2048

Layout '2d', default polar.Config (l0 = 1e-5 for f32).

Reports the best of --num-iter timed calls and its GFLOP/s, counting
steps * (4mn^2 + 2n^3/3) for the QDWH steps (the JAX package's `qdwh`
cost record), 4mn^2 a polish and 2mn^2 for H; the orthogonality
||U^T U - I||_F / sqrt(n) (Gram by cacqr.gram_1d, so the SYRK kernel on a
GPU) and the reconstruction ||U H - A||_F / ||A||_F (row chunks at
'highest'), and `vs_library`: the time of torch.linalg.svd(A,
full_matrices=False) with U V^T and V diag(S) V^T on the same operand
over the port's best time (f32 only).
"""

from __future__ import annotations

import contextlib

import torch

from capital_tpu_torch import matrix, tracing, validate
from capital_tpu_torch.algs import polar
from capital_tpu_torch.bench.common import (apply_precision, base_parser,
                                            device_of, report, time_call,
                                            timed_loop)
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.ops.precision import default_matmul_precision
from capital_tpu_torch.ops.precision import dot as _pdot


def reconstruction(a: torch.Tensor, u: torch.Tensor, h: torch.Tensor,
                   rows: int = 1 << 16) -> float:
    """||U H - A||_F / ||A||_F in row chunks at 'highest'."""
    d2 = a2 = 0.0
    with default_matmul_precision("highest"):
        for i in range(0, a.shape[0], rows):
            ac = a[i:i + rows].float()
            d2 += float(torch.sum((_pdot(u[i:i + rows], h) - ac) ** 2))
            a2 += float(torch.sum(ac ** 2))
    return (d2 / a2) ** 0.5


def main(argv=None):
    p = base_parser("QDWH polar decomposition")
    p.add_argument("--m", type=int, default=1 << 18)
    p.add_argument("--n", type=int, default=2048)
    args = p.parse_args(argv)
    with apply_precision(args):
        return _run(args)


def _run(args):
    dev = device_of(args)
    grid = Grid.square(c=args.c, d=1, device=dev)
    dtype = getattr(torch, args.dtype)
    a = matrix.rand(grid, args.m, args.n, 0, dtype=dtype).data
    cfg = polar.Config()

    def run():
        return polar.polar(grid, a, cfg, layout="2d")

    prof = (tracing.profile(args.profile_dir) if args.profile_dir
            else contextlib.nullcontext())
    with tracing.trace() as t:  # the warm-up call records the costs
        run()
    with prof:
        secs, times, (u, h) = timed_loop(run, dev, args.num_iter, warmup=0)
    steps = polar.qdwh_weights(cfg.resolve_l0(dtype), dtype, cfg.max_iter)
    extra = {"m": args.m, "n": args.n, "layout": "2d",
             "steps": len(steps), "ms": [s * 1e3 for s in times],
             "device": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu")}
    if not args.no_validate:
        with default_matmul_precision("highest"):
            extra["orthogonality"] = float(validate.qr_orthogonality(grid, u))
        extra["reconstruction"] = reconstruction(a, u, h)
    del u, h
    if dtype == torch.float32:
        def library():
            uu, ss, vh = torch.linalg.svd(a, full_matrices=False)
            return uu @ vh, (vh.T * ss) @ vh

        time_call(lambda: torch.linalg.svd(a[:4096], full_matrices=False),
                  dev)
        lib_secs, out = time_call(library, dev)
        del out
        extra["library_ms"] = lib_secs * 1e3
        extra["vs_library"] = lib_secs / secs
    m, n = args.m, args.n
    flops = (len(steps) * (4 * m * n * n + 2 * n**3 / 3)
             + cfg.ns_polish * 4 * m * n * n + 2 * m * n * n)
    rec = report("polar", secs=secs, flops=flops, extra=extra,
                 as_json=args.json)
    if args.costs:
        print(t.report())
    return rec


if __name__ == "__main__":
    main()
