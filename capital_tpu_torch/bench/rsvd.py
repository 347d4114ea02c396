"""Randomized SVD bench (counterpart of capital_tpu/bench/rsvd.py):
the rank-k truncated SVD of a planted low-rank-plus-noise A, with the
common flags (--dtype, --precision, --costs, --profile-dir, --device,
--json, ...).

    python -m capital_tpu_torch.bench.rsvd --m 262144 --n 2048 --k 128
    python -m capital_tpu_torch.bench.rsvd --m 524288 --n 4096 --k 256 \
        --oversample 32 --dtype bfloat16

Reports the best of --num-iter timed calls and its GFLOP/s, counting the
textbook products (q+1 sketch/power passes down, q up and the core, 2mnl
each, plus 8ml^2 for each CholeskyQR2); `sv_rel_err`, the largest
relative error of the top k singular values against the planted ones;
`subspace_residual` ||A V^T - U diag(s)||_F / ||A||_F at 'highest'; and
`vs_library`: the time of torch.svd_lowrank(A, q=l, niter=q) on the same
operand over the port's best time (f32 only; null for bf16, which
torch.svd_lowrank does not take).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.algs import cacqr
from capital_tpu_torch.apps import rsvd
from capital_tpu_torch.bench.common import (apply_precision, base_parser,
                                            device_of, report, time_call,
                                            timed_loop)
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.matrix import _generator
from capital_tpu_torch.ops.precision import default_matmul_precision
from capital_tpu_torch.ops.precision import dot as _pdot


def _planted(grid: Grid, m: int, n: int, rank: int, dtype, key):
    """A = U diag(s) V^T + noise, s geometric in [10, 1] (f32), and s. U
    is orthonormalized by the framework's CholeskyQR2 (cacqr.factor_1d),
    V by Householder QR; the noise has spectral norm ~0.01 (sigma =
    0.01 / sqrt(m)), so the planted values are the true ones to ~1e-4.
    Made on the grid's device from a generator seeded `key` (an int or a
    torch.Generator)."""
    gen, dev = _generator(grid, key), grid.device
    g = torch.randn((m, rank), generator=gen, device=dev)
    u, _ = cacqr.factor_1d(grid, g, cacqr.Config(num_iter=2))
    del g
    v = torch.linalg.qr(torch.randn((n, rank), generator=gen,
                                    device=dev))[0]
    s = torch.from_numpy(np.geomspace(10.0, 1.0, rank)).float().to(dev)
    sigma = 0.01 / float(m) ** 0.5
    a = _pdot(u, (v * s).T)
    del u
    a.add_(torch.randn((m, n), generator=gen, device=dev), alpha=sigma)
    return a.to(dtype), s


def subspace_residual(a: torch.Tensor, u: torch.Tensor, s: torch.Tensor,
                      vt: torch.Tensor, rows: int = 1 << 16) -> float:
    """||A V^T - U diag(s)||_F / ||A||_F, f32-faithful ('highest'), in row
    chunks."""
    d2 = a2 = 0.0
    with default_matmul_precision("highest"):
        for i in range(0, a.shape[0], rows):
            ac = a[i:i + rows].float()
            av = _pdot(ac, vt.T.float())
            d2 += float(torch.sum((av - u[i:i + rows].float() * s) ** 2))
            a2 += float(torch.sum(ac ** 2))
    return (d2 / a2) ** 0.5


def main(argv=None):
    p = base_parser("randomized SVD / PCA (CholeskyQR2 range finder)")
    p.add_argument("--m", type=int, default=1 << 18)
    p.add_argument("--n", type=int, default=2048)
    p.add_argument("--k", type=int, default=128)
    p.add_argument("--oversample", type=int, default=16)
    p.add_argument("--power-iters", type=int, default=1)
    args = p.parse_args(argv)
    with apply_precision(args):
        return _run(args)


def _run(args):
    dev = device_of(args)
    grid = Grid.square(c=args.c, d=1, device=dev)
    dtype = getattr(torch, args.dtype)
    m, n, k, q = args.m, args.n, args.k, args.power_iters
    l = k + args.oversample
    # planted rank k: k strong directions (recoverable) inside a noisy A
    a, s_true = _planted(grid, m, n, k, dtype, 0)
    cfg = rsvd.Config(k=k, oversample=args.oversample, power_iters=q)

    def run():
        return rsvd.rsvd(grid, a, cfg)

    prof = (tracing.profile(args.profile_dir) if args.profile_dir
            else contextlib.nullcontext())
    with tracing.trace() as t:  # the warm-up call records the costs
        run()
    with prof:
        secs, times, (u, s, vt) = timed_loop(run, dev, args.num_iter,
                                             warmup=0)
    flops = 2.0 * m * n * l * (2 * q + 2) + (q + 1) * 8.0 * m * l * l
    extra = {"m": m, "n": n, "k": k, "l": l, "power_iters": q,
             "grid": grid.shape, "dtype": args.dtype,
             "ms": [x * 1e3 for x in times],
             "device": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu")}
    if not args.no_validate:
        extra["sv_rel_err"] = float(torch.max(torch.abs(s - s_true[:k])
                                              / s_true[:k]))
        extra["subspace_residual"] = subspace_residual(a, u, s, vt)
    del u, s, vt
    if dtype == torch.float32:
        time_call(lambda: torch.svd_lowrank(a[:4096], q=l, niter=q), dev)
        lib_secs, out = time_call(lambda: torch.svd_lowrank(a, q=l, niter=q),
                                  dev)
        del out
        extra["library_ms"] = lib_secs * 1e3
        extra["vs_library"] = lib_secs / secs
    else:
        extra["library_ms"] = extra["vs_library"] = None
    rec = report("rsvd", secs=secs, flops=flops, extra=extra,
                 as_json=args.json)
    if args.costs:
        print(t.report())
    return rec


if __name__ == "__main__":
    main()
