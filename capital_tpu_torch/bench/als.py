"""ALS recommender bench (counterpart of capital_tpu/bench/als.py):
batched normal-equation Cholesky solves on synthetic ratings at
MovieLens-like aspect, with the common flags (--costs, --profile-dir,
--device, --json, ...).

    python -m capital_tpu_torch.bench.als                 # dense mask
    python -m capital_tpu_torch.bench.als --sparse        # 192 obs a user

Dense: synthetic_ratings (planted rank 16, --density) and `fit`; sparse:
synthetic_regular (--obs-per-user, planted rank 16) and `fit_sparse`;
lam = 0.05, data from seed 0. Reports the best of --num-iter timed fits,
GFLOP/s counting the JAX bench's flops (per iteration 4 U I k^2 dense or
4 nnz k^2 sparse, plus (U + I) k^3 / 3 for the solves) and the RMSE over
the observed entries (the planted noise floor is 0.05).
"""

from __future__ import annotations

import contextlib

import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.apps import als
from capital_tpu_torch.bench.common import (apply_precision, base_parser,
                                            device_of, report, timed_loop)
from capital_tpu_torch.grid import Grid


def main(argv=None):
    p = base_parser("ALS recommender (batched normal-equation Cholesky)")
    p.add_argument("--users", type=int, default=65536)
    p.add_argument("--items", type=int, default=8192)
    p.add_argument("--rank", type=int, default=64)
    p.add_argument("--density", type=float, default=0.05)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--sparse", action="store_true",
                   help="bucketed-sparse updates: O(nnz k^2) instead of "
                        "O(U I k^2)")
    p.add_argument("--obs-per-user", type=int, default=192,
                   help="observations per user for --sparse")
    args = p.parse_args(argv)
    with apply_precision(args):
        return _run(args)


def _run(args):
    dev = device_of(args)
    grid = Grid.square(c=args.c, d=1, device=dev)
    dtype = getattr(torch, args.dtype)
    cfg = als.Config(rank=args.rank, lam=0.05, num_iters=args.iters)
    users, items, k = args.users, args.items, args.rank

    if args.sparse:
        s = args.obs_per_user
        data = als.synthetic_regular(grid, users, items, s, 0, dtype=dtype)

        def run():
            return als.fit_sparse(grid, data, cfg, items=items)

        nnz = users * s
        # 2 sides x (Gramians 2 nnz k^2 + right-hand sides) + the solves
        flops = args.iters * (4.0 * nnz * k**2 + (users + items) * k**3 / 3)
        extra = {"users": users, "items": items, "rank": k, "nnz": nnz,
                 "iters": args.iters, "sparse": True}
    else:
        r, m = als.synthetic_ratings(grid, users, items, 0, rank=16,
                                     density=args.density, dtype=dtype)

        def run():
            return als.fit(grid, r, m, cfg)

        # per iteration: the masked Gramians, 2 U I k^2 a side, and the
        # solves, (U + I) k^3 / 3
        flops = args.iters * (4.0 * users * items * k**2
                              + (users + items) * k**3 / 3)
        extra = {"users": users, "items": items, "rank": k,
                 "density": args.density, "iters": args.iters}

    prof = (tracing.profile(args.profile_dir) if args.profile_dir
            else contextlib.nullcontext())
    with tracing.trace() as t:  # the warm-up call records the phases
        run()
    with prof:
        secs, times, (u, v, err) = timed_loop(run, dev, args.num_iter,
                                              warmup=0)
    extra.update(rmse=float(err), grid=grid.shape,
                 ms=[x * 1e3 for x in times],
                 device=(torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"))
    rec = report("als", secs=secs, flops=flops, extra=extra,
                 as_json=args.json)
    if args.costs:
        print(t.report())
    return rec


if __name__ == "__main__":
    main()
