"""The LU panel leaf (getrf_leaf) by height and by rows per CTA, on one card.

    python -m capital_tpu_torch.bench.leaf
    python -m capital_tpu_torch.bench.leaf --heights 128 2048 --min-rows 16 32

For each height, a (height, 128) window of a workspace with row stride
32768 (the LU path's) is factored on the resident route at each
`--min-rows` (the smallest rows a CTA that `ops.cuda_getrf.plan` allows,
which sets the grid of a short strip) and on the tall route, each launch
timed with CUDA events over `--reps` calls less the copy that restores
the input. Every run's pj and pivots must equal the first run's at that
height. Prints one JSON line per (height, plan) and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from capital_tpu_torch.ops import cuda_getrf

IB, LD = 128, 32768  # the LU paths' leaf width and row stride


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--heights", type=int, nargs="+",
                   default=[128, 512, 2048, 8192, 17792, 32768])
    p.add_argument("--min-rows", type=int, nargs="+",
                   default=[1, 8, 16, 32, 64, 128, 256])
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench.leaf: no CUDA device is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    limits = cuda_getrf.limits(0)
    for mm in args.heights:
        ws = torch.empty((mm, LD), device=dev)
        win = ws[:, :IB]
        src = torch.randn((mm, IB), generator=gen, device=dev)
        plans = {}
        for mr in args.min_rows:
            how = cuda_getrf.plan(mm, IB, *limits, min_rows=mr)
            if how.route == "resident":
                plans.setdefault(how, []).append(mr)
        plans[cuda_getrf.Plan("tall")] = []
        first = None

        def restore():
            win.copy_(src)

        copy_ms = _ms(restore, args.reps)
        for how, mrs in plans.items():
            def run(how=how):
                restore()
                return cuda_getrf.launch(win, how)

            ms = _ms(run, args.reps) - copy_ms
            _, pj, piv = run()
            if first is None:
                first = (pj.clone(), piv.clone())
            same = torch.equal(pj, first[0]) and torch.equal(piv, first[1])
            print(json.dumps({"mm": mm, "ib": IB, "min_rows": mrs,
                              "plan": how._asdict(), "ms": ms,
                              "us_per_column": 1e3 * ms / IB,
                              "pivots_equal": same, "card": card}),
                  flush=True)
            if not same:
                raise SystemExit(f"bench.leaf: {mm} rows, {how}: pj/pivots "
                                 "differ from the first run's")
        del ws, win, src


if __name__ == "__main__":
    main()
