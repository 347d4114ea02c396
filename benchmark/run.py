"""Run one cell of BENCHMARK.json and print its result as one JSON line.

    python3 benchmark/run.py --workload cholinv.n32768 --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout. A cell on one card runs in this process; a
cell on several runs one rank a card, spawned by the program's
parallel/launch.py (NCCL), with this process collecting their results.
With --trace 0 the line holds the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, the device's busy and traced seconds
and a breakdown. `correct` says whether the sampled answer lies within
the cell's limits of the plain reference; each number compared is
printed with its limit as the last lines on standard error and as the
last key of the line. Exits with 2, printing no result, where the cards
the cell asks for are not there, and with 3 where JAX or the JAX package
was loaded.
"""

import time

T_PROC0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

LAUNCH_TIMEOUT_S = 1100.0


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _within(value, limit) -> bool:
    return isinstance(value, float) and not math.isnan(value) and (
        value <= limit)


def result(readings, trace: bool) -> tuple[dict, list]:
    """(the result line, the lines of the numbers compared)."""
    from benchmark import spec

    cell, r0 = readings.cell, readings.rank0
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"])(readings)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checked = {k: {"value": r0["numbers"][k], "limit": lim}
               for k, lim in cell.limits.items()}
    ok = all(_within(c["value"], c["limit"]) for c in checked.values())
    device = {"platform": "gpu", "kind": r0["device_name"],
              "count": len(readings.ranks),
              "memory_peak_bytes": max(r["peak_run"]
                                       for r in readings.ranks)}
    # one answer, the sampled one, is judged
    out = {"correct": ok, "attempted": len(r0["calls"]), "failed": int(not ok),
           "metrics": metrics, "device": device}
    traces = [r["trace"] for r in readings.ranks if r["trace"]]
    if trace and traces:
        from benchmark import devtrace

        device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        device["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
        if r0["trace"]:
            out["breakdown"] = {
                "device_ops": devtrace.top(r0["trace"]["device_s"]),
                "idle_gaps": devtrace.top(r0["trace"]["idle_s"])}
    out["checked"] = checked
    lines = [f"reference check of call {r0['sample']}: "
             f"{r0['check_s']:.2f} s after the window"]
    lines += [f"check {k}: {c['value']!r} (limit {c['limit']!r}) "
             f"{'ok' if _within(c['value'], c['limit']) else 'FAILED'}"
             for k, c in checked.items()]
    return out, lines


def main(argv=None) -> int:
    args = _args(argv)
    # the configuration states the program's path: no switch from outside
    for k in [k for k in os.environ if k.startswith("CAPITAL_")]:
        del os.environ[k]
    import torch

    from benchmark import harness, spec

    cell = spec.cell(args.workload)
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s), {seen} visible",
              file=sys.stderr)
        return 2
    if cell.chips == 1:
        harness.pin()
        ranks = [harness.run(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0))]
    else:
        from capital_tpu_torch.parallel import launch

        ranks = launch.launch(harness.rank_main, cell.chips, cell,
                              args.seed, args.seconds, bool(args.trace),
                              device="cuda", timeout=LAUNCH_TIMEOUT_S)
    found = sorted(set(harness.forbidden_modules()).union(
        *(r["found"] for r in ranks)))
    if found:
        print(f"loaded in a run of the port: {found}", file=sys.stderr)
        return 3
    readings = harness.Readings(cell, ranks[0]["t_window0"] - T_PROC0, ranks)
    out, lines = result(readings, bool(args.trace))
    print(json.dumps(out), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
