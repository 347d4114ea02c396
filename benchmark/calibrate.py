"""The readings a cell's limits are set from: the compared numbers of
sound runs of the program over many seeds (short windows at the cell's
own load, in one process), and of two controls over a few: the program
on its own path one level below the configuration's precision
(`lower_precision`, kind "lower"), and the plain reference put in the
program's place and computed with TF32 products (kind "control").

    python3 benchmark/calibrate.py --workload cholinv.n32768 \
        --seeds 101-112 --control-seeds 201-203 --seconds 3

Prints one JSON line a seed and kind ({"cell", "seed", "kind",
"numbers"}) and, last, the largest program reading and the smallest
reading of each control for each number. The benchmark's own runs never
run this. Needs the cards the cell asks for.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out += list(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


def lower(cell):
    """The cell with the program on its own path one level below the
    configuration's precision: a control."""
    return dataclasses.replace(cell, config=dict(
        cell.config, precision=cell.config["lower_precision"]))


def control_numbers(cell, seed: int, device, comm=None) -> dict:
    """The compared numbers of the control on the cell's first operand
    of `seed` (this rank's block of it)."""
    import torch

    from benchmark import harness, spec, traffic

    comm = comm or harness.OneRank()
    ranks = 1 if isinstance(comm, harness.OneRank) else cell.chips
    one = dict(cell.traffic, pool=1)
    a = traffic.operands(cell.config, one, seed, device, comm.rank, ranks)[0]
    ref = spec.reference_module(cell.entry)
    out = ref.control(a, cell.config, comm)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return ref.check(a, out, cell.config, comm)


def readings(cell, seeds: list, control_seeds: list, seconds: float,
             device, comm=None) -> list:
    """[(kind, seed, numbers)] of the program's runs, then the controls'."""
    from benchmark import harness

    def program(c, s):
        r = harness.run(c, s, seconds, False, device, comm)
        ms = sorted((t[2] - t[0]) * 1e3 for t in r["calls"])
        return dict(r["numbers"], calls=len(ms),
                    call_ms_median=ms[len(ms) // 2])

    out = [("program", s, program(cell, s)) for s in seeds]
    for s in control_seeds:
        out.append(("lower", s, program(lower(cell), s)))
        out.append(("control", s, control_numbers(cell, s, device, comm)))
    return out


def rank_main(cell, seeds, control_seeds, seconds) -> list:
    from benchmark import harness
    from capital_tpu_torch.parallel import launch

    return readings(cell, seeds, control_seeds, seconds,
                    launch.world_device(), harness.WorldComm())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="101-112")
    p.add_argument("--control-seeds", default="201-203")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch

    from benchmark import spec

    cell = spec.cell(args.workload)
    seeds, ctl = _seeds(args.seeds), _seeds(args.control_seeds)
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s), {seen} visible",
              file=sys.stderr)
        return 2
    if cell.chips == 1:
        rows = readings(cell, seeds, ctl, args.seconds,
                        torch.device("cuda", 0))
    else:
        from capital_tpu_torch.parallel import launch

        rows = launch.launch(rank_main, cell.chips, cell, seeds, ctl,
                             args.seconds, device="cuda", timeout=3000)[0]
    worst: dict = {}
    for kind, seed, nums in rows:
        print(json.dumps({"cell": cell.name, "seed": seed, "kind": kind,
                          "numbers": nums}), flush=True)
        for k, v in nums.items():
            if k in ("calls", "call_ms_median"):
                continue
            w = worst.setdefault(k, {"program_max": None, "lower_min": None,
                                     "control_min": None})
            key, pick = (("program_max", max) if kind == "program"
                         else (f"{kind}_min", min))
            w[key] = v if w[key] is None else pick(w[key], v)
    print(json.dumps({"cell": cell.name, "readings": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
