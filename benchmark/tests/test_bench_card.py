"""On the cards: at each cell's own size, on three seeds, both controls
come out not correct by the harness's own comparison (run.result), while
the program's runs come out correct. The controls are the program on its
own path one level below the configuration's precision
(`lower_precision`), and the plain reference put in the program's place
with TF32 products. One-card cells in this process; the four-card cell
in one world of ranks. Each reading is printed (`-s` shows them)."""

import pytest
import torch

from benchmark import calibrate, harness, run, spec

CELLS = spec.benchmark_json()["workloads"]
ONE_CARD = [w["name"] for w in CELLS if w["chips"] == 1]
SEVERAL = [w["name"] for w in CELLS if w["chips"] > 1]
SEEDS = [3 * 10**9 + 11, 3 * 10**9 + 12, 3 * 10**9 + 13]


def _runs(cell, seeds, seconds, device, comm=None) -> list:
    """[(kind, seed, this rank's result)]: the program, the program one
    level below, and the TF32 control's numbers in the program's result."""
    out = []
    for s in seeds:
        r = harness.run(cell, s, seconds, False, device, comm)
        out.append(("program", s, r))
        out.append(("lower", s, harness.run(calibrate.lower(cell), s,
                                            seconds, False, device, comm)))
        out.append(("control", s, dict(r, numbers=calibrate.control_numbers(
            cell, s, device, comm))))
    return out


def _world_runs(cell, seeds, seconds) -> list:
    from capital_tpu_torch.parallel import launch

    return _runs(cell, seeds, seconds, launch.world_device(),
                 harness.WorldComm())


def _judge(cell, kind, seed, ranks) -> None:
    out, lines = run.result(harness.Readings(cell, 0.0, ranks), False)
    print(cell.name, kind, seed, out["correct"], *lines[1:], sep=" | ")
    assert out["correct"] == (kind == "program")


@pytest.mark.card
@pytest.mark.parametrize("name", ONE_CARD)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_and_program_passes(name, seed):
    cell = spec.cell(name)
    for kind, s, r in _runs(cell, [seed], 2.0, torch.device("cuda", 0)):
        _judge(cell, kind, s, [r])


@pytest.mark.card
@pytest.mark.parametrize("name", SEVERAL)
def test_control_fails_across_cards(name):
    from capital_tpu_torch.parallel import launch

    cell = spec.cell(name)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} cards")
    ranks = launch.launch(_world_runs, cell.chips, cell, SEEDS, 3.0,
                          device="cuda", timeout=1800)
    for j, (kind, seed, _) in enumerate(ranks[0]):
        _judge(cell, kind, seed, [rk[j][2] for rk in ranks])
