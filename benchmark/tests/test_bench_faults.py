"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven on the
CPU at a small size, once for each fault a cell can have. An answer
altered where the program produces it (every cell), and the exchange
between ranks left out (the cell on four cards: its Gram all-reduce, on
four gloo ranks). Sound runs of the same come out correct."""

import pytest
import torch

from benchmark import harness, run, spec
from capital_tpu_torch.algs import cacqr, cholinv
from capital_tpu_torch.parallel import collectives, launch
from capital_tpu_torch.parallel.darray import DArray

CPU = torch.device("cpu")
SMALL = {"cholinv.n32768": {"n": 1024}, "cacqr.m2e20": {"m": 8192}, "cacqr.m2e24.ranks4": {"m": 16384}}
SEED = 2**31 + 77


def _small(name):
    cell = spec.cell(name)
    cell.traffic = dict(cell.traffic, shape=SMALL[name])
    if cell.traffic["sample"] != "last":
        cell.traffic["sample"] = {"among": [2, 4]}
    return cell


def _correct(cell, ranks):
    out, lines = run.result(harness.Readings(cell, 1.0, ranks), False)
    assert len(lines) == 1 + len(cell.limits)
    return out["correct"]


def _altered_factor(grid, a, cfg=cholinv.Config()):
    r, rinv = _FACTOR(grid, a, cfg)
    r[0] *= 1.01
    return r, rinv


def _altered_factor_1d(grid, a, cfg=cacqr.Config(), **kw):
    q, r = _FACTOR_1D(grid, a, cfg, **kw)
    (q.local if isinstance(q, DArray) else q)[0] *= 1.01
    return q, r


_FACTOR, _FACTOR_1D = cholinv.factor, cacqr.factor_1d


def _no_exchange(x, mesh, axes, **kw):
    return x


def _rank(cell, fault):
    if fault == "altered":
        cacqr.factor_1d = _altered_factor_1d
    elif fault == "no_exchange":
        collectives.psum = _no_exchange
    return harness.rank_main(cell, SEED, 0.5, False)


@pytest.mark.parametrize("name", ["cholinv.n32768", "cacqr.m2e20"])
def test_an_altered_answer_is_not_correct(name, monkeypatch):
    cell = _small(name)
    assert _correct(cell, [harness.run(cell, SEED, 0.5, False, CPU)])
    monkeypatch.setattr(cholinv, "factor", _altered_factor)
    monkeypatch.setattr(cacqr, "factor_1d", _altered_factor_1d)
    assert not _correct(cell, [harness.run(cell, SEED, 0.5, False, CPU)])


@pytest.mark.parametrize("fault", [None, "altered", "no_exchange"])
def test_four_ranks_faults(fault):
    cell = _small("cacqr.m2e24.ranks4")
    ranks = launch.launch(_rank, 4, cell, fault, device="cpu", threads=1,
                          timeout=600)
    assert _correct(cell, ranks) == (fault is None)
