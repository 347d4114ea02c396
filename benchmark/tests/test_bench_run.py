"""run.py refuses to run where the cards are not there, and where the
program is not there: it exits with another code than 0 and prints no
result, never falling back to the CPU."""

import shutil
import subprocess
import sys

import pytest

from benchmark import spec

ARGS = ["--seed", "3000000001", "--seconds", "1", "--trace", "0"]


def _run(cwd, workload):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, *ARGS],
        cwd=cwd, capture_output=True, text=True, timeout=300)


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: this checks the refusal without one")


@pytest.mark.parametrize("workload", ["cholinv.n32768", "cacqr.m2e24.ranks4"])
def test_no_card_no_result(no_card, workload):
    p = _run(spec.ROOT, workload)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, "cholinv.n32768")
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_unknown_workload_no_result():
    p = _run(spec.ROOT, "no.such.cell")
    assert p.returncode != 0 and p.stdout.strip() == ""
