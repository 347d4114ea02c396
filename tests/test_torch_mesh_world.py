"""The 8-rank world the mesh tests share (tests/torch_mesh_ranks.py): one
world a test process, each task run as on a fresh world.

  * two different world functions run one after the other on the shared
    world give bitwise what each gives on a world started for it (all
    but the draws of torch's global generator, whose seed is each
    process's own);
  * a task that leaves a CAPITAL_* switch, a precision context, a
    tracer, torch's dtype, seed and threads, launch's world device,
    kernel counts and a grid's process groups behind leaves none of it to
    the next task, which reads the start state of a fresh world and
    draws what the task before the leak drew;
  * a task that runs past its time limit fails within the limit plus
    30 s, naming the calling module and the ranks still running, and the
    next task starts a new world;
  * a test that runs past its own time limit (pytest.mark.time_limit)
    fails at it, named, and the tests after it run.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import torch_mesh_ranks as R
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(150, setup=180)
STALL_LIMIT = 5.0


def _same(got, want, where="result"):
    """Bitwise equality through dicts, lists and numpy arrays."""
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), where
    else:
        assert got == want, (where, got, want)


def _seeded(res: dict) -> dict:
    return {k: v for k, v in res.items() if k != "global_draws"}


@pytest.fixture(scope="module")
def fresh():
    """Each function on a world started for it."""
    return {fn.__name__: R.world(fn, fresh=True)
            for fn in (R.draw_world, R.gemm_world)}


def test_shared_world_is_bitwise_a_fresh_one(fresh):
    shared = {fn.__name__: R.world(fn) for fn in (R.draw_world,
                                                  R.gemm_world)}
    for name in fresh:
        _same(_seeded(shared[name]), _seeded(fresh[name]), name)
    state = fresh["draw_world"]["state"]
    assert state["env"] == [] and state["precision"] is None
    assert not state["tracer"] and state["groups"] == 1
    assert state["meshes"] == 0 and state["orders"] == 0


def test_a_task_leaves_nothing_behind(fresh):
    before = R.world(R.draw_world)
    starts = R.World.starts
    leaked = R.world(R.leak_world)
    assert leaked["ranks"] == list(range(R.RANKS))
    after = R.world(R.draw_world)
    assert R.World.starts == starts  # the same world ran all three
    _same(after, before, "draw_world after leak_world")
    _same(_seeded(after), _seeded(fresh["draw_world"]),
          "draw_world after leak_world, fresh")


def test_a_stalled_task_fails_in_its_limit_naming_the_ranks():
    R.world(R.gemm_world)  # the world is up before the clock starts
    starts = R.World.starts
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as exc:
        R.world(R.stall_world, 3, limit=STALL_LIMIT)
    took = time.monotonic() - t0
    assert STALL_LIMIT <= took < STALL_LIMIT + 30, took
    msg = str(exc.value)
    assert "test_torch_mesh_world" in msg and "stall_world" in msg, msg
    assert "ranks still running: [3]" in msg, msg
    after = R.world(R.gemm_world)
    assert [r["rank"] for r in after["ranks"]] == list(range(R.RANKS))
    assert R.World.starts == starts + 1


SLOW_FILE = """
import time

import pytest

from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(2, setup=10)


def test_sleeps_past_its_limit():
    time.sleep(120)


def test_after_it():
    pass
"""


def test_a_test_past_its_limit_fails_named(tmp_path):
    (tmp_path / "test_slow.py").write_text(SLOW_FILE)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "CAPITAL_"))}
    env["PYTHONPATH"] = str(Path(R.__file__).parent)
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-m", "pytest", "-q",
                          "-p", "no:cacheprovider", "test_slow.py"],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    took = time.monotonic() - t0
    text = out.stdout + out.stderr
    assert out.returncode == 1, text
    assert "1 failed, 1 passed" in text, text
    assert "test_sleeps_past_its_limit ran past its time limit of 2 s" in text
    assert took < 2 + 30 + 15, took  # the limit, the grace, start-up
