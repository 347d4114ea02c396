"""The bytes the port's distributed arrays move: one 8-rank gloo world
(tests/torch_mesh_ranks.py) counts what rank 0 receives through every
call of parallel/collectives.py (all_gather (k - 1) x the input,
all_reduce the tensor, reduce_scatter (k - 1) / k x the input, ppermute
the received tensor, all_to_all the pieces from other ranks).

darray.window, set_window and take_rows are held bitwise to the
gather-then-narrow functions they replaced, on the 2 x 2 slice and the
2 x 2 x 2 grid (a permuted rank table among them) over windows that are
whole, interior, across block edges, inside one block and at each end;
each window call receives at most element_size (h / k0) (w + w / k1)
bytes. cholinv (min_bc 128, the XLA leaf, shard_map) and LU (nb 128) at
n = 1024 and 2048 stay under the byte bounds below, with R, Rinv and the
LU workspace bitwise equal to the same run with the gathering functions
patched in, and the cost records unchanged."""

import pytest

import torch_mesh_ranks as R

MIB = 1 << 20
# bytes rank 0 receives, MiB (the gathering functions moved 84.8, 609.6,
# 83.1, 602.1, 98.6 and 774.2)
BOUNDS = {"cholinv 2x2 1024": 28, "cholinv 2x2 2048": 120,
          "cholinv 2x2x2 1024": 26, "cholinv 2x2x2 2048": 110,
          "lu 2x2 1024": 40, "lu 2x2 2048": 260}


@pytest.fixture(scope="module")
def port():
    return R.world_with(R.volume_world, R.volume_operands())


def test_window_set_window_take_rows_bitwise_within_bound(port):
    fails = [f for r in port["ranks"] for f in r["fails"]
             if not f.startswith("ppermute")]
    assert not fails, fails[:10]
    rows = port["windows"]
    kinds = {r[0] for r in rows}
    assert {"window", "take_rows", "set_window v=same",
            "set_window v=tensor"} <= kinds
    assert len([r for r in rows if r[0] == "window"]) == \
        len(R.VOL_SPECS) * len(R.VOL_WINDOWS)
    # the whole-array window over the 2 x 2 slice moves nothing; one that
    # rank 0's block of the window takes from rank 3's block of x moves
    # less than the gathering window did
    moved = {(r[0], r[1], r[2]): (r[3], r[4]) for r in rows}
    assert moved[("window", "2x2", (0, 0, 64, 64))][0] == 0
    new, old = moved[("window", "2x2", (34, 36, 8, 8))]
    assert 0 < new < old


def test_ppermute_takes_a_transposed_operand(port):
    got = port["ppermute"]
    assert "contiguous" in got["before"]
    assert got["equal"] and got["contiguous"]


@pytest.mark.parametrize("alg", ["cholinv", "lu"])
def test_bytes_under_bounds(port, alg):
    for key, bound in BOUNDS.items():
        if not key.startswith(alg):
            continue
        run = port["runs"][key]
        assert run["bytes"] <= bound * MIB, (key, run["bytes"] / MIB,
                                             run["by"])
        assert run["bytes"] < run["gathered_bytes"]
        print(key, "MiB", run["bytes"] / MIB, "gathering",
              run["gathered_bytes"] / MIB, "records",
              run["record_bytes"] / MIB)


def test_results_and_costs_unchanged(port):
    for r in port["ranks"]:
        assert all(r["same"].values()), r["same"]
    for key, run in port["runs"].items():
        assert run["costs_equal"], key


def test_set_window_callers_of_another_spec(port):
    """Which algorithms hand set_window a v laid out otherwise than its
    target (the branch that lays v out as x's first): one answer on every
    rank."""
    callers = {tuple(r["other_spec_callers"]) for r in port["ranks"]}
    assert len(callers) == 1
    print("set_window with a v of another spec:", sorted(callers.pop()))
