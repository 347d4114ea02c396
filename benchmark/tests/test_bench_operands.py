"""The operand classes (operands/<class>.py): each makes the same
tensors, bit for bit, from the same seeds (checksums recorded from the
generator before its classes became files of their own), and HPL's
general matrix is drawn from its seed, rank by rank."""

import math

import pytest
import torch

from benchmark import traffic

CPU = torch.device("cpu")
MIX = {"loop": "closed", "callers": 1, "pool": 2}


def checksums(x: torch.Tensor) -> tuple:
    """(sum of the values, sum of each value times its flat index), both
    exact (math.fsum of float64 products that are exact) as hex floats."""
    v = x.double().flatten().tolist()
    return (math.fsum(v).hex(),
            math.fsum(a * i for i, a in enumerate(v)).hex())


def test_spd_is_pinned():
    assert checksums(traffic.make("spd", {"n": 96}, 5, CPU)) == (
        "0x1.1e62923528000p+13", "0x1.426a2c5b2cfc4p+25")
    pool = traffic.operands({"operand": "spd", "dtype": "float32",
                             "shape": {}}, dict(MIX, shape={"n": 64}),
                            2**31 + 12345, CPU)
    assert [checksums(a) for a in pool] == [
        ("0x1.02205c0900000p+12", "0x1.0230c21fe16d0p+23"),
        ("0x1.fc27b41ea0000p+11", "0x1.fc387756c9320p+22")]


def test_tall_skinny_is_pinned():
    assert checksums(traffic.make("tall_skinny", {"m": 3000, "n": 24}, 9,
                                  CPU)) == (
        "0x1.7fd2408008600p+5", "0x1.a27e9a96dce5cp+21")
    # rank 2's block of each operand of a pool over 4 ranks
    pool = traffic.operands({"operand": "tall_skinny", "dtype": "float32",
                             "shape": {"n": 24}},
                            dict(MIX, shape={"m": 4000}), 2**31 + 99, CPU,
                            2, 4)
    assert [a.shape for a in pool] == [(1000, 24)] * 2
    assert [checksums(a) for a in pool] == [
        ("-0x1.19f46ee0d5000p+1", "-0x1.134232f13bf78p+19"),
        ("-0x1.e211a89aad800p+3", "-0x1.e71fda8e35574p+16")]


def test_spd_refuses_ranks_and_an_unknown_class_raises():
    with pytest.raises(ValueError):
        traffic.make("spd", {"n": 8}, 1, CPU, rank=0, ranks=4)
    with pytest.raises(FileNotFoundError):
        traffic.make("no_such_class", {"n": 8}, 1, CPU)


def _rand(rows, n, seed):
    return torch.rand((rows, n), generator=torch.Generator().manual_seed(
        seed), dtype=torch.float32)


def test_general_is_the_seeds():
    big = 2**31 + 4242
    a = traffic.make("general", {"n": 64}, big, CPU)
    assert a.shape == (64, 64) and a.dtype == torch.float32
    assert torch.equal(a, traffic.make("general", {"n": 64}, big, CPU))
    assert torch.equal(a, _rand(64, 64, big) - 0.5)
    assert (a >= -0.5).all() and (a < 0.5).all()
    assert not torch.equal(a, traffic.make("general", {"n": 64}, big + 1,
                                           CPU))


def test_general_over_ranks_draws_each_block_from_its_rank():
    cfg = {"operand": "general", "dtype": "float32", "shape": {}}
    mix = dict(MIX, shape={"n": 64})
    seed = 2**31 + 77
    one = traffic.operands(cfg, mix, seed, CPU)
    pools = [traffic.operands(cfg, mix, seed, CPU, r, 4) for r in range(4)]
    scale = torch.linspace(1.0, 2.0, 64)
    for r, pool in enumerate(pools):
        assert [a.shape for a in pool] == [(16, 64)] * 2
        assert not torch.equal(pool[0], pool[1])
        for k, a in enumerate(pool):
            # n / 4 rows from the rank's own generator, as tall_skinny's
            # block is, without its column scale
            draw = _rand(16, 64, traffic.mix(seed, k, r))
            assert torch.equal(a, draw - 0.5)
            ts = traffic.make("tall_skinny", {"m": 64, "n": 64},
                              traffic.mix(seed, k, r), CPU, rank=r,
                              ranks=4)
            assert torch.equal(ts, (draw - 0.5) * scale)
            # not the one-rank matrix cut up: rank 0 shares its seed and
            # so its first rows, the other ranks draw apart
            assert torch.equal(a, one[k][16 * r:16 * (r + 1)]) == (r == 0)
    assert len({tuple(p[0][0, :4].tolist()) for p in pools}) == 4
    with pytest.raises(ValueError):
        traffic.make("general", {"n": 63}, seed, CPU, ranks=4)
