"""The plain references against NumPy in float64 at tiny sizes, the TF32
rounding of the control, and the generator's operands."""

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.reference import cacqr_factor_1d, cholinv_factor, plain

CPU = torch.device("cpu")


def test_tf32_rounds_to_ten_mantissa_bits_ties_to_even():
    one = 1.0
    ulp = 2.0**-10
    x = torch.tensor([one, one + ulp, one + ulp / 2, one + 3 * ulp / 2,
                      one + ulp / 4, -(one + 3 * ulp / 2), 3.0e-30],
                     dtype=torch.float32)
    got = plain.tf32(x).tolist()
    assert got[:6] == [one, one + ulp, one, one + 2 * ulp, one,
                       -(one + 2 * ulp)]
    assert abs(got[6] - 3.0e-30) <= 3.0e-30 * 2**-11
    r = plain.tf32(torch.randn(1000))
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()


def test_cholinv_reference_matches_numpy():
    a = traffic.make("spd", {"n": 96}, 5, CPU)
    r, ri = cholinv_factor.factor(a, leaf=16)
    a64 = a.double().numpy()
    r_np = np.linalg.cholesky(a64).T
    np.testing.assert_allclose(r.numpy(), r_np, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ri.numpy(), np.linalg.inv(r_np), rtol=0,
                               atol=1e-13)
    assert torch.equal(r, torch.triu(r)) and torch.equal(ri, torch.triu(ri))


def _qr_np(a64):
    q, r = np.linalg.qr(a64)
    s = np.sign(np.diag(r))
    return q * s, r * s[:, None]


def test_cacqr_reference_matches_numpy():
    a = traffic.make("tall_skinny", {"m": 3000, "n": 24}, 9, CPU)
    q_np, r_np = _qr_np(a.double().numpy())
    r_ref, r1inv, r2inv = cacqr_factor_1d._factors(
        a, torch.float64, False, plain.OneDevice())
    np.testing.assert_allclose(r_ref.numpy(), r_np, rtol=0, atol=1e-11)
    q = (a.double() @ (r1inv @ r2inv)).numpy()
    np.testing.assert_allclose(q, q_np, rtol=0, atol=1e-13)
    # the check reads an exact answer as exact, to f32 rounding
    nums = cacqr_factor_1d.check(
        a, {"Q": torch.from_numpy(q_np).float(),
            "R": torch.from_numpy(r_np).float()}, {})
    assert nums["q_err"] < 1e-7 and nums["r_err"] < 1e-7


def test_blocks_of_the_reference_cover_every_row(monkeypatch):
    monkeypatch.setattr(cacqr_factor_1d, "ROWS", 7)
    monkeypatch.setattr(plain, "ROWS", 5)
    a = traffic.make("tall_skinny", {"m": 50, "n": 6}, 2, CPU)
    q_np, r_np = _qr_np(a.double().numpy())
    nums = cacqr_factor_1d.check(
        a, {"Q": torch.from_numpy(q_np).float(),
            "R": torch.from_numpy(r_np).float()}, {})
    assert nums["q_err"] < 1e-7 and nums["r_err"] < 1e-7
    bad = q_np.copy()
    bad[49] *= 2  # the last block's last row
    assert cacqr_factor_1d.check(
        a, {"Q": torch.from_numpy(bad).float(),
            "R": torch.from_numpy(r_np).float()}, {})["q_err"] > 1e-2


@pytest.mark.parametrize("entry,config,operand", [
    (cholinv_factor, {"settings": {"bc": 32}},
     lambda: traffic.make("spd", {"n": 256}, 3, CPU)),
    (cacqr_factor_1d, {},
     lambda: traffic.make("tall_skinny", {"m": 4096, "n": 64}, 3, CPU)),
])
def test_the_control_reads_far_above_float32(entry, config, operand):
    a = operand()
    ctl = entry.check(a, entry.control(a, config), config)
    if entry is cholinv_factor:
        r, ri = entry.factor(a, 32, torch.float32)
        f32 = entry.check(a, {"R": r, "Rinv": ri}, config)
    else:
        f32 = cacqr_factor_1d.check(a, _f32_qr2(a), config)
    for k in f32:
        assert ctl[k] > 10 * f32[k], (k, ctl[k], f32[k])


def _f32_qr2(a):
    r, r1inv, r2inv = cacqr_factor_1d._factors(a, torch.float32, False,
                                               plain.OneDevice())
    return {"Q": a @ r1inv @ r2inv, "R": r}


def test_operands_are_the_seeds():
    cfg = {"operand": "spd", "dtype": "float32", "shape": {}}
    mix = {"loop": "closed", "callers": 1, "pool": 2, "shape": {"n": 64}}
    big = 2**31 + 12345
    p1 = traffic.operands(cfg, mix, big, CPU)
    p2 = traffic.operands(cfg, mix, big, CPU)
    assert all(torch.equal(x, y) for x, y in zip(p1, p2))
    assert not torch.equal(p1[0], p1[1])
    assert not torch.equal(p1[0], traffic.operands(cfg, mix, big + 1,
                                                   CPU)[0])
    a = p1[0]
    assert torch.equal(a, a.T)
    assert torch.linalg.eigvalsh(a.double()).min() > 0
    ts = {"operand": "tall_skinny", "dtype": "float32", "shape": {"n": 8}}
    rows = [traffic.operands(ts, dict(mix, shape={"m": 40}), 7, CPU, r, 4)[0]
            for r in range(4)]
    assert all(x.shape == (10, 8) for x in rows)
    assert not torch.equal(rows[0], rows[1])
    scale = torch.linspace(1.0, 2.0, 8)
    assert ((rows[0] / scale).abs() <= 0.5).all()


def test_sample_index_is_drawn_from_the_seed():
    mix = {"sample": {"among": [2, 64]}}
    got = {traffic.sample_index(mix, s) for s in range(200)}
    assert got <= set(range(2, 64)) and len(got) > 30
    assert traffic.sample_index(mix, 17) == traffic.sample_index(mix, 17)
    assert traffic.sample_index({"sample": "last"}, 17) is None
