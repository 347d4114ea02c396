"""The port's host-side storage (capital_tpu_torch.io, .native) against the
JAX package's (capital_tpu.io, .native), and the port's interop readers
for the application layer.

  * packed factors: an .npz written by either package loads in the other,
    bit for bit, and the packed words are the same;
  * block-cyclic export/import: the same panels as the JAX package's;
  * the layout engine: the port's compiled route (its own copy of
    csrc/layout.cpp, built with the host compiler) and its numpy route
    each equal the JAX module's, bit for bit;
  * torch.distributed.checkpoint round trip of a nested dict with a
    DistMatrix leaf, in one process.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from capital_tpu import io as jio
from capital_tpu import native as jnative
from capital_tpu.apps import als as jals
from capital_tpu.apps import rsvd as jrsvd
from capital_tpu_torch import Grid, interop, matrix
from capital_tpu_torch import io as cio
from capital_tpu_torch import native
from capital_tpu_torch.apps import als, rsvd
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=120)

torch.set_num_threads(1)


def _factor(n, upper, seed=0):
    """A triangular factor with no zero in its triangle."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32) + 3.0
    return np.triu(a) if upper else np.tril(a)


@pytest.mark.parametrize("upper", [True, False], ids=["upper", "lower"])
def test_factor_npz_crosses_packages(tmp_path, upper):
    n = 96
    r = _factor(n, upper)
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    cio.save_factor(mine, torch.from_numpy(r), upper=upper,
                    meta={"seed": 3})
    jio.save_factor(theirs, r, upper=upper, meta={"seed": 3})
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    for path in (mine, theirs):
        for load in (cio.load_factor, jio.load_factor):
            dense, meta = load(path)
            np.testing.assert_array_equal(dense, r)
            assert int(meta["seed"]) == 3


def test_block_cyclic_matches_jax():
    rng = np.random.default_rng(1)
    for m, n, pr, pc, bb in ((96, 96, 2, 2, 1), (96, 80, 2, 4, 2),
                             (100, 70, 3, 3, 16), (64, 64, 2, 2, 32)):
        a = rng.standard_normal((m, n)).astype(np.float32)
        panels = cio.export_block_cyclic(torch.from_numpy(a), pr, pc, bb)
        np.testing.assert_array_equal(
            panels, jio.export_block_cyclic(a, pr, pc, bb))
        np.testing.assert_array_equal(
            cio.import_block_cyclic(panels, m, n, pr, pc, bb), a)


@pytest.mark.parametrize("route", ["compiled", "numpy"])
def test_native_routes_match_jax(route):
    """Each of the port's routes against the JAX module's compiled route
    (and its numpy route where the JAX package has no library)."""
    if route == "compiled":
        assert native.available(), "capital_tpu_torch/csrc/layout.cpp " \
            "did not build with the host compiler"
    rng = np.random.default_rng(2)
    a = rng.standard_normal((130, 70)).astype(np.float32)
    sq = a[:70]
    with mock.patch.object(native, "_lib", (lambda: None)
                           if route == "numpy" else native._lib):
        assert native.available() == (route == "compiled")
        for pr, pc, bb in ((2, 2, 1), (2, 4, 2), (3, 3, 16)):
            got = native.block_to_cyclic(a, pr, pc, bb)
            np.testing.assert_array_equal(
                got, jnative.block_to_cyclic(a, pr, pc, bb))
            np.testing.assert_array_equal(
                native.cyclic_to_block(got, 130, 70, pr, pc, bb),
                jnative.cyclic_to_block(got, 130, 70, pr, pc, bb))
        for upper in (True, False):
            packed = native.pack_triangle(sq, upper=upper)
            np.testing.assert_array_equal(
                packed, jnative.pack_triangle(sq, upper=upper))
            np.testing.assert_array_equal(
                native.unpack_triangle(packed, 70, upper=upper),
                jnative.unpack_triangle(packed, 70, upper=upper))
        np.testing.assert_array_equal(native.transpose(a), a.T)
        # the reference's packed offset: (row, col) at col*(col+1)/2 + row
        z = np.zeros((16, 16), np.float32)
        z[2, 5] = 7.0
        assert native.pack_triangle(z)[5 * 6 // 2 + 2] == 7.0
        # shapes the C loops would read past are refused before the call
        for bad in (lambda: native.pack_triangle(a),
                    lambda: native.unpack_triangle(packed[1:], 70),
                    lambda: native.cyclic_to_block(got[1:], 130, 70, 3, 3,
                                                   16)):
            with pytest.raises(ValueError):
                bad()


def test_sharded_round_trip(tmp_path):
    """torch.distributed.checkpoint in one process: a DistMatrix leaf is
    saved as its .data, nested dicts and lists round-trip, and the
    template is left as it was."""
    grid = Grid.square(device="cpu")
    a = matrix.symmetric(grid, 64, 3)
    path = str(tmp_path / "ckpt")
    cio.save_sharded(path, {"a": a, "step": torch.tensor(7, dtype=torch.int32),
                            "opt": {"m": [torch.arange(5.0)]}})
    template = {"a": a.data.clone().zero_(),
                "step": torch.tensor(0, dtype=torch.int32),
                "opt": {"m": [torch.zeros(5)]}}
    out = cio.load_sharded(path, template)
    torch.testing.assert_close(out["a"], a.data, rtol=0, atol=0)
    assert int(out["step"]) == 7
    torch.testing.assert_close(out["opt"]["m"][0], torch.arange(5.0))
    assert int(template["step"]) == 0 and not template["a"].any()
    assert cio.tree_map_distmatrix({"x": [a]})["x"][0] is a.data


def _trees(r, rinv, step):
    return {"tuple": (r, rinv),
            "list": [r],
            "nested": ([r, {"rinv": rinv}], (step,))}


@pytest.mark.parametrize("kind", ["tuple", "list", "nested"])
def test_sharded_round_trip_of_sequences(tmp_path, kind):
    """A tuple, a list and a nested tree round-trip with their containers,
    as any pytree does through the JAX package's orbax checkpoint; a bare
    tensor is refused, as there."""
    grid = Grid.square(device="cpu")
    r = torch.triu(matrix.symmetric(grid, 64, 5).data)
    rinv = torch.tril(matrix.rand(grid, 64, 64, 6).data)
    step = torch.tensor(3, dtype=torch.int32)
    path = str(tmp_path / "ckpt")
    cio.save_sharded(path, _trees(r, rinv, step)[kind])
    zero = _trees(torch.zeros_like(r), torch.zeros_like(rinv),
                  torch.tensor(0, dtype=torch.int32))[kind]
    out = cio.load_sharded(path, zero)
    assert type(out) is type(zero)
    want = _trees(r, rinv, step)[kind]
    flat = lambda t: (sum((flat(v) for v in t.values()), [])  # noqa: E731
                      if isinstance(t, dict) else
                      sum((flat(v) for v in t), [])
                      if isinstance(t, (list, tuple)) else [t])
    assert [type(x) for x in flat(out)] == [type(x) for x in flat(want)]
    for got, ref in zip(flat(out), flat(want)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    if kind == "nested":
        assert isinstance(out[0], list) and isinstance(out[1], tuple)
        assert isinstance(out[0][1], dict)
    with pytest.raises(ValueError, match="bare"):
        cio.save_sharded(str(tmp_path / "bare"), r)


def test_interop_readers():
    """Configs from asdict of the JAX ones, nested fields included;
    SparseRatings from the JAX one's arrays; unknown fields raise."""
    jcfg = jrsvd.Config(k=12, oversample=6, power_iters=2)
    cfg = interop.rsvd_config_from_dict(dataclasses.asdict(jcfg))
    assert (cfg.k, cfg.l, cfg.power_iters, cfg.qr.num_iter) == (12, 18, 2, 2)
    assert isinstance(cfg, rsvd.Config)
    acfg = interop.als_config_from_dict(dataclasses.asdict(
        jals.Config(rank=8, lam=0.5, num_iters=3)))
    assert acfg == als.Config(rank=8, lam=0.5, num_iters=3)
    with pytest.raises(ValueError, match="unknown"):
        interop.als_config_from_dict({"rank": 8, "beta": 1})
    with pytest.raises(ValueError, match="unknown"):
        interop.rsvd_config_from_dict({"k": 8, "qr": {"sweeps": 2}})
    idx = np.arange(6, dtype=np.int32).reshape(3, 2) % 2
    val = np.ones((3, 2), np.float32)
    data = interop.sparse_ratings_from_numpy(idx, val, idx.T, val.T,
                                             device="cpu")
    assert isinstance(data, als.SparseRatings)
    assert data.idx.dtype == data.idx_t.dtype == torch.int64
    assert data.val.dtype == torch.float32
    np.testing.assert_array_equal(data.idx_t.numpy(), idx.T)
