"""Port's precision policy and tile product vs the JAX package.

`tile_dot_plain` (capital_tpu_torch/ops/cuda_dot.py) is the plain version
of the device tile product that the TRMM and SYRK kernels share; it is
held against JAX's `tile_dot` (capital_tpu/ops/pallas_dot.py), which is
plain jnp and runs on the CPU. Inputs come from numpy and go to both.

Tolerances (relative Frobenius):
  highest  1e-6  both are f32 products;
  high     2e-5  JAX's DEFAULT-precision dots on a CPU keep `lo` in f32,
                 the card (and the TPU) round it to bf16, and the plain
                 version follows the card: a few 1e-6 apart at 512 deep;
  default  1e-6  both cast to bf16 explicitly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from capital_tpu.ops import pallas_dot
from capital_tpu_torch.ops import cuda_dot, precision
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=120)

torch.set_num_threads(1)

TOL = {"highest": 1e-6, "high": 2e-5, "default": 1e-6}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("CAPITAL_TRMM_METHOD", "CAPITAL_SYRK_METHOD",
                "CAPITAL_CHOL_METHOD"):
        monkeypatch.delenv(var, raising=False)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_split_f32_is_bitwise_the_jax_split():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 1e3,
        np.array([0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38,
                  1.00390625, 1.01171875, 65504.0], np.float32)])
    hi_j, lo_j = pallas_dot._split_f32(jnp.asarray(x))
    hi_t, lo_t = precision.split_f32(torch.from_numpy(x))
    assert np.array_equal(np.asarray(hi_j).view(np.uint32),
                          hi_t.numpy().view(np.uint32))
    assert np.array_equal(np.asarray(lo_j).view(np.uint32),
                          lo_t.numpy().view(np.uint32))


@pytest.mark.parametrize("p", ["highest", "float32", "high", "bfloat16_3x",
                               "tensorfloat32", "default", "fastest"])
def test_canonicalize_matches_jax(p):
    names = {lax.Precision.HIGHEST: "highest", lax.Precision.HIGH: "high",
             lax.Precision.DEFAULT: "default"}
    assert cuda_dot.canonicalize(p) == names[pallas_dot.canonicalize(p)]
    assert cuda_dot.canonicalize(("default", p)) == names[
        pallas_dot.canonicalize(("default", p))]


@pytest.mark.parametrize("level", ["highest", "high", "default"])
@pytest.mark.parametrize("contract_dim0", [False, True])
def test_tile_dot_plain_matches_jax(level, contract_dim0):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((512, 256) if contract_dim0 else (256, 512))
    b = rng.standard_normal((512, 128))
    a, b = a.astype(np.float32), b.astype(np.float32)
    want = pallas_dot.tile_dot(jnp.asarray(a), jnp.asarray(b),
                               contract_dim0=contract_dim0, prec=level)
    got = cuda_dot.tile_dot_plain(torch.from_numpy(a), torch.from_numpy(b),
                                  contract_dim0=contract_dim0, prec=level)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < TOL[level]


@pytest.mark.parametrize("contract_dim0", [False, True])
def test_tile_dot_plain_bf16_inputs_one_pass(contract_dim0):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((256, 256)).astype(np.float32)
    b = rng.standard_normal((256, 128)).astype(np.float32)
    aj, bj = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    at = torch.from_numpy(a).to(torch.bfloat16)
    bt = torch.from_numpy(b).to(torch.bfloat16)
    want = pallas_dot.tile_dot(aj, bj, contract_dim0=contract_dim0,
                               prec="highest")
    got = cuda_dot.tile_dot_plain(at, bt, contract_dim0=contract_dim0,
                                  prec="highest")
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-6


def test_precision_context_and_default():
    assert precision.prec() == "highest"
    with precision.default_matmul_precision("bfloat16_3x"):
        assert precision.prec() == "high"
        with precision.default_matmul_precision("float32"):
            assert precision.prec() == "highest"
        assert precision.prec() == "high"
    assert precision.prec() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_dot_levels_order_and_bf16_accumulates_in_f32():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((256, 384)).astype(np.float32)
    b = rng.standard_normal((384, 128)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    errs = {}
    for level in ("highest", "high", "default"):
        with precision.default_matmul_precision(level):
            out = precision.dot(at, bt)
        assert out.dtype == torch.float32
        errs[level] = _rel(out.numpy(), exact)
    assert errs["highest"] < 1e-6 < errs["high"] < 1e-4 < errs["default"]
    # bf16 x bf16 runs one pass and returns the f32 accumulation
    ab, bb = at.to(torch.bfloat16), bt.to(torch.bfloat16)
    out = precision.dot(ab, bb)
    assert out.dtype == torch.float32
    ref = ab.double() @ bb.double()
    assert _rel(out.numpy(), ref.numpy()) < 1e-6


def test_dot_general_contracts_the_named_axes():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((64, 32)).astype(np.float32)
    b = rng.standard_normal((48, 64)).astype(np.float32)
    want = np.asarray(lax.dot_general(
        jnp.asarray(a), jnp.asarray(b), (((0,), (1,)), ((), ())),
        precision=lax.Precision.HIGHEST))
    got = precision.dot_general(torch.from_numpy(a), torch.from_numpy(b),
                                (((0,), (1,)), ((), ())))
    assert _rel(got.numpy(), want) < 1e-6


@pytest.mark.parametrize("k", [300, 20000])
def test_bf16_dot_holds_no_f32_copy_of_a_whole_operand(monkeypatch, k):
    """F3: a bf16 x bf16 product converts k-chunks to f32, each chunk's
    two copies within BF16_CHUNK_ELEMS elements however long k is, and
    equals the former product of whole f32 copies to relative Frobenius
    1e-6 (both sum exact bf16 products in f32, in another order)."""
    monkeypatch.setattr(precision, "BF16_CHUNK_ELEMS", 8192)
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((96, k)).astype(
        np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((k, 32)).astype(
        np.float32)).bfloat16()
    copies = []
    real_float = torch.Tensor.float

    def spy(self, *args, **kwargs):
        if self.dtype == torch.bfloat16:
            copies.append(self.numel())
        return real_float(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "float", spy)
    got = precision.dot(a, b)
    gram = precision.dot(b.T, b, precision="highest")  # a Gram, k deep
    monkeypatch.setattr(torch.Tensor, "float", real_float)
    for rows, cols in ((96, 32), (32, 32)):
        assert precision.bf16_chunk(rows, cols, k) * (rows + cols) <= 8192
    assert copies
    pairs = [copies[i] + copies[i + 1] for i in range(0, len(copies), 2)]
    assert max(pairs) <= 8192, max(pairs)
    old = torch.matmul(a.float(), b.float())
    old_gram = torch.matmul(b.float().T, b.float())
    assert got.dtype == gram.dtype == torch.float32
    assert _rel(got.numpy(), old.numpy()) < 1e-6
    assert _rel(gram.numpy(), old_gram.numpy()) < 1e-6
