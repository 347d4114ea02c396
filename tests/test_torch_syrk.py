"""Port's triangle Gram kernel (plain version of csrc/syrk_upper.cu) vs the
JAX Pallas kernel in interpret mode, on the same small schedule
(t = mc = 128), including a window and a contraction long enough for the
two-level fold to fire (more than 32 row chunks).

Tolerances are the tile_dot ones: relative Frobenius 1e-6 at
highest/default, 2e-5 at high. The port's G is bitwise symmetric.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.ops.pallas_syrk import syrk_upper as syrk_jax
from capital_tpu_torch.ops import cuda_syrk, cuda_trmm
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


def _data(seed, shape):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(
        np.float32)


@pytest.mark.parametrize("level", ["highest", "high", "default"])
@pytest.mark.parametrize("m", [512, 33 * 128])  # the second folds once
def test_syrk_plain_matches_jax_kernel(m, level):
    a = _data(0, (m, 256))
    want = syrk_jax(jnp.asarray(a), interpret=True, t=128, mc=128,
                    matmul_precision=level)
    got = cuda_syrk.syrk_upper_plain(torch.from_numpy(a), prec=level, t=128,
                                     mc=128)
    assert got.dtype == torch.float32
    assert torch.equal(got, got.T)
    assert _rel(got.numpy(), want) < TOL[level]


def test_syrk_window_matches_jax_kernel():
    big = _data(1, (640, 512))
    aw = (128, 128, 384, 256)
    want = syrk_jax(jnp.asarray(big), interpret=True, t=128, mc=128,
                    a_window=aw)
    view = cuda_trmm.window(torch.from_numpy(big), aw)
    got = cuda_syrk.syrk_upper_plain(view, t=128, mc=128)
    assert torch.equal(got, got.T)
    assert _rel(got.numpy(), want) < TOL["highest"]
    # the wrapper reads the same window in place, on its own schedule
    assert torch.equal(cuda_syrk.syrk_upper(torch.from_numpy(big),
                                            a_window=aw),
                       cuda_syrk.syrk_upper_plain(view))


def test_syrk_fold_changes_the_summation_order():
    """The fold is part of the schedule: on a contraction of 33 chunks the
    plain version's result differs (in the last bits) from one long sum,
    and the JAX kernel's folded sum is the one it matches bitwise-closely."""
    a = _data(2, (33 * 128, 128)) * 1e3
    folded = cuda_syrk.syrk_upper_plain(torch.from_numpy(a), t=128, mc=128)
    long_sum = cuda_syrk.syrk_upper_plain(torch.from_numpy(a), t=128,
                                          mc=33 * 128)
    want = np.asarray(syrk_jax(jnp.asarray(a), interpret=True, t=128,
                               mc=128))
    assert not torch.equal(folded, long_sum)
    assert _rel(folded.numpy(), want) <= _rel(long_sum.numpy(), want)


def test_syrk_ragged_and_bf16():
    a = _data(3, (300, 200))
    got = cuda_syrk.syrk_upper(torch.from_numpy(a))
    want = a.astype(np.float64).T @ a
    assert torch.equal(got, got.T)
    assert _rel(got.numpy(), want) < 1e-6
    ab = torch.from_numpy(a).bfloat16()
    gb = cuda_syrk.syrk_upper(ab, out_dtype=torch.bfloat16)
    assert gb.dtype == torch.bfloat16 and torch.equal(gb, gb.T)
    ref = ab.double().T @ ab.double()
    assert _rel(gb.float().numpy(), ref.numpy()) < 1e-2


@pytest.mark.parametrize("level", ["highest", "high", "default"])
@pytest.mark.parametrize("shape,aw", [((640, 512), (128, 128, 384, 256)),
                                      ((700, 333), (3, 5, 601, 201))])
def test_syrk_wrapper_cpu_route(shape, aw, level):
    """On a CPU tensor the wrapper is the plain version on the window it
    reads in place, at every level, on an aligned and a ragged window."""
    big = torch.from_numpy(_data(5, shape))
    got = cuda_syrk.syrk_upper(big, a_window=aw, matmul_precision=level)
    want = cuda_syrk.syrk_upper_plain(cuda_trmm.window(big, aw), prec=level)
    assert torch.equal(got, want) and torch.equal(got, got.T)
