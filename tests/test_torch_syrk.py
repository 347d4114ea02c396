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

from capital_tpu.ops.pallas_dot import _split_f32
from capital_tpu.ops.pallas_syrk import syrk_upper as syrk_jax
from capital_tpu_torch.ops import cuda_syrk, cuda_trmm

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


def _split_cases(shape):
    """Values whose low 16 bits sit on a rounding tie (with an even and an
    odd bit 16), +-0, the largest finite value, subnormals, and random
    values of both signs."""
    bits = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000,
                     0x00000000, 0x80000000, 0x7F7FFFFF, 0xFF7FFFFF,
                     0x00000001, 0x80008000, 0x3F800001, 0x3F807FFF],
                    dtype=np.uint32)
    x = _data(4, shape)
    x.flat[:bits.size] = bits.view(np.float32)
    return x


@pytest.mark.parametrize("fn", ["split_pack_plain", "split_pack"])
@pytest.mark.parametrize("level", ["high", "default"])
@pytest.mark.parametrize("shape", [(64, 128), (100, 70)])
def test_split_pack_matches_jax_split_f32(shape, level, fn):
    """The split pass's plain version, and the wrapper's CPU route: hi[c, k]
    is _split_f32's hi of A[k, c] bit for bit (RNE on the bit pattern), lo
    at 'high' is bf16(x - hi), and the padding up to (128, 64) multiples is
    zero."""
    x = _split_cases(shape)
    hi, lo = getattr(cuda_syrk, fn)(torch.from_numpy(x), level)
    m, n = shape
    n_pad, m_pad = cuda_syrk.split_shape(m, n)
    assert hi.shape == (n_pad, m_pad) and hi.dtype == torch.bfloat16
    want_hi, want_lo = (np.asarray(v) for v in _split_f32(jnp.asarray(x)))
    got_hi = hi[:n, :m].float().numpy().T
    assert np.array_equal(got_hi.view(np.uint32), want_hi.view(np.uint32))
    assert not hi[n:].float().any() and not hi[:, m:].float().any()
    if level == "default":
        assert lo is None
        return
    # lo = x - hi in IEEE f32; XLA's CPU flushes the subnormal differences
    # to zero, the card and torch keep them (one entry here)
    sub = np.abs(x - want_hi) < np.finfo(np.float32).tiny
    assert np.array_equal(want_lo[~sub], (x - want_hi)[~sub])
    want_lo = torch.from_numpy(x - want_hi).bfloat16().float().numpy()
    got_lo = lo[:n, :m].float().numpy().T
    assert np.array_equal(got_lo.view(np.uint32), want_lo.view(np.uint32))
    assert not lo[n:].float().any() and not lo[:, m:].float().any()


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
