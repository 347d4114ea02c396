"""The pack pass of the Hopper product kernels (plain version of
csrc/hopper_mma.cuh::pack_kernel, ops/cuda_pack.py) against the JAX
package's split (capital_tpu/ops/pallas_dot.py::_split_f32), in both
source orientations, with TRMM's triangle mask and the zero padding of a
ragged window; and the four TRMM cases computed from the packs that
csrc/trmm_upper.cu writes, against the Pallas kernel in interpret mode.

The pack is exact (bitwise); the products from the packs are held at the
tile_dot tolerances (tests/test_torch_dot.py): relative Frobenius 1e-6 at
highest/default, 2e-5 at high.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu.ops.pallas_dot import _split_f32
from capital_tpu.ops.pallas_trmm import trmm_upper as trmm_jax
from capital_tpu_torch.ops import cuda_pack, cuda_trmm

torch.set_num_threads(1)

TOL = {"highest": 1e-6, "high": 2e-5, "default": 1e-6}
CASES = [("L", False), ("L", True), ("R", False), ("R", True)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _split_cases(shape, seed=0):
    """Values whose low 16 bits sit on a rounding tie (with an even and an
    odd bit 16), +-0, the largest finite value, subnormals, and random
    values of both signs, spread over the array so that both triangles
    hold some."""
    bits = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000,
                     0x00000000, 0x80000000, 0x7F7FFFFF, 0xFF7FFFFF,
                     0x00000001, 0x80008000, 0x3F800001, 0x3F807FFF],
                    dtype=np.uint32)
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(
        np.float32)
    flat = x.reshape(-1)
    idx = np.linspace(0, flat.size - 1, bits.size).astype(int)
    flat[idx] = bits.view(np.float32)
    return x


def _operand(x, along_rows, upper):
    """X (o x k) as the pack reads it from x."""
    v = np.triu(x) if upper else x
    return v.T if along_rows else v


def _bits(v):
    return np.ascontiguousarray(v, np.float32).view(np.uint32)


def _want(xo, level):
    """(hi, lo) the pack holds for X = xo, as f32 arrays (lo None where the
    level has none): _split_f32's hi and bf16(x - hi) at 'high', bf16(x)
    at 'default', x itself at 'highest'."""
    if level == "highest":
        return xo, None
    if level == "default":
        return torch.from_numpy(xo).bfloat16().float().numpy(), None
    hi = np.asarray(_split_f32(jnp.asarray(xo))[0])
    return hi, torch.from_numpy(xo - hi).bfloat16().float().numpy()


def _check_pack(got, xo, level):
    """got: (hi, lo) of pack_plain or pack; X = xo in the padded layout of
    the level, bit for bit, and zeros in the padding."""
    o, k = xo.shape
    o_pad, k_pad = cuda_pack.pack_shape(o, k)
    want = _want(xo, level)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        if level == "highest":
            assert g.dtype == torch.float32 and g.shape == (k_pad, o_pad)
            g = g.T
        else:
            assert g.dtype == torch.bfloat16 and g.shape == (o_pad, k_pad)
        g = g.float().numpy()
        assert np.array_equal(_bits(g[:o, :k]), _bits(w))
        assert not np.any(g[o:]) and not np.any(g[:, k:])


@pytest.mark.parametrize("fn", ["pack_plain", "pack"])
@pytest.mark.parametrize("level", ["high", "default"])
@pytest.mark.parametrize("along_rows", [True, False])
@pytest.mark.parametrize("shape", [(64, 128), (100, 70)])
def test_pack_matches_jax_split_f32(shape, along_rows, level, fn):
    """hi[o, k] is _split_f32's hi of X[o, k] bit for bit (RNE on the bit
    pattern), lo at 'high' is bf16(x - hi), and the padding up to (128, 64)
    multiples is zero, whichever way the source holds X (along its rows:
    SYRK's split pass), in the plain version and the wrapper's CPU
    route."""
    x = _split_cases(shape)
    got = getattr(cuda_pack, fn)(torch.from_numpy(x), level,
                                 along_rows=along_rows)
    _check_pack(got, _operand(x, along_rows, False), level)


@pytest.mark.parametrize("fn", ["pack_plain", "pack"])
@pytest.mark.parametrize("level", ["highest", "high", "default"])
@pytest.mark.parametrize("along_rows", [True, False])
def test_pack_masks_the_lower_triangle_of_a_ragged_window(along_rows, level,
                                                          fn):
    """U read from a ragged window at an unaligned offset of a larger array
    with 1e6 below its diagonal: the pack (the plain version, and the
    wrapper's CPU route) holds triu(U) bit for bit in the padded layout of
    its level, zeros below the diagonal and in the padding."""
    big = _split_cases((300, 310), seed=1)
    big += 1e6 * np.tril(np.ones_like(big), -1)
    u = torch.from_numpy(big)[7:207, 7:207]  # n = 200, no multiple of 128
    got = getattr(cuda_pack, fn)(u, level, along_rows=along_rows, upper=True)
    below = np.tril(np.ones(u.shape, bool), -1)
    assert np.all(np.abs(u.numpy()[below]) >= 1e5)  # what the mask hides
    xo = _operand(np.ascontiguousarray(u.numpy()), along_rows, True)
    _check_pack(got, np.ascontiguousarray(xo), level)


def _kernel_packs(u, b, side, trans_a, level):
    """The two packs csrc/trmm_upper.cu::run writes, as f32 (o_pad, k_pad)
    values (hi + lo at 'high'): A is U (side L; along U's rows for U^T) or
    B (side R); B is B (side L, along its rows) or U (side R; along U's
    columns for U^T)."""
    def packed(x, along_rows, upper):
        hi, lo = cuda_pack.pack_plain(x, level, along_rows=along_rows,
                                      upper=upper)
        if hi.dtype == torch.float32:
            return hi.T
        hi = hi.float()
        return hi if lo is None else (hi, lo.float())

    if side == "L":
        return packed(u, trans_a, True), packed(b, True, False)
    return packed(b, False, False), packed(u, not trans_a, True)


@pytest.mark.parametrize("level", ["highest", "high", "default"])
@pytest.mark.parametrize("side,trans_a", CASES)
@pytest.mark.parametrize("n,m", [(256, 128), (200, 72)])
def test_trmm_from_kernel_packs_matches_jax_kernel(n, m, side, trans_a,
                                                   level):
    """The packs in the kernel's orientation per case, multiplied over
    the k run of each output tile as the product kernels do (every 128
    rows summed on its own), give trmm_upper_plain's TRMM and, on the
    tile-aligned shape, the Pallas kernel's. n = 200 and m = 72 are
    ragged, so the zero padding is part of the product (the JAX package
    runs ragged shapes as a masked f32 dot on the CPU, whatever the
    level, so there the plain version is the reference)."""
    rng = np.random.default_rng(3)
    u = rng.uniform(-1.0, 1.0, (n, n)).astype(np.float32)
    b = rng.uniform(-1.0, 1.0, (n, m) if side == "L" else (m, n)).astype(
        np.float32)
    u_t, b_t = torch.from_numpy(u), torch.from_numpy(b)
    pa, pb = _kernel_packs(u_t, b_t, side, trans_a, level)

    def prod(x, y):  # x (tile rows, k), y (tile cols, k) -> x @ y^T
        if isinstance(x, tuple):
            return x[0] @ y[0].T + (x[0] @ y[1].T + x[1] @ y[0].T)
        return x @ y.T

    def rows(p, lo, hi, k0, k1):
        return tuple(q[lo:hi, k0:k1] for q in p) if isinstance(p, tuple) \
            else p[lo:hi, k0:k1]

    big_m, big_n = (n, m) if side == "L" else (m, n)
    out = torch.zeros((-(-big_m // 128) * 128, -(-big_n // 128) * 128))
    rule = 2 * (side == "R") + trans_a
    for i0 in range(0, big_m, 128):
        for j0 in range(0, big_n, 128):
            klo = i0 if rule == 0 else j0 if rule == 3 else 0
            khi = (min(n, i0 + 128) if rule == 1 else
                   min(n, j0 + 128) if rule == 2 else n)
            acc = torch.zeros((128, 128))
            for k0 in range(klo, khi, 128):
                acc += prod(rows(pa, i0, i0 + 128, k0, k0 + 128),
                            rows(pb, j0, j0 + 128, k0, k0 + 128))
            out[i0:i0 + 128, j0:j0 + 128] = acc
    got = out[:big_m, :big_n]
    want = cuda_trmm.trmm_upper_plain(u_t, b_t, side=side, trans_a=trans_a,
                                      prec=level)
    assert _rel(got.numpy(), want.numpy()) < TOL[level]
    if n % 128 == 0 and m % 128 == 0:
        want = trmm_jax(jnp.asarray(u), jnp.asarray(b), side=side,
                        trans_a=trans_a, interpret=True, t=128, mc=128,
                        matmul_precision=level)
        assert _rel(got.numpy(), want) < TOL[level]


@pytest.mark.parametrize("level", ["highest", "high", "default"])
@pytest.mark.parametrize("side", ["L", "R"])
def test_trmm_scratch_is_the_two_packs(side, level):
    """The wrapper's scratch holds the kernel's two packs exactly."""
    n, m = 200, 333
    u = torch.zeros((n, n))
    b = torch.zeros((n, m) if side == "L" else (m, n))
    sizes = []
    for x, along_rows, upper in ((u, side == "L", True),
                                 (b, side == "L", False)):
        hi, lo = cuda_pack.pack_plain(x, level, along_rows=along_rows,
                                      upper=upper)
        sizes.append(sum(p.numel() * p.element_size()
                         for p in (hi, lo) if p is not None))
    assert cuda_trmm.scratch_bytes(n, m, level, torch.float32) == sum(sizes)
