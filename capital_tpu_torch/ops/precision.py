"""Matmul precision policy (counterpart of capital_tpu/ops/precision.py).

Three levels, named as `jax.default_matmul_precision` names them:

  * 'highest' - f32-faithful. Plain products are f32 matmuls with TF32 off;
    the hand-written kernels use f32 FFMA. This is the framework default.
  * 'high'    - each f32 operand is split into hi = RNE bf16(x) and
    lo = bf16(x - hi); the product is hi*hi + hi*lo + lo*hi with f32
    accumulation (lo*lo dropped), the reference's 3-pass lowering.
  * 'default' - one bf16 pass.

A bf16 x bf16 product always runs one pass: every product of two bf16
values is exact in f32, so extra passes re-derive the same answer.

TF32 is switched off here for both matmuls and convolutions: it keeps 10
mantissa bits, coarser than the bf16 hi/lo split of 'high'.

Plain products at 'high'/'default' never call `torch.matmul` on bf16
tensors (that returns bf16 and drops the f32 accumulation). The operands
are rounded onto the bf16 grid and multiplied in f32 instead; a product of
two bf16-grid values is exact in f32, so this is the tensor cores'
bf16-in / f32-accumulate arithmetic.

A product of two bf16 tensors makes no f32 copy of either whole operand
(bf16_dot): it is contracted in k-chunks whose f32 copies hold at most
BF16_CHUNK_ELEMS elements, each chunk's f32 product added into the f32
result. The card's bf16-in / f32-out product (`torch.mm(...,
out_dtype=torch.float32)`) is not used: on an H100 its 2^22-deep Gram of
a bf16 2^22 x 1024 operand lay 6.2e-3 (relative Frobenius) from the SYRK
kernel's, whose f32 sum takes the tensor cores' partial sums every 128
rows (PERF.md, F3).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HIGHEST, HIGH, DEFAULT = "highest", "high", "default"

_ALIASES = {
    "default": DEFAULT,
    "fastest": DEFAULT,
    "bfloat16": DEFAULT,
    "high": HIGH,
    "bfloat16_3x": HIGH,
    "tensorfloat32": HIGH,
    "highest": HIGHEST,
    "float32": HIGHEST,
}
_RANK = {DEFAULT: 0, HIGH: 1, HIGHEST: 2}

# the user's explicit setting (None = framework default, HIGHEST)
_active: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "capital_matmul_precision", default=None)


def canonicalize(p) -> str:
    """Map the names `jax.default_matmul_precision` accepts (or an
    (lhs, rhs) pair, taking the stricter) onto 'highest'|'high'|'default'."""
    if isinstance(p, (tuple, list)):
        return max((canonicalize(x) for x in p), key=_RANK.__getitem__)
    return _ALIASES[str(p).lower()]


def prec() -> str:
    """Active precision: the user's explicit setting if any, else HIGHEST."""
    v = _active.get()
    return HIGHEST if v is None else v


@contextlib.contextmanager
def default_matmul_precision(p: str):
    """Counterpart of `jax.default_matmul_precision(p)`."""
    tok = _active.set(canonicalize(p))
    try:
        yield
    finally:
        _active.reset(tok)


def acc_dtype(*xs) -> torch.dtype:
    """f64 stays f64; everything else accumulates in f32."""
    if any(x.dtype == torch.float64 for x in xs):
        return torch.float64
    return torch.float32


def _resolve(a, b, precision) -> str:
    if precision is not None:
        return canonicalize(precision)
    if a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return DEFAULT
    return prec()


def split_f32(x: torch.Tensor):
    """(hi, lo) with hi = x rounded to nearest-even on the bf16 grid (bit
    level: u + 0x7FFF + ((u >> 16) & 1), masked to the top 16 bits) and
    lo = x - hi, both f32. Torch has no uint32 arithmetic on the CPU, so
    the bits are widened to int64."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rne = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    rne = torch.where(rne >= 2**31, rne - 2**32, rne)
    hi = rne.to(torch.int32).view(torch.float32)
    return hi, x - hi


def to_bf16_grid(x: torch.Tensor) -> torch.Tensor:
    """x rounded (RNE) to bf16 and held in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def passes(a: torch.Tensor, b: torch.Tensor, level: str):
    """The (lhs, rhs) f32 pairs whose products, summed as
    p0 + (p1 + p2), give `a @ b` at `level` (one pair for one pass)."""
    if a.dtype == torch.bfloat16 or level == DEFAULT:
        return [(to_bf16_grid(a.float()), to_bf16_grid(b.float()))]
    a_hi, a_lo = split_f32(a)
    b_hi, b_lo = split_f32(b)
    a_lo, b_lo = to_bf16_grid(a_lo), to_bf16_grid(b_lo)
    return [(a_hi, b_hi), (a_hi, b_lo), (a_lo, b_hi)]


BF16_CHUNK_ELEMS = 1 << 24   # f32 elements of one k-chunk's two copies


def bf16_chunk(rows: int, cols: int, k: int) -> int:
    """k-chunk of an (rows, k) @ (k, cols) bf16 product: the chunk's two
    f32 copies, (rows + cols) * chunk elements, stay within
    BF16_CHUNK_ELEMS (at least one column of k)."""
    return max(1, min(k, BF16_CHUNK_ELEMS // max(rows + cols, 1)))


def bf16_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32-accumulated a @ b of two 2-D bf16 tensors, without an f32 copy
    of a whole operand: f32 products of k-chunks (exact, as every product
    of two bf16 values is) summed into the f32 result."""
    rows, k = a.shape
    cols = b.shape[1]
    step = bf16_chunk(rows, cols, k)
    out = torch.zeros((rows, cols), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, step):
        out.addmm_(a[:, k0:k0 + step].float(), b[k0:k0 + step].float())
    return out


def _product(a, b, level, out_dtype):
    if (a.dtype == b.dtype == torch.bfloat16 and out_dtype == torch.float32
            and a.dim() == b.dim() == 2):
        return bf16_dot(a, b)   # one pass at every level: products exact
    if level == HIGHEST or out_dtype == torch.float64:
        return torch.matmul(a.to(out_dtype), b.to(out_dtype))
    ps = [torch.matmul(x, y) for x, y in passes(a, b, level)]
    out = ps[0] if len(ps) == 1 else ps[0] + (ps[1] + ps[2])
    return out.to(out_dtype)


def dot(a, b, preferred_element_type=None, precision=None):
    """`a @ b` accumulated in `preferred_element_type` (default acc_dtype)
    at the resolved precision."""
    out_dtype = preferred_element_type or acc_dtype(a, b)
    return _product(a, b, _resolve(a, b, precision), out_dtype)


def dot_general(a, b, dimension_numbers, preferred_element_type=None,
                precision=None):
    """2-D `lax.dot_general` without batch dimensions: contracts axis
    `ca` of a with axis `cb` of b, ((ca,), (cb,)) in dimension_numbers."""
    (ca, cb), batch = dimension_numbers
    if batch != ((), ()) or len(ca) != 1 or len(cb) != 1:
        raise NotImplementedError(f"dot_general {dimension_numbers}")
    lhs = a.T if ca[0] == 0 else a
    rhs = b.T if cb[0] == 1 else b
    return dot(lhs, rhs, preferred_element_type, precision)
