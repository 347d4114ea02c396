"""Local BLAS-3 semantics (counterpart of capital_tpu/ops/blas.py): gemm,
trmm, syrk, and gram_dot, cacqr's plain Gram.

Conventions:
  * triangular operands are dense tensors; `uplo` selects the mask,
  * accumulation is f32 for f32/bf16 inputs (ops/precision.py),
  * a window (r0, c0, h, w) is a strided view of a larger tensor, handed
    to the kernels as pointer + leading dimension, never copied.

method='tri' runs the hand-written triangle kernels (ops/cuda_trmm.py,
ops/cuda_syrk.py; their plain versions on a CPU tensor), 'dot' a masked
plain product. 'auto' takes CAPITAL_TRMM_METHOD / CAPITAL_SYRK_METHOD if
set, else 'tri' on a GPU, but for two bf16 gates: a formQ-like side='R'
TRMM (B more than 4x taller than U) and a SYRK stay on 'dot' below n =
BF16_TRI_MIN_N (U's side; A's columns). On the card a bf16 plain product
is an f32 product without tensor cores (precision.bf16_dot): at cacqr's
2^22 x 1024 bf16 factor the kernels took 140-170 ms against 520-541 ms
on 'dot' at each of the three bf16 gates, cacqr's Gram among them
(PERF.md, K8, before the plain product's f32 copies went chunked).
Narrower bf16 operands were not measured there and keep 'dot', as the
JAX package does below its TPU threshold of 2048.
"""

from __future__ import annotations

import os

import torch

from capital_tpu_torch.ops.cuda_trmm import window as _slice_window
from capital_tpu_torch.ops.precision import dot as _pdot

BF16_TRI_MIN_N = 1024


def _dot(a, b):
    """a @ b accumulated in f32 (f64 for f64), returned in a's dtype."""
    return _pdot(a, b).to(a.dtype)


def _on_gpu(x, platform) -> bool:
    return platform == "gpu" if platform else x.is_cuda


def gemm(a, b, *, c=None, alpha=1.0, beta=0.0, trans_a=False,
         trans_b=False):
    """C = alpha * op(A) op(B) + beta * C."""
    a = a.T if trans_a else a
    b = b.T if trans_b else b
    out = _dot(a, b)
    if alpha != 1.0:
        out = alpha * out
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out


def trmm(a, b, *, side="L", uplo="U", trans_a=False, diag="N", alpha=1.0,
         method="auto", platform=None, a_window=None, b_window=None):
    """B = alpha * op(tri(A)) B (side=L) or alpha * B op(tri(A)) (side=R).
    tri() masks A to its `uplo` triangle; diag='U' forces a unit diagonal.
    a_window must be square (A is the triangular operand)."""
    if a_window is not None and a_window[2] != a_window[3]:
        raise ValueError(f"triangular a_window must be square: {a_window}")
    a_n = a_window[2] if a_window is not None else a.shape[0]
    b_rows = b_window[2] if b_window is not None else b.shape[0]
    if method == "auto":
        formq_like = (a.dtype == torch.bfloat16 and side == "R"
                      and a_n < BF16_TRI_MIN_N and b_rows > 4 * a_n)
        method = os.environ.get("CAPITAL_TRMM_METHOD") or (
            "tri" if _on_gpu(b, platform) and not formq_like else "dot")
    if (method == "tri" and uplo == "U" and diag == "N"
            and a.dtype in (torch.float32, torch.bfloat16)):
        from capital_tpu_torch.ops.cuda_trmm import trmm_upper

        uw = (a_window[0], a_window[1], a_window[2]) if a_window else None
        return trmm_upper(a, b, side=side, trans_a=trans_a, alpha=alpha,
                          u_window=uw, b_window=b_window)
    trmm.dot_calls += 1
    a = _slice_window(a, a_window)
    b = _slice_window(b, b_window)
    t = torch.triu(a) if uplo == "U" else torch.tril(a)
    if diag == "U":
        t = t.clone()
        t.diagonal().fill_(1)
    if trans_a:
        t = t.T
    out = _dot(t, b) if side == "L" else _dot(b, t)
    if alpha != 1.0:
        out = alpha * out
    return out


trmm.dot_calls = 0


def syrk(a, *, c=None, uplo="U", trans="T", alpha=1.0, beta=0.0,
         method="auto", platform=None, a_window=None):
    """C = alpha * A^T A + beta * C (trans='T') or alpha * A A^T + beta * C.
    Returns the full symmetric result."""
    a_cols = a_window[3] if a_window is not None else a.shape[-1]
    if method == "auto":
        dtype_ok = a.dtype == torch.float32 or (
            a.dtype == torch.bfloat16 and a_cols >= BF16_TRI_MIN_N)
        method = os.environ.get("CAPITAL_SYRK_METHOD") or (
            "tri" if _on_gpu(a, platform) and dtype_ok else "dot")
    if (method == "tri" and trans == "T"
            and a.dtype in (torch.float32, torch.bfloat16)):
        from capital_tpu_torch.ops.cuda_syrk import syrk_upper

        out = syrk_upper(a, out_dtype=a.dtype, a_window=a_window)
    else:
        syrk.dot_calls += 1
        a = _slice_window(a, a_window)
        out = _dot(a.T, a) if trans == "T" else _dot(a, a.T)
    if alpha != 1.0:
        out = alpha * out
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out


syrk.dot_calls = 0


def gram_dot(a):
    """A^T A accumulated in f32 (f64 for f64) by a plain product: cacqr's
    Gram off the SYRK kernel (the `gram_dot` fallback of ops.counters();
    it does not go through syrk's method choice)."""
    gram_dot.calls += 1
    return _pdot(a.T, a)


gram_dot.calls = 0
