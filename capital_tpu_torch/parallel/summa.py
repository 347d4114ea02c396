"""2.5D SUMMA engine, single-device part (counterpart of
capital_tpu/parallel/summa.py).

On a one-device grid every call is one local BLAS call: trmm and syrk go
straight to the kernel layer (ops/blas.py), with their windows, and gemm
is one plain product. Each call records its analytic cost (tracing.py).
The multi-device engines (all_gather/psum schedule, Cannon ring,
distributed transpose) wait for the distributed substrate (ROADMAP queue
M, item M10); grid.Grid refuses to build a grid they would need.
"""

from __future__ import annotations

from capital_tpu_torch import tracing
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.ops import blas
from capital_tpu_torch.ops.precision import dot as _pdot


def _win_shape(x, window) -> tuple[int, int]:
    """The windowed extent (cost recording), not the backing tensor's."""
    if window is None:
        return tuple(x.shape)
    return (window[2], window[3])


def _record_gemm_cost(grid: Grid, a_shape, b_shape, esz: int,
                      collect_chunks: int = 1):
    """Analytic per-device cost of one 2.5D gemm: 2mnk/(d^2 c) flops; two
    all_gathers of the K panels + one psum over depth. Only active inside
    tracing.trace()."""
    if tracing.active() is None:
        return
    d, c = grid.d1, grid.c
    m, k = a_shape
    n = b_shape[1]
    flops = 2.0 * m * n * k / (d * d * c)
    cc = max(1, collect_chunks) if c > 1 else 1
    comm = (
        tracing.all_gather_bytes(m * k * esz / (d * d * c), grid.d2)
        + tracing.all_gather_bytes(k * n * esz / (d * d * c), d)
        + tracing.psum_bytes(m * n * esz / (d * d), c)
    )
    tracing.record("summa.gemm", flops=flops, comm_bytes=comm, msgs=2 + cc)


IMPLS = ("shard_map", "ring", "gspmd")


def gemm(grid: Grid, a, b, *, c=None, alpha=1.0, beta=0.0, impl="gspmd",
         num_chunks: int = 1, throttle: bool = False,
         collect_chunks: int = 1):
    """C = alpha * A @ B + beta * C. On one device every impl in IMPLS is
    the same local product (any other raises ValueError, as in the JAX
    package); the schedule knobs only matter across devices."""
    if impl not in IMPLS:
        raise ValueError(f"unknown summa impl {impl!r}")
    _record_gemm_cost(grid, a.shape, b.shape, a.element_size(),
                      collect_chunks=collect_chunks)
    out = _pdot(a, b).to(a.dtype)
    if alpha != 1.0:
        out = alpha * out
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out


def transpose(grid: Grid, a, impl="gspmd"):
    """Distributed transpose; on one device a local one."""
    tracing.record("summa.transpose",
                   comm_bytes=tracing.ppermute_bytes(
                       a.numel() * a.element_size()
                       / max(grid.d1 * grid.d2, 1)),
                   msgs=1)
    return a.T.contiguous()


def trmm(grid: Grid, a, b, *, side="L", uplo="U", trans_a=False, alpha=1.0,
         impl="gspmd", num_chunks: int = 1, throttle: bool = False,
         collect_chunks: int = 1, a_window=None, b_window=None):
    """Triangular multiply. a_window/b_window=(r0, c0, h, w) operate on
    windows of larger tensors without copying them."""
    aw, bw = _win_shape(a, a_window), _win_shape(b, b_window)
    if side == "L":
        _record_gemm_cost(grid, aw, bw, a.element_size())
    else:
        _record_gemm_cost(grid, bw, aw, a.element_size())
    return blas.trmm(a, b, side=side, uplo=uplo, trans_a=trans_a,
                     alpha=alpha, platform=grid.platform,
                     a_window=a_window, b_window=b_window)


def syrk(grid: Grid, a, *, c=None, alpha=1.0, beta=0.0, impl="gspmd",
         num_chunks: int = 1, throttle: bool = False,
         collect_chunks: int = 1, a_window=None):
    """C = alpha * A^T A + beta * C: the dominant-flop call of cholinv's
    Schur updates."""
    aw = _win_shape(a, a_window)
    _record_gemm_cost(grid, aw, aw, a.element_size())
    return blas.syrk(a, c=c, alpha=alpha, beta=beta, platform=grid.platform,
                     a_window=a_window)


def syrk2(grid: Grid, a, b, *, c=None, alpha=1.0, beta=0.0,
          impl="shard_map", num_chunks: int = 1, throttle: bool = False,
          collect_chunks: int = 1):
    """Two-matrix SYRK: C = alpha * A^T B + beta * C (polar's H = U^T A).
    On one device one plain product, recorded as the gemm it is."""
    return gemm(grid, a.T, b, c=c, alpha=alpha, beta=beta, impl=impl,
                num_chunks=num_chunks, throttle=throttle,
                collect_chunks=collect_chunks)
