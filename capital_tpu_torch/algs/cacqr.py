"""CholeskyQR / CholeskyQR2 of a tall-skinny A (counterpart of
capital_tpu/algs/cacqr.py), on one device.

One sweep:

    G = A^T A              Gram: the SYRK kernel ('tri') or a plain product
    R, Rinv = chol_inv(G)  the fused Cholesky leaf for 128 | n <= 1024,
                           torch.linalg above (ops/lapack.py)
    Q = A @ triu(Rinv)     TRMM, side='R'

CholeskyQR2 (num_iter=2) runs the sweep twice and merges R <- R2 R1 with
one more TRMM (side='L'). `factor` sends n <= local_thresh to the 1D path
(rows over every device, Gram replicated) and larger n to the 3D path
(Gram, Cholesky and Q through the SUMMA layer and the recursive cholinv).
On one device every reduction of the Gram policies is the identity; the
hybrid path needs a rect grid of more than one device (ROADMAP queue M,
item M11) and raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.algs import cholinv
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.matrix import DistMatrix
from capital_tpu_torch.ops import blas, lapack
from capital_tpu_torch.ops.cuda_syrk import syrk_upper
from capital_tpu_torch.ops.precision import dot as _pdot
from capital_tpu_torch.parallel import summa


@dataclass(frozen=True)
class Config:
    """The JAX package's cacqr.Config, field for field.

    num_iter:     1 = CholeskyQR, 2 = CholeskyQR2.
    gram_policy:  'allreduce' | 'two_stage' | 'packed' (the last moves the
                  tile-packed upper triangle; on one device it still packs
                  and unpacks G).
    local_thresh: largest n that `factor` sends to the 1D path.
    base_method:  the Gram Cholesky of the 1D path (lapack.chol_inv).
    formq_chunks: > 1 forms Q = A Rinv in place, row chunk by row chunk
                  (row i of Q needs only row i of A): over a copy of A,
                  or over the caller's A itself when factor_1d is given
                  overwrite_a=True (peak memory A + one chunk instead of
                  A + Q, as the JAX package's bench gets by donating A).
                  1 = one out-of-place TRMM.
    gram_kernel:  'tri' (the SYRK kernel), 'dot' (a plain product) or
                  'auto' (see _resolve_gram_kernel).
    chol:         the nested cholinv config (3D path).
    """

    num_iter: int = 2
    gram_policy: str = "allreduce"
    local_thresh: int = 4096
    base_method: str = "auto"
    formq_chunks: int = 1
    gram_kernel: str = "auto"
    chol: cholinv.Config = field(default_factory=cholinv.Config)


_POLICIES = ("allreduce", "two_stage", "packed")


def _operand(grid: Grid, a) -> torch.Tensor:
    arr = a.data if isinstance(a, DistMatrix) else a
    if arr.device != grid.device:
        raise ValueError(f"operand on {arr.device}, grid on {grid.device}")
    return arr


# ---------------------------------------------------------------------------
# Gram (the only reduction of the 1D path)
# ---------------------------------------------------------------------------

def _resolve_gram_kernel(kernel: str, dtype, platform: str,
                         n: int | None = None) -> str:
    """'auto' picks 'tri' on a GPU for f32, and for bf16 at n >=
    blas.BF16_TRI_MIN_N (measured on the card; the JAX package's TPU rule
    has 2048); 'dot' elsewhere."""
    if kernel == "auto":
        if platform != "gpu":
            return "dot"
        if dtype == torch.float32:
            return "tri"
        if (dtype == torch.bfloat16 and n is not None
                and n >= blas.BF16_TRI_MIN_N):
            return "tri"
        return "dot"
    return kernel


def _local_gram(a: torch.Tensor, kernel: str) -> torch.Tensor:
    """A^T A in f32: the SYRK kernel for 'tri', else blas.gram_dot."""
    if kernel == "tri":
        return syrk_upper(a)
    return blas.gram_dot(a)

# The packed triangle is tile-granular: the upper T x T tiles (i <= j)
# stacked into one (npairs, T, T) tensor, npairs * T^2 = n (n + T) / 2
# words against n^2.
_PACK_T = 128


def _tri_pack_size(n: int, t: int = _PACK_T) -> int:
    nt = n // t
    return (nt * (nt + 1) // 2) * t * t


def _pair_index(nt: int, device) -> torch.Tensor:
    return torch.tensor([i * nt + j for i in range(nt) for j in range(i, nt)],
                        device=device)


def _pack_tri(g: torch.Tensor, t: int = _PACK_T) -> torch.Tensor:
    n = g.shape[0]
    nt = n // t
    tiles = g.reshape(nt, t, nt, t).permute(0, 2, 1, 3).reshape(nt * nt, t, t)
    return tiles[_pair_index(nt, g.device)]


def _unpack_tri(packed: torch.Tensor, n: int,
                t: int = _PACK_T) -> torch.Tensor:
    nt = n // t
    tiles = torch.zeros((nt * nt, t, t), dtype=packed.dtype,
                        device=packed.device)
    tiles[_pair_index(nt, packed.device)] = packed
    g = tiles.reshape(nt, nt, t, t).permute(0, 2, 1, 3).reshape(n, n)
    # mirror the strictly-lower tiles from the upper ones (diagonal tiles
    # were packed whole)
    tile = torch.arange(n, device=packed.device) // t
    return torch.where(tile[:, None] > tile[None, :], g.T, g)


def gram_1d(grid: Grid, a: torch.Tensor, policy: str = "allreduce",
            kernel: str = "dot") -> torch.Tensor:
    """G = A^T A in A's dtype, replicated (on one device: local). 'packed'
    round-trips G through the packed triangle when 128 | n, as the JAX
    package's reduction does; otherwise it is 'allreduce'."""
    if policy not in _POLICIES:
        raise ValueError(f"unknown gram policy {policy!r}")
    n = a.shape[1]
    kernel = _resolve_gram_kernel(kernel, a.dtype, grid.platform, n)
    g = _local_gram(a, kernel).to(a.dtype)
    if policy == "packed" and n % _PACK_T == 0:
        g = _unpack_tri(_pack_tri(g), n)
    return g


# ---------------------------------------------------------------------------
# 1D path
# ---------------------------------------------------------------------------

def _sweep_1d(grid: Grid, a: torch.Tensor, cfg: Config,
              overwrite_a: bool):
    m, n = a.shape
    p = grid.num_devices
    esz = a.element_size()
    with tracing.phase("CQR::gram"):
        words = (_tri_pack_size(n)
                 if cfg.gram_policy == "packed" and n % _PACK_T == 0
                 else n * n)
        tracing.record("gram_1d", flops=2.0 * m * n * n / p,
                       comm_bytes=tracing.psum_bytes(words * esz, p), msgs=1)
        g = gram_1d(grid, a, cfg.gram_policy, kernel=cfg.gram_kernel)
    with tracing.phase("CQR::formR"):
        tracing.record("chol_inv", flops=2.0 * n**3 / 3.0)
        r, rinv = lapack.chol_inv(g, lower=False, method=cfg.base_method,
                                  platform=grid.platform)
    del g
    with tracing.phase("CQR::formQ"):
        tracing.record("trmm_local", flops=2.0 * m * n * n / p)
        if cfg.formq_chunks > 1:
            q = _formq_inplace(grid, a if overwrite_a else a.clone(), rinv,
                               cfg.formq_chunks)
        else:
            q = blas.trmm(rinv, a, side="R", uplo="U",
                          platform=grid.platform)
    return q, r


def _formq_inplace(grid: Grid, a: torch.Tensor, rinv: torch.Tensor,
                   chunks: int) -> torch.Tensor:
    """Q = A @ triu(Rinv) written over A's row chunks; returns A's storage.
    Each chunk is a window handed to the TRMM, never copied on the way in.
    The chunk count is the largest count <= chunks that divides the rows
    (the JAX package's rule, whose clamped slices need exact division),
    so both packages run the same chunks."""
    t = torch.triu(rinv)
    rows, n = a.shape
    nch = chunks
    while rows % nch:
        nch -= 1
    ch = rows // nch
    for i in range(nch):
        qc = blas.trmm(t, a, side="R", uplo="U", platform=grid.platform,
                       b_window=(i * ch, 0, ch, n))
        a[i * ch:(i + 1) * ch].copy_(qc)
        del qc  # before the next chunk's output is allocated
    return a


def factor_1d(grid: Grid, a, cfg: Config = Config(), *,
              overwrite_a: bool = False):
    """CholeskyQR(2) in the 1D layout. Returns (Q, R): Q like A, R n x n
    upper triangular (num_iter=1 returns the sweep's R as chol_inv gives
    it, as the JAX package does).

    A is left as it was unless overwrite_a is True and cfg.formq_chunks >
    1: then Q is written over A's storage (Q is A), which saves a copy of
    A when the caller no longer needs it."""
    a = _operand(grid, a)
    q, r1 = _sweep_1d(grid, a, cfg, overwrite_a)
    if cfg.num_iter == 1:
        return q, r1
    q, r2 = _sweep_1d(grid, q, cfg, overwrite_a=True)  # q is ours
    r = blas.trmm(r2, torch.triu(r1), side="L", uplo="U",
                  platform=grid.platform)
    return q, torch.triu(r)


# ---------------------------------------------------------------------------
# 3D path (distributed Gram Cholesky; on one device the SUMMA layer is
# local)
# ---------------------------------------------------------------------------

def _solve_2block(grid: Grid, a: torch.Tensor, r: torch.Tensor,
                  rinv: torch.Tensor, n1: int, cfg: Config) -> torch.Tensor:
    """Q from a partial inverse (only the diagonal blocks of Rinv) by a
    2-block back-substitution: Q1 = A1 R11inv; Q2 = (A2 - Q1 R12) R22inv."""
    m, n = a.shape
    n2 = n - n1
    impl = cfg.chol.summa_impl
    q1 = summa.trmm(grid, rinv, a, side="R", uplo="U", impl=impl,
                    a_window=(0, 0, n1, n1), b_window=(0, 0, m, n1))
    t = summa.gemm(grid, q1, r[:n1, n1:], c=a[:, n1:], alpha=-1.0, beta=1.0,
                   impl=impl)
    q2 = summa.trmm(grid, rinv, t, side="R", uplo="U", impl=impl,
                    a_window=(n1, n1, n2, n2))
    return torch.cat([q1, q2], dim=1)


def _sweep_3d(grid: Grid, a: torch.Tensor, cfg: Config):
    with tracing.phase("CQR::gram"):
        g = summa.syrk(grid, a, impl=cfg.chol.summa_impl)
    with tracing.phase("CQR::chol"):
        r, rinv = cholinv.factor(grid, g, cfg.chol)
    with tracing.phase("CQR::formQ"):
        if cfg.chol.complete_inv:
            q = summa.trmm(grid, rinv, a, side="R", uplo="U",
                           impl=cfg.chol.summa_impl)
        else:
            n = g.shape[0]
            n1 = max(cfg.chol.base_dim(grid, n), n >> cfg.chol.split)
            q = _solve_2block(grid, a, r, rinv, n1, cfg)
    return q, r


def factor_3d(grid: Grid, a, cfg: Config = Config()):
    """CholeskyQR(2) with the Gram factored by the recursive cholinv.
    Returns (Q, R), R upper triangular."""
    a = _operand(grid, a)
    q, r1 = _sweep_3d(grid, a, cfg)
    if cfg.num_iter == 1:
        return q, torch.triu(r1)
    q, r2 = _sweep_3d(grid, q, cfg)
    r = summa.trmm(grid, r2, torch.triu(r1), side="L", uplo="U",
                   impl=cfg.chol.summa_impl)
    return q, torch.triu(r)


# ---------------------------------------------------------------------------
# hybrid path: rows over a rect grid, Gram factored on its square view
# ---------------------------------------------------------------------------

def _no_hybrid():
    raise NotImplementedError(
        "the hybrid CholeskyQR path needs a rect grid of more than one "
        "device; the port runs on one device until ROADMAP queue M, item "
        "M11")


def gram_hybrid(grid: Grid, a, policy: str = "two_stage",
                kernel: str = "auto"):
    """G = A^T A sharded on the rect grid's square (z, x) view. Not on
    one device: raises NotImplementedError."""
    _no_hybrid()


def factor_hybrid(grid: Grid, a, cfg: Config = Config()):
    """CholeskyQR(2) with rows over a rect grid and the Gram factored on
    its square view. Not on one device: raises NotImplementedError."""
    _no_hybrid()


# ---------------------------------------------------------------------------
# dispatch and export
# ---------------------------------------------------------------------------

def factor(grid: Grid, a, cfg: Config = Config(), *,
           overwrite_a: bool = False):
    """The 1D path for n <= cfg.local_thresh, else the 3D path. (The JAX
    package's third branch, the hybrid path, needs a rect grid of more
    than one device.) overwrite_a as for factor_1d; the 3D path never
    writes over A."""
    arr = a.data if isinstance(a, DistMatrix) else a
    if arr.shape[1] <= cfg.local_thresh:
        return factor_1d(grid, arr, cfg, overwrite_a=overwrite_a)
    return factor_3d(grid, arr, cfg)


def construct_q(q: torch.Tensor, shape=None) -> torch.Tensor:
    """Dense Q, generator padding cropped."""
    if shape is not None:
        q = q[: shape[0], : shape[1]]
    return q


def construct_r(r: torch.Tensor, shape=None) -> torch.Tensor:
    """Dense masked R."""
    out = torch.triu(r)
    if shape is not None:
        out = out[: shape[0], : shape[1]]
    return out


def apply_q(grid: Grid, q: torch.Tensor, x: torch.Tensor, *,
            trans: bool = False, cfg: Config = Config(),
            layout: str = "auto", out_dtype=None) -> torch.Tensor:
    """Y = Q X, or Q^T X with trans. layout '1d' (row-sharded Q; 'auto'
    on the one-device grid, where every tensor is row-sharded over all
    devices) or '2d' (through the SUMMA layer).

    out_dtype ('1d' with trans): dtype of the skinny projection, default
    Q's; f32 with bf16 operands keeps it at full accumulation precision."""
    if layout == "auto":
        layout = "1d"
    if layout == "1d":
        if not trans:
            return blas.gemm(q, x)
        return _pdot(q.T, x).to(out_dtype or q.dtype)
    impl = cfg.chol.summa_impl
    qq = summa.transpose(grid, q, impl=impl) if trans else q
    return summa.gemm(grid, qq, x, impl=impl)
