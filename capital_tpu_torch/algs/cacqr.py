"""CholeskyQR / CholeskyQR2 of a tall-skinny A (counterpart of
capital_tpu/algs/cacqr.py).

One sweep:

    G = A^T A              Gram: the SYRK kernel ('tri') or a plain product
    R, Rinv = chol_inv(G)  the fused Cholesky leaf for 128 | n <= 1024,
                           torch.linalg above (ops/lapack.py)
    Q = A @ triu(Rinv)     TRMM, side='R'

CholeskyQR2 (num_iter=2) runs the sweep twice and merges R <- R2 R1 with
one more TRMM (side='L'). `factor` sends n <= local_thresh to the 1D path
(rows over every device, Gram replicated) and larger n to the 3D path
(Gram, Cholesky and Q through the SUMMA layer and the recursive cholinv).
The hybrid path (`factor_hybrid`) forms the Gram as the 1D path does and
factors it with the recursive cholinv on the grid's square (z, x) view.

Across ranks (a grid on a mesh): the 1D and hybrid paths hold A's rows
over every rank, P(('z', 'y', 'x'), None), and reduce the per-rank Gram
(the SYRK kernel at 'tri') by the policy's collectives; every rank
factors the replicated Gram and forms its rows of Q by a TRMM side='R'.
The 3D path runs on DArrays of the (row, col) slice through the SUMMA
engine and the distributed cholinv. On one device every reduction of the
Gram policies is the identity.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.algs import cholinv
from capital_tpu_torch.grid import ALL_AXES, AXIS_X, AXIS_Y, AXIS_Z, P, Grid
from capital_tpu_torch.matrix import DistMatrix
from capital_tpu_torch.ops import blas, lapack
from capital_tpu_torch.ops.cuda_syrk import syrk_upper
from capital_tpu_torch.ops.precision import dot as _pdot
from capital_tpu_torch.parallel import collectives as coll
from capital_tpu_torch.parallel import darray, summa
from capital_tpu_torch.parallel.darray import DArray


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


ROW1D = P(ALL_AXES, None)


def _operand(grid: Grid, a):
    """A's tensor (a DistMatrix's data) on the grid's device, or on a
    mesh A as given (a DArray, or a tensor every rank holds whole)."""
    arr = a.data if isinstance(a, DistMatrix) else a
    if grid.mesh is None and arr.device != grid.device:
        raise ValueError(f"operand on {arr.device}, grid on {grid.device}")
    return arr


def _rows(grid: Grid, a) -> DArray:
    """A as a DArray of rows over every rank (raises when the rows do not
    split over them, as shard_map does)."""
    return darray.reshard(darray.as_darray(a, grid.mesh), ROW1D)


def _triu(x):
    return x.triu() if isinstance(x, DArray) else torch.triu(x)


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
    """A^T A in f32: the SYRK kernel for 'tri' (on a row-major copy of an
    operand whose columns are strided, as LAPACK's column-major Q of the
    TSQR leaf is), else blas.gram_dot."""
    if kernel == "tri":
        return syrk_upper(a if a.stride(-1) == 1 else a.contiguous())
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


def gram_1d(grid: Grid, a, policy: str = "allreduce",
            kernel: str = "dot") -> torch.Tensor:
    """G = A^T A in A's dtype, replicated: each rank's Gram of its rows,
    summed over every rank by the policy: 'allreduce' one psum,
    'two_stage' a psum_scatter then an all_gather, 'packed' a psum of the
    packed triangle when 128 | n (else 'allreduce'). On one device the
    sum is the identity ('packed' still round-trips G through the
    triangle)."""
    if policy not in _POLICIES:
        raise ValueError(f"unknown gram policy {policy!r}")
    n = a.shape[1]
    kernel = _resolve_gram_kernel(kernel, a.dtype, grid.platform, n)
    mesh = grid.mesh
    x = a if mesh is None else _rows(grid, a).local
    g = _local_gram(x, kernel).to(a.dtype)
    packed = policy == "packed" and n % _PACK_T == 0
    if mesh is None:
        return _unpack_tri(_pack_tri(g), n) if packed else g
    if policy == "two_stage":
        g = coll.psum_scatter(g, mesh, ALL_AXES, dim=0)
        return coll.all_gather(g, mesh, ALL_AXES, dim=0)
    if packed:
        return _unpack_tri(coll.psum(_pack_tri(g), mesh, ALL_AXES), n)
    return coll.psum(g, mesh, ALL_AXES)


# ---------------------------------------------------------------------------
# 1D path
# ---------------------------------------------------------------------------

def _sweep_1d(grid: Grid, a, cfg: Config, overwrite_a: bool):
    m, n = a.shape
    p = grid.num_devices
    esz = darray.element_size(a)
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
    # Q's rows are A's rows times triu(Rinv): each rank forms its own
    # (on a mesh A is a DArray of rows, factor_1d's)
    blk = a if grid.mesh is None else a.local
    with tracing.phase("CQR::formQ"):
        tracing.record("trmm_local", flops=2.0 * m * n * n / p)
        if cfg.formq_chunks > 1:
            q = _formq_inplace(grid, blk if overwrite_a else blk.clone(),
                               rinv, cfg.formq_chunks)
        else:
            q = blas.trmm(rinv, blk, side="R", uplo="U",
                          platform=grid.platform)
    return (q if grid.mesh is None else a.with_local(q)), r


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
    """CholeskyQR(2) in the 1D layout. Returns (Q, R): Q like A (on a
    mesh a DArray of rows over every rank), R n x n upper triangular,
    replicated (num_iter=1 returns the sweep's R as chol_inv gives it, as
    the JAX package does).

    A is left as it was unless overwrite_a is True and cfg.formq_chunks >
    1: then Q is written over A's storage (Q is A), which saves a copy of
    A when the caller no longer needs it."""
    a = _operand(grid, a)
    if grid.mesh is not None:
        a = _rows(grid, a)
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

def _solve_2block(grid: Grid, a, r, rinv, n1: int, cfg: Config):
    """Q from a partial inverse (only the diagonal blocks of Rinv) by a
    2-block back-substitution: Q1 = A1 R11inv; Q2 = (A2 - Q1 R12) R22inv."""
    m, n = a.shape
    n2 = n - n1
    impl = cfg.chol.summa_impl
    q1 = summa.trmm(grid, rinv, a, side="R", uplo="U", impl=impl,
                    a_window=(0, 0, n1, n1), b_window=(0, 0, m, n1))
    if grid.mesh is None:
        t = summa.gemm(grid, q1, r[:n1, n1:], c=a[:, n1:], alpha=-1.0,
                       beta=1.0, impl=impl)
    else:
        spec = grid.slice_spec
        a, r = grid.constrain(a, spec), grid.constrain(r, spec)
        t = summa.gemm(grid, q1, darray.window(r, (0, n1, n1, n2)),
                       c=darray.window(a, (0, n1, m, n2)), alpha=-1.0,
                       beta=1.0, impl=impl)
    q2 = summa.trmm(grid, rinv, t, side="R", uplo="U", impl=impl,
                    a_window=(n1, n1, n2, n2))
    if grid.mesh is None:
        return torch.cat([q1, q2], dim=1)
    q = darray.zeros((m, n), spec, grid.mesh, q1.dtype, q1.device)
    darray.set_window(q, (0, 0), q1)
    darray.set_window(q, (0, n1), q2)
    return q


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
    Returns (Q, R), R upper triangular (on a mesh both DArrays of the
    slice spec)."""
    a = _operand(grid, a)
    if grid.mesh is not None:
        a = grid.constrain(a, grid.slice_spec)
    q, r1 = _sweep_3d(grid, a, cfg)
    if cfg.num_iter == 1:
        return q, _triu(r1)
    q, r2 = _sweep_3d(grid, q, cfg)
    r = summa.trmm(grid, r2, _triu(r1), side="L", uplo="U",
                   impl=cfg.chol.summa_impl)
    return q, _triu(r)


# ---------------------------------------------------------------------------
# hybrid path: rows over a rect grid, Gram factored on its square view
# ---------------------------------------------------------------------------

def gram_hybrid(grid: Grid, a, policy: str = "two_stage",
                kernel: str = "auto"):
    """G = A^T A in A's dtype, laid out on the rect grid's square (z, x)
    view: a DArray of P('z', 'x') on a mesh. 'two_stage' reduce-scatters
    each rank's Gram over x (columns), then z (rows), and sums over the
    long y axis, so the stage that crosses hosts moves 1/c^2 of G;
    'allreduce' and 'packed' sum over the whole mesh (the latter as the
    packed tile triangle) and keep the (z, x) block. On one device every
    reduction is the identity, so each policy is gram_1d's."""
    if grid.mesh is None or policy != "two_stage":
        g = gram_1d(grid, a, policy, kernel=kernel)
        return g if grid.mesh is None else grid.constrain(
            g, P(AXIS_Z, AXIS_X))
    n = a.shape[1]
    kernel = _resolve_gram_kernel(kernel, a.dtype, grid.platform, n)
    mesh = grid.mesh
    g = _local_gram(_rows(grid, a).local, kernel).to(a.dtype)
    g = coll.psum_scatter(g, mesh, AXIS_X, dim=1)
    g = coll.psum_scatter(g, mesh, AXIS_Z, dim=0)
    g = coll.psum(g, mesh, AXIS_Y)
    return DArray(g, (n, n), P(AXIS_Z, AXIS_X), mesh)


def _sweep_hybrid(grid: Grid, a: torch.Tensor, cfg: Config):
    """Rows over the whole mesh (as the 1D path), the Gram factored by the
    recursive cholinv on the square (z, x) view (as the 3D path); Q by a
    local TRMM side='R' against the inverse."""
    m, n = a.shape
    with tracing.phase("CQR::gram"):
        p = grid.num_devices
        esz = darray.element_size(a)
        c = grid.c
        if cfg.gram_policy == "two_stage":
            comm = (tracing.psum_bytes(n * n * esz, c) / 2        # scatter x
                    + tracing.psum_bytes(n * n * esz / c, c) / 2  # scatter z
                    + tracing.psum_bytes(n * n * esz / (c * c), grid.d1))
        else:
            words = (_tri_pack_size(n)
                     if cfg.gram_policy == "packed" and n % _PACK_T == 0
                     else n * n)
            comm = tracing.psum_bytes(words * esz, p)
        tracing.record("gram_hybrid", flops=2.0 * m * n * n / p,
                       comm_bytes=comm, msgs=3)
        g = gram_hybrid(grid, a, cfg.gram_policy, kernel=cfg.gram_kernel)
    sq = grid.view(z=None, y="z", x="x")  # square c x c slice
    with tracing.phase("CQR::chol"):
        r, rinv = cholinv.factor(sq, g, cfg.chol)
    del g
    with tracing.phase("CQR::formQ"):
        # every rank its rows of Q against the replicated inverse
        rinv = darray.whole(rinv)
        if grid.mesh is None:
            return blas.trmm(rinv, a, side="R", uplo="U",
                             platform=grid.platform), r
        x = _rows(grid, a)
        q = blas.trmm(rinv, x.local, side="R", uplo="U",
                      platform=grid.platform)
    return x.with_local(q), darray.whole(r)


def factor_hybrid(grid: Grid, a, cfg: Config = Config()):
    """CholeskyQR(2) with rows over a rect grid (c == d2) and the Gram
    factored on its (z, x) square view. Returns (Q, R), R upper
    triangular and replicated. A is left as it was."""
    if grid.c != grid.d2:
        raise ValueError(
            f"hybrid path needs a rect grid with c == d2, got {grid.shape}")
    a = _operand(grid, a)
    if grid.mesh is not None:
        a = _rows(grid, a)
    q, r1 = _sweep_hybrid(grid, a, cfg)
    if cfg.num_iter == 1:
        return q, torch.triu(r1)
    q, r2 = _sweep_hybrid(grid, q, cfg)
    r = blas.trmm(r2, torch.triu(r1), side="L", uplo="U",
                  platform=grid.platform)
    return q, torch.triu(r)


# ---------------------------------------------------------------------------
# dispatch and export
# ---------------------------------------------------------------------------

def factor(grid: Grid, a, cfg: Config = Config(), *,
           overwrite_a: bool = False):
    """The 1D path for n <= cfg.local_thresh; else the hybrid path on a
    rect grid with 1 < c == d2 < d1; else the 3D path. overwrite_a as
    for factor_1d; the other paths never write over A."""
    arr = a.data if isinstance(a, DistMatrix) else a
    if arr.shape[1] <= cfg.local_thresh:
        return factor_1d(grid, arr, cfg, overwrite_a=overwrite_a)
    if not grid.is_square and grid.c == grid.d2 and grid.c > 1:
        return factor_hybrid(grid, arr, cfg)
    return factor_3d(grid, arr, cfg)


def construct_q(q, shape=None) -> torch.Tensor:
    """Dense Q, generator padding cropped (a DArray gathered whole)."""
    q = darray.to_global(q)
    if shape is not None:
        q = q[: shape[0], : shape[1]]
    return q


def construct_r(r, shape=None) -> torch.Tensor:
    """Dense masked R (a DArray gathered whole)."""
    out = torch.triu(darray.to_global(r))
    if shape is not None:
        out = out[: shape[0], : shape[1]]
    return out


def is_row_sharded(x) -> bool:
    """True for a DArray of rows over every rank (the 1D layout), and
    for any tensor on one device, where every tensor is."""
    if isinstance(x, DArray):
        return tuple(x.spec) == tuple(ROW1D)
    return True


def apply_q(grid: Grid, q, x, *, trans: bool = False, cfg: Config = Config(),
            layout: str = "auto", out_dtype=None):
    """Y = Q X, or Q^T X with trans. layout '1d' (Q's rows over every
    rank: a local product, Q^T X summed over the ranks), '2d' (through
    the SUMMA layer) or 'auto' (from Q's layout).

    out_dtype ('1d' with trans): dtype of the skinny projection, default
    Q's; f32 with bf16 operands keeps it at full accumulation precision."""
    if layout == "auto":
        layout = "1d" if is_row_sharded(q) else "2d"
    if layout == "1d":
        if grid.mesh is None:
            if not trans:
                return blas.gemm(q, x)
            return _pdot(q.T, x).to(out_dtype or q.dtype)
        qr = _rows(grid, q)
        if not trans:
            return qr.with_local(blas.gemm(qr.local, darray.whole(x)))
        part = _pdot(qr.local.T, _rows(grid, x).local).to(
            out_dtype or q.dtype)
        return coll.psum(part, grid.mesh, ALL_AXES)
    impl = cfg.chol.summa_impl
    qq = summa.transpose(grid, q, impl=impl) if trans else q
    return summa.gemm(grid, qq, x, impl=impl)
