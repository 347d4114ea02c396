"""LU factorization with partial pivoting, blocked right-looking
(counterpart of capital_tpu/algs/lu.py).

    for each nb-wide panel k:
      1. PANEL:  factor W[off:, off:off+nb] with partial pivoting
                 (the recursive panel below, or lapack.lu);
      2. SWAP:   apply the panel's row permutation to the L-history and
                 trailing columns (LAPACK's laswp, 4096 columns at a time);
      3. U-ROW:  U[k, k+nb:] = L_kk^{-1} W[k, k+nb:] (trtri + one gemm);
      4. SCHUR:  W[mid:, mid:] -= L[mid:, k] @ U[k, mid:], in row slabs.

L (unit diagonal implicit) and U overwrite A's copy in one workspace.
Everything is updated in place: the panel is factored inside its window
of the workspace, and rows are permuted with index_select + copy_.

The panel, its dots and the U row stay f32-faithful ('highest') whatever
the ambient precision: letting the panel follow 'high' cost 100x in
residual in the JAX package's measurements. The Schur update follows the
ambient precision.

Env switches, read at call time as in the JAX package: CAPITAL_LU_PANEL
(auto | jax | xla), CAPITAL_LU_LEAF (auto | jax), CAPITAL_LU_IB,
CAPITAL_LU_WIDE_LEAF, CAPITAL_LU_SCHUR_MB, CAPITAL_LU_LOOKAHEAD.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.matrix import DistMatrix
from capital_tpu_torch.ops import cuda_getrf, lapack
from capital_tpu_torch.ops.precision import default_matmul_precision
from capital_tpu_torch.ops.precision import dot as _pdot
from capital_tpu_torch.parallel import summa

_LASWP_COLS = 4096


@dataclass(frozen=True)
class Config:
    """The JAX package's lu.Config, field for field. nb: panel width;
    summa_impl / summa_chunks / summa_throttle / summa_collect_chunks: the
    Schur-update engine's distributed knobs, no effect on one device."""

    nb: int = 1024
    summa_impl: str = "shard_map"
    summa_chunks: int = 1
    summa_throttle: bool = False
    summa_collect_chunks: int = 1

    def panel(self, grid: Grid, n: int) -> int:
        """Largest panel <= nb dividing n with d | nb and d*c | nb."""
        nb = min(self.nb, n)
        step = grid.d * grid.c
        while nb > step and (n % nb or nb % step):
            nb -= step if nb % step == 0 else nb % step
        if n % nb:
            nb = n
        return nb


def leaf_width(on_card: bool, ib: int | None = None) -> int:
    """Columns per leaf of the recursive panel.

    On the card: the kernel's own budget, 128 columns (its pivot row and
    slots hold 128), or `ib` when CAPITAL_LU_WIDE_LEAF=0. Any height
    fits: strips up to what the grid's shared memory holds (~58k rows at
    128 columns on 132 SMs, every leaf of the LU paths) stay in shared
    memory across the grid, taller ones in global memory
    (ops/cuda_getrf.py::plan). The JAX package's rule
    here is a TPU scoped-VMEM budget that narrows tall strips; the card
    has no such limit. Elsewhere: `ib` (CAPITAL_LU_IB, default 64), the
    JAX package's CPU route."""
    if ib is None:
        ib = int(os.environ.get("CAPITAL_LU_IB", "64"))
    if not on_card:
        return ib
    if os.environ.get("CAPITAL_LU_WIDE_LEAF", "1") == "1":
        return cuda_getrf.MAX_IB
    return min(ib, cuda_getrf.MAX_IB)


def _split(jw: int, lw: int) -> int:
    """Left half of a jw-wide recursion node: a whole number of leaves."""
    return min(((jw // 2) + lw - 1) // lw * lw, jw - 1)


def leaves(jw: int, lw: int) -> int:
    """Leaves (leaf launches) of the recursive panel of width jw."""
    if jw <= lw:
        return 1
    half = _split(jw, lw)
    return leaves(half, lw) + leaves(jw - half, lw)


def _leaf(strip: torch.Tensor, use_kernel: bool):
    """Factor one strip in place: (strip, pj, pivots)."""
    if use_kernel:
        return cuda_getrf.getrf_leaf(strip)
    cuda_getrf.getrf_leaf_plain.fallbacks += 1
    return cuda_getrf.getrf_leaf_plain(strip)


def _panel_lu_rec(panel: torch.Tensor, ib: int | None = None):
    """Recursive blocked partial-pivoting LU (LAPACK xGETRF2's shape) of an
    (m, nb) panel, IN PLACE (panel may be a window of the workspace):
    factor the left half, pivot-gather + unit-lower solve + gemm on the
    right half, factor the right half, back-apply its pivots to the left.
    The rank-1 elimination runs only in the leaves, each one getrf_leaf
    call (the CUDA kernel on a CUDA tensor, its plain version on a CPU
    tensor; CAPITAL_LU_LEAF=jax asks for the plain version everywhere,
    counted as a fallback).

    Returns (panel, perm (m,), pivots (nb,)), lax.linalg.lu's convention:
    panel rows are permuted, panel = input[perm]."""
    m, nb = panel.shape
    use_kernel = os.environ.get("CAPITAL_LU_LEAF", "auto") != "jax"
    lw = leaf_width(panel.is_cuda, ib)
    pivots = torch.empty(nb, dtype=torch.int32, device=panel.device)

    def rec(j0: int, jw: int) -> torch.Tensor:
        """Factor columns [j0, j0+jw) over rows [j0, m); returns the local
        row permutation of [j0, m)."""
        if jw <= lw:
            _, pj, piv = _leaf(panel[j0:, j0:j0 + jw], use_kernel)
            pivots[j0:j0 + jw] = piv + j0
            return pj
        half = _split(jw, lw)
        pj1 = rec(j0, half)
        right = panel[j0:, j0 + half:j0 + jw]
        right.copy_(right.index_select(0, pj1))
        l11 = panel[j0:j0 + half, j0:j0 + half]
        u12 = torch.linalg.solve_triangular(l11, right[:half], upper=False,
                                            unitriangular=True)
        right[:half].copy_(u12)
        l21 = panel[j0 + half:, j0:j0 + half]
        right[half:].sub_(_pdot(l21, u12, precision="highest")
                          .to(panel.dtype))
        pj2 = rec(j0 + half, jw - half)
        left = panel[j0 + half:, j0:j0 + half]
        left.copy_(left.index_select(0, pj2))
        pj2f = torch.cat([torch.arange(half, dtype=pj2.dtype,
                                       device=pj2.device), pj2 + half])
        return pj1.index_select(0, pj2f)

    return panel, rec(0, nb), pivots


def _panel_lu(grid: Grid, panel: torch.Tensor):
    """(lu, perm, pivots) of a tall panel, rows of lu already permuted.

    CAPITAL_LU_PANEL: 'jax' runs the recursive panel everywhere; 'xla'
    runs lapack.lu (torch.linalg.lu_factor, counted as `lu_library`);
    'auto' is the recursive panel with the kernel leaf on the card (the
    JAX package's TPU route) and lapack.lu on the CPU (its CPU route). The
    recursive panel works in place when the panel is f32/f64; bf16 is
    factored in an f32 copy and rounded back."""
    mode = os.environ.get("CAPITAL_LU_PANEL", "auto")
    if mode == "jax" or (mode == "auto" and grid.platform == "gpu"):
        if panel.dtype in (torch.bfloat16, torch.float16):
            lu32, perm, pivots = _panel_lu_rec(panel.float())
            return lu32.to(panel.dtype), perm, pivots
        return _panel_lu_rec(panel)
    if mode not in ("auto", "xla"):
        raise ValueError(f"unknown CAPITAL_LU_PANEL {mode!r}")
    lu_pan, pivots, perm = lapack.lu(panel)
    return lu_pan, perm, pivots


def factor(grid: Grid, a, cfg: Config = Config()):
    """P A = L U. Returns (w, perm, sign):

      w:    the workspace whose strict lower triangle is L (unit diagonal
            implicit) and upper triangle is U;
      perm: (n,) int32 - row i of L@U is row perm[i] of A;
      sign: the permutation's sign (0-d tensor, for det/slogdet).

    A is copied into the workspace and left as it was. It must lie on the
    grid's device: the kernels run where the operand is."""
    arr = a.data if isinstance(a, DistMatrix) else a
    if arr.device != grid.device:
        raise ValueError(f"operand on {arr.device}, grid on {grid.device}")
    w = arr.clone()
    n = w.shape[0]
    nb = cfg.panel(grid, n)
    num_p = n // nb
    kw = dict(impl=cfg.summa_impl, num_chunks=cfg.summa_chunks,
              throttle=cfg.summa_throttle,
              collect_chunks=cfg.summa_collect_chunks)

    dev = w.device
    perm = torch.arange(n, dtype=torch.int32, device=dev)
    sign = torch.ones((), dtype=w.dtype, device=dev)
    esz = w.element_size()
    p_dev = max(grid.num_devices, 1)
    lookahead = os.environ.get("CAPITAL_LU_LOOKAHEAD", "0") == "1"
    target = int(os.environ.get("CAPITAL_LU_SCHUR_MB", "512")) * 2**20
    factored = None  # (pperm, pivots) of a panel the lookahead factored

    for k in range(num_p):
        off, mid = k * nb, (k + 1) * nb
        m_k = n - off
        n2 = n - mid

        # 1. panel factorization, in place in its window of w
        with tracing.phase("LU::panel"):
            tracing.record(
                "lu.panel", flops=m_k * nb * nb,
                comm_bytes=tracing.all_gather_bytes(m_k * nb * esz / p_dev,
                                                    p_dev),
                msgs=1)
            pan = w[off:, off:mid]
            if factored is None:
                lu_pan, pperm, pivots = _panel_lu(grid, pan)
                if lu_pan is not pan:
                    pan.copy_(lu_pan)
            else:
                pperm, pivots = factored
                factored = None

        # compose into the global perm; the sign from the pivot sequence
        # (pivots[i] != i <=> one swap)
        seg = perm[off:]
        seg.copy_(seg.index_select(0, pperm))
        swaps = torch.sum(pivots != torch.arange(pivots.shape[0],
                                                 device=dev))
        sign = sign * torch.where(swaps % 2 == 0, 1.0, -1.0).to(sign.dtype)

        # 2. laswp on the L-history and trailing columns, chunked in width
        with tracing.phase("LU::swap"):
            tracing.record("lu.swap",
                           comm_bytes=2.0 * m_k * (n - nb) * esz / p_dev,
                           msgs=1)
            for c0, c1 in ((0, off), (mid, n)):
                for j in range(c0, c1, _LASWP_COLS):
                    blk = w[off:, j:min(j + _LASWP_COLS, c1)]
                    blk.copy_(blk.index_select(0, pperm))

        if n2 == 0:
            break

        # 3. U row panel: U_k = L_kk^{-1} W[off:mid, mid:], f32-faithful
        with tracing.phase("LU::trsm"), default_matmul_precision("highest"):
            l_kk = torch.tril(w[off:mid, off:mid], -1) + torch.eye(
                nb, dtype=w.dtype, device=dev)
            l_inv = lapack.trtri(l_kk, lower=True)
            u_row = w[off:mid, mid:]
            u_row.copy_(summa.gemm(grid, l_inv, u_row, **kw))
            del l_kk, l_inv

        # 4. Schur update in row slabs of about CAPITAL_LU_SCHUR_MB, whole
        # multiples of nb. With lookahead, panel k+1's columns are updated
        # by a separate narrow gemm and factored before the remainder.
        with tracing.phase("LU::schur"):
            m2 = n - mid
            if lookahead and k + 1 < num_p:
                nxt = w[mid:, mid:mid + nb]
                nxt.sub_(summa.gemm(grid, w[mid:, off:mid], u_row[:, :nb],
                                    **kw))
                lu_nxt, pp, pv = _panel_lu(grid, nxt)
                if lu_nxt is not nxt:
                    nxt.copy_(lu_nxt)
                factored = (pp, pv)
                col0, n2r = mid + nb, n2 - nb
                u_rem = u_row[:, nb:]
            else:
                col0, n2r = mid, n2
                u_rem = u_row
            rc = m2
            if m2 * n2r * esz > target:
                rc = max(1, target // max(n2r * esz, 1)) // nb * nb
                rc = max(nb, rc)
            if n2r > 0:
                for j in range(0, m2, rc):
                    jr = min(rc, m2 - j)
                    lb = w[mid + j:mid + j + jr, off:mid]
                    w[mid + j:mid + j + jr, col0:].sub_(
                        summa.gemm(grid, lb, u_rem, **kw))

    return w, perm, sign


def unpack(w: torch.Tensor):
    """Dense (L, U) from the packed workspace."""
    n = w.shape[0]
    l = torch.tril(w, -1) + torch.eye(n, dtype=w.dtype, device=w.device)
    return l, torch.triu(w)


def solve_factored(grid: Grid, w, perm, b, trsm_cfg=None):
    """x = U^{-1} L^{-1} P b by two block substitutions (algs/trsm.py)
    that read the packed workspace directly. A 1-D b gives a 1-D x."""
    from capital_tpu_torch.algs import trsm

    if isinstance(b, DistMatrix):
        b = b.data
    vec = b.ndim == 1
    if vec:
        b = b[:, None]
    cfg = trsm_cfg or trsm.Config()
    pb = b.index_select(0, perm)
    y = trsm.solve(grid, w, pb, side="L", lower=True, unit_diag=True,
                   cfg=cfg)
    x = trsm.solve(grid, w, y, side="L", lower=False, cfg=cfg)
    return x[:, 0] if vec else x


def solve(grid: Grid, a, b, cfg: Config = Config(), trsm_cfg=None):
    """General square solve A x = b by P A = L U + two substitutions."""
    w, perm, _ = factor(grid, a, cfg)
    return solve_factored(grid, w, perm, b, trsm_cfg=trsm_cfg)


def slogdet(grid: Grid, a, cfg: Config = Config()):
    """(sign, log|det A|) from the U diagonal and the permutation sign."""
    w, _, psign = factor(grid, a, cfg)
    d = torch.diagonal(w)
    sign = psign * torch.prod(torch.sign(d))
    return sign, torch.sum(torch.log(torch.abs(d)))
