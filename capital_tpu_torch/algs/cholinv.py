"""Recursive Cholesky + simultaneous triangular inverse (counterpart of
capital_tpu/algs/cholinv.py).

    rec(A, n):
      n <= bc:  base case - fused chol + inverse of the block       [leaf]
      else:
        R11, R11inv = rec(A[:n1,:n1])
        R12  = R11inv^T @ A[:n1,n1:]          # TRSM step   -> summa.trmm
        S    = A[n1:,n1:] - R12^T R12         # Schur       -> summa.syrk
        R22, R22inv = rec(S)
        R12inv = -R11inv @ R12 @ R22inv       # inverse assembly, 2 trmms

The recursion runs on two full-size workspaces, W (the copied input, whose
upper triangle becomes R) and Rinv. Operands are windows of them, handed
to the kernels as strided views; results are written back with copy_.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.matrix import DistMatrix
from capital_tpu_torch.ops import lapack
from capital_tpu_torch.parallel import summa


class BasePolicy(enum.Enum):
    """Base-case compute placement. On one device all four are the same
    schedule: the only device factors the leaf (REPLICATED)."""

    REPLICATED = "replicated"
    LAYER = "layer"
    GATHER = "gather"
    GATHER_OVERLAP = "gather_overlap"


@dataclass(frozen=True)
class Config:
    """The JAX package's cholinv.Config, field for field.

    split:        recursion split exponent - top-left block is n >> split.
    bc_mult:      base-case dim = (d*c) << bc_mult, at least min_bc.
    complete_inv: assemble the off-diagonal R12inv blocks at the top level.
    base_method:  leaf kernel ('pallas' = the hand-written fused leaf,
                  'xla' = torch.linalg, 'auto'); see ops/lapack.py.
    base_policy:  where the leaf is factored (BasePolicy or its value).
    summa_impl, summa_chunks, summa_throttle, summa_collect_chunks:
                  distributed schedule knobs; no effect on one device.
    remat:        accepted for parity; the eager recursion keeps no
                  intermediates to checkpoint, so it changes nothing.
    lower:        False -> A = R^T R (upper R); True -> A = L L^T.
    min_bc:       smallest base case.
    """

    split: int = 1
    bc_mult: int = 0
    complete_inv: bool = True
    base_method: str = "auto"
    base_policy: BasePolicy = BasePolicy.REPLICATED
    summa_impl: str = "shard_map"
    summa_chunks: int = 1
    summa_throttle: bool = False
    summa_collect_chunks: int = 1
    remat: bool = False
    lower: bool = False
    min_bc: int = 512

    def __post_init__(self):
        if isinstance(self.base_policy, str):
            object.__setattr__(self, "base_policy",
                               BasePolicy(self.base_policy))

    def base_dim(self, grid: Grid, n: int) -> int:
        base = max(self.min_bc, grid.d * grid.c)
        bc = (base >> -self.bc_mult if self.bc_mult < 0
              else base << self.bc_mult)
        return min(max(bc, 1), n)


def _policy_axes(grid: Grid, policy: BasePolicy) -> tuple:
    """Grid axes whose index must be 0 for a device to compute the leaf;
    on one device no axis has more than one member, so always ()."""
    return ()


def _base_case(grid: Grid, a: torch.Tensor, cfg: Config):
    """Leaf factorization: on one device every policy is REPLICATED."""
    if _policy_axes(grid, cfg.base_policy):
        raise NotImplementedError("root-only leaf placement needs more than "
                                  "one device (ROADMAP queue M, item M11)")
    return lapack.chol_inv(a, lower=False, method=cfg.base_method,
                           platform=grid.platform)


def _rec(grid: Grid, w: torch.Tensor, ri: torch.Tensor, off: int, n: int,
         bc: int, cfg: Config, top: bool) -> None:
    """Factor the (off, off, n, n) block of W in place: its upper triangle
    becomes R and the same block of Rinv becomes R^{-1}."""
    end = off + n
    if n <= bc:
        with tracing.phase("CI::factor_diag"):
            esz = w.element_size()
            tracing.record(
                "base_case", flops=2.0 * n**3 / 3.0,
                comm_bytes=tracing.all_gather_bytes(
                    n * n * esz / max(grid.d1 * grid.d2, 1),
                    grid.d1 * grid.d2),
                msgs=1)
            rb, rib = _base_case(grid, w[off:end, off:end], cfg)
            w[off:end, off:end].copy_(rb)
            ri[off:end, off:end].copy_(rib)
        return

    n1 = max(bc, n >> cfg.split)
    n2 = n - n1
    mid = off + n1
    _rec(grid, w, ri, off, n1, bc, cfg, False)

    kw = dict(impl=cfg.summa_impl, num_chunks=cfg.summa_chunks,
              throttle=cfg.summa_throttle,
              collect_chunks=cfg.summa_collect_chunks)

    # TRSM step: R12 = R11^{-T} A12. The product reads A12 and must not
    # write over it while it runs: it lands in a fresh tensor first.
    with tracing.phase("CI::trsm"):
        r12 = summa.trmm(grid, ri, w, side="L", uplo="U", trans_a=True,
                         a_window=(off, off, n1, n1),
                         b_window=(off, mid, n1, n2), **kw)
    w[off:mid, mid:end].copy_(r12)
    del r12

    # Schur update: A22 <- A22 - R12^T R12 (elementwise epilogue in place)
    with tracing.phase("CI::tmu"):
        g = summa.syrk(grid, w, a_window=(off, mid, n1, n2), **kw)
        w[mid:end, mid:end].sub_(g)
    del g

    _rec(grid, w, ri, mid, n2, bc, cfg, False)

    if cfg.complete_inv or not top:
        # R12inv = -R11inv @ R12 @ R22inv
        with tracing.phase("CI::inv"):
            t = summa.trmm(grid, ri, w, side="R", uplo="U",
                           a_window=(mid, mid, n2, n2),
                           b_window=(off, mid, n1, n2), **kw)
            r12inv = summa.trmm(grid, ri, t, side="L", uplo="U", alpha=-1.0,
                                a_window=(off, off, n1, n1), **kw)
            del t
        ri[off:mid, mid:end].copy_(r12inv)


def factor(grid: Grid, a, cfg: Config = Config()):
    """Factor a (padded) SPD matrix: returns (R, Rinv), dense upper-
    triangular-valued tensors (or (L, Linv) when cfg.lower). A is copied
    into the workspace and left as it was. A must lie on the grid's
    device: the kernels run where the operand is."""
    arr = a.data if isinstance(a, DistMatrix) else a
    if arr.device != grid.device:
        raise ValueError(f"operand on {arr.device}, grid on {grid.device}")
    n = arr.shape[0]
    bc = cfg.base_dim(grid, n)
    w = arr.clone()
    rinv = torch.zeros_like(arr)
    _rec(grid, w, rinv, 0, n, bc, cfg, True)
    r = w.triu_()  # W's upper triangle IS R
    if cfg.lower:
        r = summa.transpose(grid, r, impl=cfg.summa_impl)
        rinv = summa.transpose(grid, rinv, impl=cfg.summa_impl)
    return r, rinv


def construct_r(r: torch.Tensor, shape=None) -> torch.Tensor:
    """Dense masked export."""
    out = torch.triu(r)
    if shape is not None:
        out = out[: shape[0], : shape[1]]
    return out


def construct_rinv(rinv: torch.Tensor, shape=None) -> torch.Tensor:
    return construct_r(rinv, shape)
