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
upper triangle becomes R) and Rinv. On one device operands are windows of
them, handed to the kernels as strided views; results are written back
with copy_. On a grid of more than one rank the workspaces are DArrays on
the (row, col) slice, windows are gathered (parallel/darray.py), every
product goes through the SUMMA engine, and the leaf is placed by
cfg.base_policy (`_base_case`). A grid of one rank inside a world takes
the one-device route.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.matrix import DistMatrix
from capital_tpu_torch.ops import lapack
from capital_tpu_torch.parallel import collectives as coll
from capital_tpu_torch.parallel import darray, summa


class BasePolicy(enum.Enum):
    """Base-case compute placement (`_base_case`):

    REPLICATED: every rank gathers the leaf block and factors it.
    LAYER: only the z == 0 depth layer factors it; a psum over depth of
        the result against the other layers' zeros broadcasts it.
    GATHER: only rank (0, 0, 0) factors it; a psum over the whole mesh
        broadcasts it.
    GATHER_OVERLAP: as GATHER, in two stages (potrf, then trtri) with R's
        broadcast started before the root's triangular inverse; the fused
        leaf kernel does not run (its stages must be apart to overlap).
    On one device all four are the same schedule."""

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
    """Mesh axes whose index must be 0 for a rank to compute the leaf;
    () = every rank computes (REPLICATED, or no axis of more than one
    member)."""
    if grid.mesh is None:
        return ()
    shape = grid.mesh.shape
    if policy in (BasePolicy.GATHER, BasePolicy.GATHER_OVERLAP):
        return tuple(ax for ax in (grid.ax_z, grid.ax_y, grid.ax_x)
                     if ax is not None and shape[ax] > 1)
    if policy is BasePolicy.LAYER:
        if grid.ax_z is not None and grid.c > 1:
            return (grid.ax_z,)
    return ()


def _base_case(grid: Grid, a, cfg: Config):
    """Leaf factorization. On one device: the leaf of `a`. On a mesh: the
    block gathered whole (the all-gather on the slice axes), factored
    where cfg.base_policy says, broadcast from the root(s) as a psum
    against zeros, and returned as DArrays of the slice spec."""
    if grid.mesh is None:
        return lapack.chol_inv(a, lower=False, method=cfg.base_method,
                               platform=grid.platform)
    mesh = grid.mesh
    a_rep = darray.to_global(a)
    axes = _policy_axes(grid, cfg.base_policy)
    if not axes:
        r, rinv = lapack.chol_inv(a_rep, lower=False, method=cfg.base_method,
                                  platform=grid.platform)
    else:
        root = all(mesh.coord[ax] == 0 for ax in axes)
        if cfg.base_policy is BasePolicy.GATHER_OVERLAP:
            r_l = (lapack.potrf(a_rep, lower=False) if root
                   else torch.zeros_like(a_rep))
            r_sum = coll.psum_async(r_l, mesh, axes)
            ri_l = (lapack.trtri(r_l, lower=False) if root
                    else torch.zeros_like(a_rep))
            rinv = coll.psum(ri_l, mesh, axes)
            r = r_sum.wait()
        else:
            if root:
                r_l, ri_l = lapack.chol_inv(a_rep, lower=False,
                                            method=cfg.base_method,
                                            platform=grid.platform)
            else:
                r_l = ri_l = torch.zeros_like(a_rep)
            r = coll.psum(r_l, mesh, axes)
            rinv = coll.psum(ri_l, mesh, axes)
    spec = grid.slice_spec
    return (darray.distribute(r, mesh, spec),
            darray.distribute(rinv, mesh, spec))


def _record_leaf(grid: Grid, n: int, esz: int) -> None:
    tracing.record(
        "base_case", flops=2.0 * n**3 / 3.0,
        comm_bytes=tracing.all_gather_bytes(
            n * n * esz / max(grid.d1 * grid.d2, 1), grid.d1 * grid.d2),
        msgs=1)


def _rec(grid: Grid, w: torch.Tensor, ri: torch.Tensor, off: int, n: int,
         bc: int, cfg: Config, top: bool) -> None:
    """Factor the (off, off, n, n) block of W in place: its upper triangle
    becomes R and the same block of Rinv becomes R^{-1}."""
    end = off + n
    if n <= bc:
        with tracing.phase("CI::factor_diag"):
            _record_leaf(grid, n, w.element_size())
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


def _rec_mesh(grid: Grid, w, ri, off: int, n: int, bc: int, cfg: Config,
              top: bool) -> None:
    """_rec on DArray workspaces: each window gathered for the engine,
    each result written back into the ranks' blocks (set_window)."""
    end = off + n
    if n <= bc:
        with tracing.phase("CI::factor_diag"):
            _record_leaf(grid, n, w.local.element_size())
            rb, rib = _base_case(grid, darray.window(w, (off, off, n, n)),
                                 cfg)
            darray.set_window(w, (off, off), rb)
            darray.set_window(ri, (off, off), rib)
        return
    n1 = max(bc, n >> cfg.split)
    n2 = n - n1
    mid = off + n1
    _rec_mesh(grid, w, ri, off, n1, bc, cfg, False)
    kw = dict(impl=cfg.summa_impl, num_chunks=cfg.summa_chunks,
              throttle=cfg.summa_throttle,
              collect_chunks=cfg.summa_collect_chunks)
    with tracing.phase("CI::trsm"):
        r12 = summa.trmm(grid, ri, w, side="L", uplo="U", trans_a=True,
                         a_window=(off, off, n1, n1),
                         b_window=(off, mid, n1, n2), **kw)
    darray.set_window(w, (off, mid), r12)
    del r12
    with tracing.phase("CI::tmu"):
        a22 = darray.window(w, (mid, mid, n2, n2))
        s = summa.syrk(grid, w, c=a22, alpha=-1.0, beta=1.0,
                       a_window=(off, mid, n1, n2), **kw)
    darray.set_window(w, (mid, mid), s)
    del s, a22
    _rec_mesh(grid, w, ri, mid, n2, bc, cfg, False)
    if cfg.complete_inv or not top:
        with tracing.phase("CI::inv"):
            t = summa.trmm(grid, ri, w, side="R", uplo="U",
                           a_window=(mid, mid, n2, n2),
                           b_window=(off, mid, n1, n2), **kw)
            r12inv = summa.trmm(grid, ri, t, side="L", uplo="U", alpha=-1.0,
                                a_window=(off, off, n1, n1), **kw)
            del t
        darray.set_window(ri, (off, mid), r12inv)


def _factor_local(grid: Grid, arr: torch.Tensor, cfg: Config):
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


def factor(grid: Grid, a, cfg: Config = Config()):
    """Factor a (padded) SPD matrix: returns (R, Rinv), dense upper-
    triangular-valued (or (L, Linv) when cfg.lower). A is copied into the
    workspace and left as it was.

    One device: A a tensor on the grid's device (the kernels run where
    the operand is). On a mesh: A a DArray or a tensor every rank holds
    whole; R and Rinv are DArrays of the slice spec. A mesh of one rank
    (or a view of one) runs the one-device route on its block."""
    arr = a.data if isinstance(a, DistMatrix) else a
    if grid.mesh is None:
        return _factor_local(grid, arr, cfg)
    mesh, spec = grid.mesh, grid.slice_spec
    if grid.num_devices == 1:  # the one-device route, on this rank
        local = Grid(device=grid.device, roles=grid.roles)
        r, rinv = _factor_local(local, darray.whole(arr), cfg)
        return darray.distribute(r, mesh, spec), darray.distribute(
            rinv, mesh, spec)
    n = arr.shape[0]
    bc = cfg.base_dim(grid, n)
    src = grid.constrain(arr, spec)
    w = src.with_local(src.local.clone())
    rinv = darray.zeros(src.shape, spec, mesh, src.dtype, src.device)
    _rec_mesh(grid, w, rinv, 0, n, bc, cfg, True)
    r = w.triu()
    if cfg.lower:
        r = summa.transpose(grid, r, impl=cfg.summa_impl)
        rinv = summa.transpose(grid, rinv, impl=cfg.summa_impl)
    return r, rinv


def construct_r(r, shape=None) -> torch.Tensor:
    """Dense masked export (a DArray gathered whole first)."""
    out = torch.triu(darray.to_global(r))
    if shape is not None:
        out = out[: shape[0], : shape[1]]
    return out


def construct_rinv(rinv: torch.Tensor, shape=None) -> torch.Tensor:
    return construct_r(rinv, shape)
