"""QDWH polar decomposition A = U H (counterpart of
capital_tpu/algs/polar.py), on one device.

X_0 = A / ||A||_F; given a lower bound l0 <= sigma_min(X_0), iterate

    X_{k+1} = X_k (b_k/c_k) + (a_k - b_k/c_k) X_k (I + c_k X_k^T X_k)^{-1}

with the dynamically weighted Halley coefficients (a_k, b_k, c_k) of the
scalar l-recurrence (Nakatsukasa, Bai & Gygi 2010). The weights depend
only on l0, so they are Python floats fixed before the first step. The
solve is the framework's own: Z = I + c X^T X is SPD and
X Z^{-1} = X Rinv Rinv^T, two triangular multiplies (TRMM side='R', then
side='R' transposed) against Z's explicit inverse factor. Steps whose
c_k exceeds qr_switch take the QR variant: a stacked CholeskyQR2 of
[sqrt(c) X; I]. One Newton-Schulz step polishes the result; H = U^T A,
symmetrized.

Layouts, as in the JAX package:
  * '2d' - the Gram through summa.syrk (the SYRK kernel), Z factored by
    the recursive cholinv (its TRMM, SYRK and Cholesky-leaf kernels);
  * '1d' - the Gram through cacqr.gram_1d, Z factored by lapack.chol_inv
    (torch.linalg above n = 1024, by design), the updates local TRMMs.
On one device every shard_map body is a direct call on the whole tensor.
Each step writes its new iterate over its last product and drops the
old one, so a call holds A and about four (m, n) iterates at once (the
TRMM's packed copy of B among them).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.algs import cacqr, cholinv
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.matrix import DistMatrix
from capital_tpu_torch.ops import blas, lapack
from capital_tpu_torch.ops.precision import DEFAULT, HIGH, canonicalize, prec
from capital_tpu_torch.ops.precision import dot as _pdot
from capital_tpu_torch.parallel import summa


@dataclass(frozen=True)
class Config:
    """The JAX package's polar.Config, field for field.

    l0:        lower bound on sigma_min(A)/||A||_F; None -> 1e-5 (f32) or
               1e-12 (f64).
    max_iter:  cap on QDWH steps; None -> until l has converged to 1 at
               the dtype's resolution (+1 step).
    ns_polish: Newton-Schulz steps X <- 1.5 X - 0.5 X (X^T X) after QDWH.
    qr_switch: steps with c_k above this take the stacked-CholeskyQR2
               variant.
    compute_h: also return H = U^T A (symmetrized).
    chol:      the nested cholinv config (the 2d Z-solve engine).
    """

    l0: float | None = None
    max_iter: int | None = None
    ns_polish: int = 1
    qr_switch: float = 100.0
    compute_h: bool = True
    chol: cholinv.Config = field(default_factory=cholinv.Config)

    def resolve_l0(self, dtype) -> float:
        if self.l0 is not None:
            return float(self.l0)
        return 1e-12 if dtype == torch.float64 else 1e-5


def qdwh_weights(l0: float, dtype, max_iter: int | None = None):
    """The (a_k, b_k, c_k) schedule as Python floats: stops when 1 - l_k
    falls below 10 eps of the dtype (one extra step of safety is the
    step that gets it there)."""
    eps = float(torch.finfo(dtype).eps)
    floor = 10.0 * eps
    out = []
    l = float(l0)
    cap = max_iter if max_iter is not None else 12
    for _ in range(cap):
        l2 = l * l
        d = (4.0 * (1.0 - l2) / (l2 * l2)) ** (1.0 / 3.0)
        a = math.sqrt(1.0 + d) + 0.5 * math.sqrt(
            max(8.0 - 4.0 * d + 8.0 * (2.0 - l2) / (l2 * math.sqrt(1.0 + d)),
                0.0))
        b = (a - 1.0) ** 2 / 4.0
        c = a + b - 1.0
        out.append((a, b, c))
        l = l * (a + b * l2) / (1.0 + c * l2)
        if max_iter is None and 1.0 - l < floor:
            break
    return out


def _gram_eps(dtype) -> float:
    """Rounding unit of a Gram taken at the active matmul precision, which
    the shifted-CholeskyQR shift must cover: f32 eps at 'highest', 8x that
    at 'high' (three bf16 passes), bf16 eps at 'default'."""
    eps = float(torch.finfo(dtype).eps)
    if dtype == torch.float32:
        p = canonicalize(prec())
        if p == HIGH:
            eps *= 8.0
        elif p == DEFAULT:
            eps = float(torch.finfo(torch.bfloat16).eps)
    return eps


def _combine(x: torch.Tensor, y: torch.Tensor, s: float,
             t: float) -> torch.Tensor:
    """s X + t Y, written over Y (the step's fresh product)."""
    return y.mul_(t).add_(x, alpha=s)


def _eye(n: int, x: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=x.dtype, device=x.device)


def _halley_step_2d(grid: Grid, x, a, b, c, chol_cfg):
    """X <- (b/c) X + (a - b/c) X (I + c X^T X)^{-1}."""
    impl = chol_cfg.summa_impl
    z = summa.syrk(grid, x, c=_eye(x.shape[1], x), alpha=c, beta=1.0,
                   impl=impl)
    _, rinv = cholinv.factor(grid, z, chol_cfg)
    del z
    y = summa.trmm(grid, rinv, x, side="R", uplo="U", impl=impl)
    y = summa.trmm(grid, rinv, y, side="R", uplo="U", trans_a=True,
                   impl=impl)
    return _combine(x, y, b / c, a - b / c)


def _cqr2_step_2d(grid: Grid, x, a, b, c, chol_cfg):
    """QR-variant Halley step by a stacked CholeskyQR2 of [sqrt(c) X; I]:
    X <- (b/c) X + ((a - b/c)/sqrt(c)) Q1 Q2^T. Pass 1's Gram is Z with
    the shifted-CholeskyQR shift delta (Fukaya et al. 2020), pass 2
    re-Grams the near-orthonormal stack; W = R1inv R2inv stays upper
    triangular, so Q1 Q2^T is a TRMM."""
    sc = math.sqrt(c)
    impl = chol_cfg.summa_impl
    delta = 20.0 * _gram_eps(x.dtype) * (1.0 + c)
    z = summa.syrk(grid, x, c=_eye(x.shape[1], x), alpha=c,
                   beta=1.0 + delta, impl=impl)
    _, r1inv = cholinv.factor(grid, z, chol_cfg)
    del z
    q1 = summa.trmm(grid, r1inv, (sc * x).to(x.dtype), side="R", uplo="U",
                    impl=impl)
    q2 = torch.triu(r1inv)
    del r1inv
    g2 = summa.syrk(grid, q1, impl=impl)
    g2 = summa.syrk(grid, q2, c=g2, beta=1.0, impl=impl)
    _, r2inv = cholinv.factor(grid, g2, chol_cfg)
    del g2
    q1 = summa.trmm(grid, r2inv, q1, side="R", uplo="U", impl=impl)
    w = summa.trmm(grid, r2inv, q2, side="R", uplo="U", impl=impl)
    y = summa.trmm(grid, torch.triu(w), q1, side="R", uplo="U", trans_a=True,
                   impl=impl)
    del q1
    return _combine(x, y, b / c, (a - b / c) / sc)


def _zsolve_1d(grid: Grid, x, cscale, cfg: Config, delta: float = 0.0):
    """(Z, Rinv of Z) for Z = (1 + delta) I + c X^T X. delta > 0 is the
    shifted-CholeskyQR shift of the QR-variant step."""
    n = x.shape[1]
    g = cacqr.gram_1d(grid, x, "allreduce", kernel="auto")
    acc = torch.promote_types(g.dtype, torch.float32)
    z = cscale * g.to(acc) + (1.0 + delta) * torch.eye(n, dtype=acc,
                                                       device=g.device)
    z = z.to(x.dtype)
    _, rinv = lapack.chol_inv(z, lower=False, platform=grid.platform)
    return z, rinv


def _apply_zinv_1d(grid: Grid, x, rinv):
    """X Rinv Rinv^T by two local TRMMs."""
    y = blas.trmm(rinv, x, side="R", uplo="U", platform=grid.platform)
    return blas.trmm(rinv, y, side="R", uplo="U", trans_a=True,
                     platform=grid.platform)


def _halley_step_1d(grid: Grid, x, a, b, c, cfg: Config):
    _, rinv = _zsolve_1d(grid, x, c, cfg)
    y = _apply_zinv_1d(grid, x, rinv)
    return _combine(x, y, b / c, a - b / c)


def _cqr2_step_1d(grid: Grid, x, a, b, c, cfg: Config):
    """1d QR-variant step (see _cqr2_step_2d): two Grams of the tall
    half, the n x n half and every factor local."""
    sc = math.sqrt(c)
    delta = 20.0 * _gram_eps(x.dtype) * (1.0 + c)
    _, r1inv = _zsolve_1d(grid, x, c, cfg, delta=delta)
    q2 = torch.triu(r1inv)
    q1 = blas.trmm(r1inv, (sc * x).to(x.dtype), side="R", uplo="U",
                   platform=grid.platform)
    del r1inv
    g2 = cacqr.gram_1d(grid, q1, "allreduce", kernel="auto")
    g2 = blas.syrk(q2, c=g2, beta=1.0, platform=grid.platform)
    _, r2inv = lapack.chol_inv(g2.to(x.dtype), lower=False,
                               platform=grid.platform)
    del g2
    # W = R1inv R2inv is upper triangular; Y = Q1 (Q2 R2inv)^T = Q1 W^T
    w = torch.triu(blas.trmm(r2inv, q2, side="R", uplo="U",
                             platform=grid.platform))
    q1 = blas.trmm(r2inv, q1, side="R", uplo="U", platform=grid.platform)
    y = blas.trmm(w, q1, side="R", uplo="U", trans_a=True,
                  platform=grid.platform)
    del q1
    return _combine(x, y, b / c, (a - b / c) / sc)


def _ns_polish(grid: Grid, x, layout: str, cfg: Config):
    """One Newton-Schulz step X <- 1.5 X - 0.5 X (X^T X)."""
    if layout == "1d":
        g = cacqr.gram_1d(grid, x, "allreduce", kernel="auto")
        xg = _pdot(x, g).to(x.dtype)
    else:
        g = summa.syrk(grid, x, impl=cfg.chol.summa_impl)
        xg = summa.gemm(grid, x, g, impl=cfg.chol.summa_impl)
    del g
    return _combine(x, xg, 1.5, -0.5)


def _resolve_layout(grid: Grid, x, layout: str) -> str:
    """'auto' is '2d' on one device, as in the JAX package."""
    if layout != "auto":
        return layout
    return "2d"


def polar(grid: Grid, a, cfg: Config = Config(), layout: str = "auto"):
    """A = U H: U (m, n), m >= n, with orthonormal columns, H (n, n)
    symmetric positive semidefinite. Returns (U, H), or U when
    cfg.compute_h is False. layout: '2d', '1d' or 'auto'. A is left as it
    was."""
    if isinstance(a, DistMatrix):
        a = a.data
    m, n = a.shape
    if m < n:
        raise ValueError(f"polar needs m >= n, got {tuple(a.shape)}")
    layout = _resolve_layout(grid, a, layout)

    alpha = torch.linalg.vector_norm(a, dtype=torch.float32)
    x = (a / alpha.to(a.dtype)).to(a.dtype)

    schedule = qdwh_weights(cfg.resolve_l0(a.dtype), a.dtype, cfg.max_iter)
    esz = a.element_size()
    with tracing.phase("POLAR::qdwh"):
        tracing.record(
            "qdwh",
            flops=len(schedule) * (2.0 * m * n * n + 2.0 * n**3 / 3.0
                                   + 2.0 * m * n * n) / grid.num_devices,
            comm_bytes=len(schedule) * tracing.psum_bytes(
                n * n * esz, grid.num_devices),
            msgs=len(schedule),
        )
        for (wa, wb, wc) in schedule:
            if wc > cfg.qr_switch:
                if layout == "1d":
                    x = _cqr2_step_1d(grid, x, wa, wb, wc, cfg)
                else:
                    x = _cqr2_step_2d(grid, x, wa, wb, wc, cfg.chol)
            elif layout == "1d":
                x = _halley_step_1d(grid, x, wa, wb, wc, cfg)
            else:
                x = _halley_step_2d(grid, x, wa, wb, wc, cfg.chol)
    with tracing.phase("POLAR::polish"):
        for _ in range(cfg.ns_polish):
            x = _ns_polish(grid, x, layout, cfg)

    if not cfg.compute_h:
        return x

    with tracing.phase("POLAR::formH"):
        if layout == "1d":
            h = cacqr.apply_q(grid, x, a, trans=True, layout="1d",
                              out_dtype=torch.promote_types(a.dtype,
                                                            torch.float32))
            h = h.to(a.dtype)
            h = 0.5 * (h + h.T)
        else:
            h = summa.syrk2(grid, x, a, impl=cfg.chol.summa_impl)
            ht = summa.transpose(grid, h, impl=cfg.chol.summa_impl)
            h = 0.5 * (h + ht)
    return x, h.to(a.dtype)


# The JAX package's jit-wrapped entry; the port runs eagerly, so it is the
# same function.
polar_jit = polar
