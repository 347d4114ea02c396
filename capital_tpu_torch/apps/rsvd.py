"""Randomized SVD / PCA over CholeskyQR2 (counterpart of
capital_tpu/apps/rsvd.py), on one device.

The Halko-Martinsson-Tropp range finder [arXiv:0909.4061], every dense
step drawn from the framework:

  * range sketch Y = A @ Omega           - a plain product,
  * orthonormalization of tall-skinny Y  - CholeskyQR2 (`cacqr.factor_1d`:
    the SYRK kernel for the Gram, TRMM side='R' for Q, TRMM side='L' for
    R = R2 R1; the Cholesky leaf where 128 | l <= 1024),
  * subspace iteration                   - A^T Q by `cacqr.apply_q(trans=
    True)`, a small replicated CholeskyQR2, then A @ Z,
  * core B = Q^T A and its thin SVD      - `apply_q` and torch.linalg.svd
    (in f64 on a CUDA tensor, F8).

Mixed precision, as in the JAX package: the wide m-row operands stay in
A's dtype, and every skinny l-column intermediate (the sketch, Q, the
projections) is f32, since CholeskyQR needs cond^2 < 1/eps and bf16's eps
would cap the sketch at cond ~ 10.

The test matrix Omega is a Gaussian from a torch.Generator seeded 0x5EED
on A's device (`_omega`): a call is repeatable, but Omega is not
jax.random's, so the factors agree with the JAX package's only to the
accuracy of the algorithm, unless the caller supplies the same Omega.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from capital_tpu_torch import tracing
from capital_tpu_torch.algs import cacqr
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.ops import blas, lapack
from capital_tpu_torch.ops.precision import dot as _pdot

OMEGA_SEED = 0x5EED


@dataclass(frozen=True)
class Config:
    """k: target rank. oversample: extra sketch columns (l = k +
    oversample). power_iters: subspace-iteration passes q; each adds two
    m*n*l-flop products and one CholeskyQR2. qr: the nested CholeskyQR2
    config."""

    k: int = 64
    oversample: int = 8
    power_iters: int = 1
    qr: cacqr.Config = field(default_factory=lambda: cacqr.Config(num_iter=2))

    @property
    def l(self) -> int:
        return self.k + self.oversample


def _omega(n: int, l: int, device) -> torch.Tensor:
    """The sketch's (n, l) f32 Gaussian test matrix, from a generator
    seeded OMEGA_SEED on `device`."""
    gen = torch.Generator(device=device).manual_seed(OMEGA_SEED)
    return torch.randn((n, l), generator=gen, device=device,
                       dtype=torch.float32)


def _orth_replicated(z: torch.Tensor) -> torch.Tensor:
    """CholeskyQR2 of a small replicated (n, l) block: two sweeps of G =
    Z^T Z (f32), lower L with G = L L^T (NaN where G is not positive
    definite, as lax.linalg.cholesky), Z <- Z L^-T."""
    def sweep(y):
        g = _pdot(y.T, y, preferred_element_type=torch.float32)
        lo = lapack._cholesky(g)
        yq = torch.linalg.solve_triangular(lo.mT, y.float(), upper=True,
                                           left=False)
        return yq.to(y.dtype)

    return sweep(sweep(z))


def _core_svd(b: torch.Tensor):
    """Thin SVD (U_s, s, V^T) of the small (l, n) core B, returned in f32
    as the JAX package's f32 core returns it. On a CUDA tensor it is
    solved in f64 and rounded back: on an NVIDIA H100 the f32
    torch.linalg.svd of the cores of a 2^18 x 2048 (l = 144) and a
    2^19 x 4096 (l = 288) rSVD left U_s 2.8e-4 and 1.1e-3 from
    orthogonal (||U_s^T U_s - I||_F), where LAPACK's f32 SVD on the CPU
    leaves 1.2e-5 (ROADMAP fault F8)."""
    if b.is_cuda:
        return tuple(x.float() for x in torch.linalg.svd(
            b.double(), full_matrices=False))
    return torch.linalg.svd(b.float(), full_matrices=False)


def rsvd(grid: Grid, a, cfg: Config = Config()):
    """Rank-k truncated SVD: A ~= U @ diag(s) @ Vt.

    a: (m, n) tensor or DistMatrix on the grid's device, m >> l. Returns
    (U (m, k), s (k,), Vt (k, n)); for bf16/f16 storage the factors come
    back in f32, accumulation is always f32."""
    a = cacqr._operand(grid, a)
    m, n = a.shape
    l = min(cfg.l, n)
    if cfg.k > n:
        raise ValueError(f"rank k={cfg.k} exceeds n={n}")
    work = (torch.float32 if a.dtype in (torch.bfloat16, torch.float16)
            else a.dtype)

    p = max(grid.num_devices, 1)
    tracing.record(
        "rsvd.sketch+power",
        flops=2.0 * m * n * l * (2 * cfg.power_iters + 2) / p,
        comm_bytes=tracing.psum_bytes(4.0 * l * n, p) * (cfg.power_iters + 1),
        msgs=2 * (cfg.power_iters + 1),
    )

    omega = _omega(n, l, a.device)
    with tracing.phase("RSVD::sketch"):
        y = blas.gemm(a, omega.to(a.dtype)).to(work)
    with tracing.phase("RSVD::orth"):
        q, _ = cacqr.factor_1d(grid, y, cfg.qr)

    # subspace iteration: Q <- orth(A @ orth(A^T Q)), q times
    for _ in range(cfg.power_iters):
        with tracing.phase("RSVD::power"):
            z = cacqr.apply_q(grid, a, q, trans=True, cfg=cfg.qr,
                              layout="1d", out_dtype=work)
            z = _orth_replicated(z)
            y = blas.gemm(a, z.to(a.dtype)).to(work)
        with tracing.phase("RSVD::orth"):
            q, _ = cacqr.factor_1d(grid, y, cfg.qr)

    with tracing.phase("RSVD::core"):
        b = cacqr.apply_q(grid, q, a, trans=True, cfg=cfg.qr, layout="1d",
                          out_dtype=work)
        u_s, s, vt = _core_svd(b)
        u = blas.gemm(q, u_s[:, : cfg.k].to(q.dtype))
    return u, s[: cfg.k], vt[: cfg.k]


def pca(grid: Grid, a, cfg: Config = Config()):
    """Principal components of (m, n) data: (components (k, n),
    explained_variance (k,), mean (n,)). Centers the columns, then takes
    the rank-k rSVD; explained variance = s^2 / (m - 1)."""
    a = cacqr._operand(grid, a)
    m = a.shape[0]
    mean = torch.mean(a.float(), dim=0)
    centered = (a.float() - mean).to(a.dtype)
    _, s, vt = rsvd(grid, centered, cfg)
    return vt, (s * s) / max(m - 1, 1), mean
