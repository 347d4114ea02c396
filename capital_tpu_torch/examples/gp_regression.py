"""Gaussian-process regression on the solver stack (counterpart of
examples/gp_regression.py): one SPD kernel matrix, one factorization,
three consumers.

    K = k(X, X) + sigma_n^2 I            (RBF kernel)
    R, Rinv = cholinv.factor(K)          (one factorization...)
    alpha = K^{-1} y                     (...three consumers)
    log p(y|X) = -1/2 y^T alpha - sum log R_ii - n/2 log 2pi
    mean* = k(X*, X) alpha
    var*  = k(X*,X*) - ||R^{-T} k(X,X*)||^2 column-wise

    python -m capital_tpu_torch.examples.gp_regression [cpu]

The draws come from a torch.Generator (seed 0), so the figures differ
from the JAX example's; its bounds hold: posterior RMSE against the
latent function below 3 x the noise, 2-sigma coverage above 85 %.
"""

import math
import sys

import torch

from capital_tpu_torch import linalg
from capital_tpu_torch.algs import cholinv
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.parallel import summa


def rbf(xa, xb, ell):
    d2 = (torch.sum(xa**2, 1)[:, None] + torch.sum(xb**2, 1)[None, :]
          - 2.0 * xa @ xb.T)
    return torch.exp(-0.5 * d2 / (ell * ell))


def main(device=None) -> dict:
    grid = Grid.square(c=1, d=1, device=device)
    print(f"grid {grid.shape} on {grid.platform}")
    dev = grid.device

    n, n_star, dim, ell, noise = 2048, 256, 4, 0.8, 0.1
    gen = torch.Generator(device=dev).manual_seed(0)

    def unif(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 4.0 - 2.0

    x, x_star, centers = unif(n, dim), unif(n_star, dim), unif(16, dim)
    f = lambda pts: torch.sum(rbf(pts, centers, 1.0), dim=1)  # noqa: E731
    y = f(x) + noise * torch.randn(n, generator=gen, device=dev)

    k_mat = rbf(x, x, ell) + (noise**2) * torch.eye(n, device=dev)

    # one factorization, three consumers
    cfg = cholinv.Config(min_bc=64, base_method="auto")
    r, rinv = cholinv.factor(grid, k_mat, cfg)

    alpha = linalg.spd_solve(grid, k_mat, y[:, None], cfg=cfg, refine=1,
                             factor=(r, rinv))
    _, logdet = linalg.slogdet_spd(grid, k_mat, cfg, factor=(r, rinv))
    logdet = float(logdet)
    lml = (-0.5 * float(y @ alpha[:, 0])
           - 0.5 * logdet - 0.5 * n * math.log(2 * math.pi))
    print(f"log marginal likelihood = {lml:.2f} "
          f"(logdet via the factor's diagonal = {logdet:.2f})")

    # posterior mean + variance at test points
    k_star = rbf(x_star, x, ell)                       # (n*, n)
    mean = k_star @ alpha[:, 0]
    # var_i = 1 - || R^{-T} k_i ||^2: one trmm against the explicit inverse
    v = summa.trmm(grid, rinv, k_star.T.contiguous(), side="L", uplo="U",
                   trans_a=True)
    var = 1.0 + noise**2 - torch.sum(v.double() ** 2, dim=0)

    f_true = f(x_star)
    err = (mean - f_true).double()
    rmse = float(torch.sqrt(torch.mean(err**2)))
    inside = float(torch.mean((err.abs() <= 2.0 * torch.sqrt(
        torch.clamp(var, min=1e-9))).double()))
    print(f"posterior RMSE vs true latent = {rmse:.3f} "
          f"(noise floor {noise}); 2-sigma coverage = {inside:.2%}")
    assert rmse < 3 * noise, rmse
    assert inside > 0.85, inside
    return {"lml": lml, "logdet": logdet, "rmse": rmse, "coverage": inside,
            "rmse_bound": 3 * noise, "coverage_min": 0.85}


if __name__ == "__main__":
    main(*sys.argv[1:2])
