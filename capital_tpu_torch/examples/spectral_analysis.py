"""Spectral-layer walkthrough: whitening, PCA and Procrustes alignment
(counterpart of examples/spectral_analysis.py).

1. ZCA-whiten a feature covariance: W = C^{-1/2} via linalg.spd_sqrt
   (the QDWH eigensolver under it), then check W C W ~= I.
2. PCA: the top 8 eigenpairs by eigh.eigh_partial, without the full
   spectrum.
3. Procrustes-align two embedding tables: the nearest orthogonal matrix
   to X^T Y is the polar factor (linalg.nearest_orthogonal, one QDWH
   sweep).

    python -m capital_tpu_torch.examples.spectral_analysis [cpu]

The draws come from a torch.Generator (the rotation from numpy, as in the
JAX example), so the figures differ from the JAX example's. Bounds, in
f64 on the host: ||W C W - I||_F / sqrt(n) below 1e-4 (the JAX example
prints 4.0e-5 on the CPU), the eigenpair residual ||C V - V diag(w)||_F
/ ||C||_F below 1e-5 and max |R - R_true| below 1e-5.
"""

import sys

import numpy as np
import torch

from capital_tpu_torch import linalg
from capital_tpu_torch.algs import cholinv, eigh, polar
from capital_tpu_torch.grid import Grid

ZCA_BOUND, EIG_BOUND, ROT_BOUND = 1e-4, 1e-5, 1e-5


def _np(x) -> np.ndarray:
    return x.detach().double().cpu().numpy()


def main(device=None) -> dict:
    grid = Grid.square(c=1, d=1, device=device)
    print(f"grid {grid.shape} on {grid.platform}")
    dev = grid.device

    dim, m = 256, 4096
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn(m, dim, generator=gen, device=dev) @ (
        torch.eye(dim, device=dev)
        + 0.3 * torch.randn(dim, dim, generator=gen, device=dev))
    cov = feats.T @ feats / m + 1e-3 * torch.eye(dim, device=dev)
    del feats

    chol = cholinv.Config(min_bc=64, base_method="auto")
    ecfg = eigh.Config(base_n=128, polar=polar.Config(compute_h=False,
                                                      chol=chol))

    # 1. ZCA whitening
    w = linalg.spd_sqrt(grid, cov, cfg=ecfg, inverse=True)
    c64 = _np(cov)
    wcw = _np(w) @ c64 @ _np(w)
    zca = float(np.linalg.norm(wcw - np.eye(dim)) / np.sqrt(dim))
    print(f"ZCA: ||W C W - I||/sqrt(n) = {zca:.2e}")

    # 2. PCA: top-8 eigenpairs without solving the full spectrum
    evals, evecs = eigh.eigh_partial(grid, cov, 8, ecfg, which="top")
    top = _np(evals)[::-1]
    print("PCA top-8 eigenvalues:", np.array2string(top, precision=3))
    res = float(np.linalg.norm(c64 @ _np(evecs) - _np(evecs) * _np(evals))
                / np.linalg.norm(c64))
    print(f"PCA eigenpair residual = {res:.2e}")

    # 3. Procrustes: rotate table X onto table Y
    x = torch.randn(m, dim, generator=gen, device=dev)
    rot_true, _ = np.linalg.qr(np.random.default_rng(3).standard_normal(
        (dim, dim)))
    y = x @ torch.as_tensor(rot_true, dtype=torch.float32, device=dev)
    c = x.T @ y
    pcfg = polar.Config(compute_h=False, chol=chol)
    r = linalg.nearest_orthogonal(grid, c, cfg=pcfg, layout="2d")
    err = float(np.abs(_np(r) - rot_true).max())
    print(f"Procrustes: max |R - R_true| = {err:.2e}")
    assert zca < ZCA_BOUND, zca
    assert res < EIG_BOUND, res
    assert err < ROT_BOUND, err
    return {"zca_residual": zca, "top_eigenvalues": top,
            "eigenpair_residual": res, "procrustes_err": err,
            "zca_residual_bound": ZCA_BOUND,
            "eigenpair_residual_bound": EIG_BOUND,
            "procrustes_err_bound": ROT_BOUND}


if __name__ == "__main__":
    main(*sys.argv[1:2])
