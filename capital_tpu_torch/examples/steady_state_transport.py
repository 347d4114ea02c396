"""General-solver walkthrough: steady-state advection-diffusion via LU
(counterpart of examples/steady_state_transport.py).

A nonsymmetric system, where Cholesky does not apply and partial pivoting
carries the solve: on the unit square

    -nu * Laplace(u) + (b . grad) u = f,   u = 0 on the boundary,

with upwind advection (the upwind stencil makes A nonsymmetric), as a
dense operator, and the direct-solver family off one factorization:

    w, perm, sign = lu.factor(grid, A)     (P A = L U)
    u  = lu.solve_factored(w, perm, f)     (steady state)
    u2 = lu.solve_factored(w, perm, f2)    (second forcing, free)
    logdet via lu.slogdet

plus two refinement sweeps (linalg.solve method='lu').

    python -m capital_tpu_torch.examples.steady_state_transport [cpu]

Bounds: relative error against numpy's f64 solve below 1e-3 (the JAX
example's assert); each solve's ||A u - f|| / ||f||, in f64 on the host,
below 1e-4 (the JAX example prints 1.0e-6 to 1.5e-6 on the CPU).
"""

import sys

import numpy as np
import torch

from capital_tpu_torch import linalg
from capital_tpu_torch.algs import lu
from capital_tpu_torch.grid import Grid

ERR_BOUND, RES_BOUND = 1e-3, 1e-4


def transport_operator(g: int, nu: float, bx: float, by: float):
    """Dense (g^2, g^2) upwind advection-diffusion operator on a g x g
    interior grid (Dirichlet boundary), h = 1/(g+1)."""
    h = 1.0 / (g + 1)
    n = g * g
    a = np.zeros((n, n), np.float32)
    idx = lambda i, j: i * g + j  # noqa: E731
    for i in range(g):
        for j in range(g):
            r = idx(i, j)
            # diffusion: 5-point Laplacian
            a[r, r] += 4.0 * nu / h**2
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < g and 0 <= jj < g:
                    a[r, idx(ii, jj)] -= nu / h**2
            # upwind advection (b > 0: backward differences)
            a[r, r] += (bx + by) / h
            if i > 0:
                a[r, idx(i - 1, j)] -= by / h
            if j > 0:
                a[r, idx(i, j - 1)] -= bx / h
    return a, h


def main(device=None) -> dict:
    grid = Grid.square(c=1, d=1, device=device)
    print(f"grid {grid.shape} on {grid.platform}")
    dev = grid.device

    g, nu, bx, by = 16, 0.05, 1.0, 0.5  # cell Peclet ~ b*h/nu ~ 1.2
    a_np, h = transport_operator(g, nu, bx, by)
    n = g * g
    print(f"operator: {n} x {n}, cell Peclet {bx * h / nu:.2f}, "
          f"nonsymmetry ||A-A^T||/||A|| = "
          f"{np.linalg.norm(a_np - a_np.T) / np.linalg.norm(a_np):.3f}")

    a = torch.as_tensor(a_np, device=dev)
    xs, ys = np.meshgrid(np.linspace(h, 1 - h, g), np.linspace(h, 1 - h, g),
                         indexing="ij")
    f1_np = np.exp(-60 * ((xs - 0.3) ** 2 + (ys - 0.3) ** 2)).ravel()
    f2_np = (xs * ys).ravel()
    f1 = torch.as_tensor(f1_np, dtype=torch.float32, device=dev)
    f2 = torch.as_tensor(f2_np, dtype=torch.float32, device=dev)
    a64 = a_np.astype(np.float64)

    def residual(u, f_np):
        u = u.double().cpu().numpy()
        return float(np.linalg.norm(a64 @ u - f_np) / np.linalg.norm(f_np))

    # one factorization, many consumers
    w, perm, sign = lu.factor(grid, a)
    u1 = lu.solve_factored(grid, w, perm, f1)
    u2 = lu.solve_factored(grid, w, perm, f2)
    res = {}
    for name, f_np, u in (("blob", f1_np, u1), ("poly", f2_np, u2)):
        res[name] = residual(u, f_np)
        print(f"steady state [{name}]: max u = {float(torch.max(u)):.4f}, "
              f"residual {res[name]:.2e}")

    # refined solve endpoint (2 sweeps against the original operand)
    x_ref = linalg.solve(grid, a, f1, method="lu", refine=2)
    res["refined"] = residual(x_ref, f1_np)
    print(f"refined solve: residual {res['refined']:.2e}")

    # slogdet (det > 0: the upwind operator is an M-matrix)
    s, logdet = lu.slogdet(grid, a)
    print(f"slogdet: sign {float(s):+.0f}, logdet {float(logdet):.2f}")

    # oracle check vs numpy's f64 solve
    u64 = np.linalg.solve(a64, f1_np)
    err = float(np.linalg.norm(u1.double().cpu().numpy() - u64)
                / np.linalg.norm(u64))
    print(f"vs f64 oracle: rel error {err:.2e}")
    assert err < ERR_BOUND, err
    assert max(res.values()) < RES_BOUND, res
    print("OK")
    return {"residuals": res, "max_residual": max(res.values()),
            "sign": float(s), "logdet": float(logdet), "oracle_err": err,
            "oracle_err_bound": ERR_BOUND, "max_residual_bound": RES_BOUND}


if __name__ == "__main__":
    main(*sys.argv[1:2])
