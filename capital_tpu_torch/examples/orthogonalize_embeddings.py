"""Orthogonalize an embedding table and fit a retrieval model (counterpart
of examples/orthogonalize_embeddings.py):

1. a (2^16, 256) table is orthogonalized with CholeskyQR2 (two Grams,
   two Cholesky leaves, the rest TRMM);
2. a toy retrieval model is fitted with ALS (batched normal-equation
   Cholesky solves), then queries are scored against the item table.

    python -m capital_tpu_torch.examples.orthogonalize_embeddings [cpu]

The draws come from a torch.Generator, so the figures differ from the JAX
example's. Bounds: ||Q^T Q - I||_F / sqrt(n) below 1e-5, the observed ALS
RMSE below 0.08 (planted noise 0.05).
"""

import sys

import torch

from capital_tpu_torch import matrix, validate
from capital_tpu_torch.algs import cacqr
from capital_tpu_torch.apps import als
from capital_tpu_torch.grid import Grid

ORTHO_BOUND, RMSE_BOUND = 1e-5, 0.08


def main(device=None) -> dict:
    grid = Grid.rect(c=1, device=device)
    print(f"mesh: {grid.shape} over {grid.num_devices} devices")

    # --- 1. orthogonalize an embedding table ----------------------------
    num_emb, dim = 1 << 16, 256
    table = matrix.tall_skinny(grid, num_emb, dim, 0)
    q, r = cacqr.factor_1d(grid, table.data, cacqr.Config(num_iter=2))
    ortho = float(validate.qr_orthogonality(grid, q, layout="1d"))
    print(f"orthogonalized {num_emb}x{dim} table: "
          f"||Q^TQ - I||/sqrt(n) = {ortho:.2e}")
    del table, q, r

    # --- 2. fit a retrieval model with ALS -------------------------------
    users, items = 4096, 1024
    ratings, mask = als.synthetic_ratings(grid, users, items, 1, rank=8,
                                          density=0.1)
    cfg = als.Config(rank=32, lam=0.05, num_iters=6)
    u, v, rmse = als.fit(grid, ratings, mask, cfg)
    rmse = float(rmse)
    print(f"ALS fit {users}x{items} rank={cfg.rank}: "
          f"observed RMSE = {rmse:.4f}")

    # --- 3. retrieve: score a query batch against the items --------------
    queries = u[:8]  # pretend user embeddings are queries
    scores = queries @ v.T
    top = torch.argsort(-scores, dim=1)[:, :5]
    print("top-5 items for first 8 users:\n", top.cpu().numpy())
    assert ortho < ORTHO_BOUND, ortho
    assert rmse < RMSE_BOUND, rmse
    return {"orthogonality": ortho, "rmse": rmse, "top5": top.cpu(),
            "orthogonality_bound": ORTHO_BOUND, "rmse_bound": RMSE_BOUND}


if __name__ == "__main__":
    main(*sys.argv[1:2])
