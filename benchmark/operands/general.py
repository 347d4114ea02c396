"""general: HPL's test matrix, n x n (n = dims["n"]) uniform in
(-0.5, 0.5): a general square matrix on which LU with partial pivoting
pivots. Over ranks, blocks of rows, as tall_skinny: each rank makes its
n / ranks rows from its own seed (the operand is those blocks stacked in
rank order, not the one-rank operand cut up)."""

from __future__ import annotations

import torch


def make(dims: dict, seed: int, device, dtype, rank: int,
         ranks: int) -> torch.Tensor:
    n = dims["n"]
    if n % ranks:
        raise ValueError(f"{n} rows do not split over {ranks} ranks")
    a = torch.rand((n // ranks, n), generator=torch.Generator(
        device=device).manual_seed(seed), device=device, dtype=dtype)
    return a.sub_(0.5)
