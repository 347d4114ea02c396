"""tall_skinny: dims["m"] x dims["n"], U uniform in (-0.5, 0.5) with
column j scaled by linspace(1, 2, n)[j], as
capital_tpu_torch.matrix.tall_skinny. Over ranks, blocks of rows: each
rank makes its m / ranks rows from its own seed (the operand is those
blocks stacked in rank order, not the one-rank operand cut up)."""

from __future__ import annotations

import torch


def make(dims: dict, seed: int, device, dtype, rank: int,
         ranks: int) -> torch.Tensor:
    m, n = dims["m"], dims["n"]
    if m % ranks:
        raise ValueError(f"{m} rows do not split over {ranks} ranks")
    a = torch.rand((m // ranks, n), generator=torch.Generator(
        device=device).manual_seed(seed), device=device, dtype=dtype)
    a.sub_(0.5)
    a.mul_(torch.linspace(1.0, 2.0, n, dtype=dtype, device=device))
    return a
