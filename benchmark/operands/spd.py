"""spd: (U + U^T) / 2 + n I with U uniform in (-0.5, 0.5), n = dims["n"]:
SPD and diagonally dominant, as capital_tpu_torch.matrix.symmetric. Made
whole on one device; a world of ranks is refused."""

from __future__ import annotations

import torch


def make(dims: dict, seed: int, device, dtype, rank: int,
         ranks: int) -> torch.Tensor:
    if ranks != 1:
        raise ValueError("an SPD operand is made on one device")
    n = dims["n"]
    u = torch.rand((n, n), generator=torch.Generator(device=device)
                   .manual_seed(seed), device=device, dtype=dtype)
    u.sub_(0.5)
    a = u + u.T
    del u
    a.mul_(0.5)
    a.diagonal().add_(float(n))
    return a
