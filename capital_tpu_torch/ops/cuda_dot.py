"""Tile product at a chosen matmul precision (counterpart of
capital_tpu/ops/pallas_dot.py: canonicalize, _split_f32, tile_dot).

On the card the ladder is part of the product kernels of TRMM and SYRK
(`csrc/hopper_mma.cuh`: the pack pass splits each operand once, the
tensor-core or FFMA product sums the passes); it is not launched on its
own. Here is its plain PyTorch version, which the plain versions of those
kernels call tile by tile:

  highest  f32 product (FFMA on the card, never TF32)
  high     hi = RNE bf16(x), lo = bf16(x - hi); hi*hi + (hi*lo + lo*hi),
           each pass bf16 x bf16 with f32 accumulation
  default  one bf16 pass
  bf16 inputs always take one pass.

`lo` is rounded to bf16 here, as the card's tensor cores (and the TPU's
MXU) round it. JAX's DEFAULT-precision dots on a CPU keep lo in f32, so
JAX's tile_dot on a CPU differs from this at 'high' by a few 1e-6
(relative Frobenius, 512-deep contraction).
"""

from __future__ import annotations

import torch

from capital_tpu_torch.ops.precision import (HIGHEST, canonicalize, passes,
                                             split_f32)

__all__ = ["canonicalize", "split_f32", "tile_dot_plain"]


def tile_dot_plain(a: torch.Tensor, b: torch.Tensor,
                   contract_dim0: bool = False, prec=HIGHEST) -> torch.Tensor:
    """f32-accumulated `a @ b` (or `a.T @ b` when contract_dim0)."""
    level = canonicalize(prec)
    if contract_dim0:
        a = a.T
    if a.dtype != torch.bfloat16 and level == HIGHEST:
        return torch.matmul(a.float(), b.float())
    ps = [torch.matmul(x, y) for x, y in passes(a, b, level)]
    return ps[0] if len(ps) == 1 else ps[0] + (ps[1] + ps[2])
