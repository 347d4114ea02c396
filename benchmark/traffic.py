"""The one generator of the benchmark's traffic.

A traffic mix (traffic/<name>.json) is a closed loop: `callers` callers
(one; one a rank in a world), each calling the configuration's entry and
waiting for its result before the next call, over a pool of `pool`
operands made at set-up and taken in turn. Its keys:

  loop     "closed"
  callers  1
  pool     operands in the pool; calls alternate over them
  shape    the operand's sizes that the mix sets (the configuration sets
           the rest): {"n": ...} for a square operand, {"m": ...} rows of
           a tall-skinny one
  sample   which call's answer is compared with the reference once the
           window has closed: {"among": [lo, hi]} draws it from the seed
           among calls lo .. hi - 1 (the last call when the window ends
           before it), "last" takes the window's last call (a cell whose
           memory holds no second answer)

Operands are made on the device from the seed, in the class the
configuration names under `operand`: operands/<class>.py, found by name
(its docstring states what it makes and its layout over ranks). Operand
k of the pool on rank r is drawn from mix(seed, k, r); in a world each
rank makes its own block, and the reference reads the same blocks.
"""

from __future__ import annotations

import random

import torch

from benchmark import spec

_MASK = (1 << 64) - 1


def mix(*parts: int) -> int:
    """A 63-bit seed from whole numbers (SplitMix64 over each part), so
    that operands, ranks and seeds of any size draw apart."""
    z = 0x9E3779B97F4A7C15
    for p in parts:
        z = (z + (int(p) & _MASK) + 0x9E3779B97F4A7C15) & _MASK
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        z ^= z >> 31
    return z >> 1


def make(operand: str, dims: dict, seed: int, device,
         dtype=torch.float32, rank: int = 0, ranks: int = 1) -> torch.Tensor:
    """Rank `rank`'s part of one operand of class `operand`
    (operands/<operand>.py) over `ranks`, drawn from `seed`."""
    return spec.load("operands", operand).make(dims, seed, device, dtype,
                                               rank, ranks)


def shape(config: dict, traffic: dict) -> dict:
    """The operand's sizes: the configuration's, then the mix's."""
    return {**config.get("shape", {}), **traffic["shape"]}


def operands(config: dict, traffic: dict, seed: int, device,
             rank: int = 0, ranks: int = 1) -> list:
    """The pool: this rank's block of each operand."""
    if traffic["loop"] != "closed" or traffic["callers"] != 1:
        raise ValueError("the generator makes closed loops of one caller")
    dims = shape(config, traffic)
    dtype = getattr(torch, config["dtype"])
    return [make(config["operand"], dims, mix(seed, k, rank), device, dtype,
                 rank, ranks) for k in range(traffic["pool"])]


def sample_index(traffic: dict, seed: int) -> int | None:
    """The call whose answer is compared; None: the window's last."""
    rule = traffic["sample"]
    if rule == "last":
        return None
    lo, hi = rule["among"]
    return random.Random(mix(seed, 0x5A17)).randrange(lo, hi)
