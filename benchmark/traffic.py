"""The one generator of the benchmark's traffic.

A traffic mix (traffic/<name>.json) is a closed loop: `callers` callers
(one; one a rank in a world), each calling the configuration's entry and
waiting for its result before the next call, over a pool of `pool`
operands made at set-up and taken in turn. Its keys:

  loop     "closed"
  callers  1
  pool     operands in the pool; calls alternate over them
  shape    the operand's sizes that the mix sets (the configuration sets
           the rest): {"n": ...} for an SPD operand, {"m": ...} rows of a
           tall-skinny one
  sample   which call's answer is compared with the reference once the
           window has closed: {"among": [lo, hi]} draws it from the seed
           among calls lo .. hi - 1 (the last call when the window ends
           before it), "last" takes the window's last call (a cell whose
           memory holds no second answer)

Operands are made on the device from the seed with a torch.Generator, in
a few large calls, in the classes the port's own benches use:

  spd          (U + U^T) / 2 + n I, U uniform in (-0.5, 0.5): SPD and
               diagonally dominant, as capital_tpu_torch.matrix.symmetric
  tall_skinny  U uniform in (-0.5, 0.5), column j scaled by
               linspace(1, 2, n)[j], as matrix.tall_skinny

In a world each rank makes its own block of rows from a generator of its
own; the reference reads the same blocks.
"""

from __future__ import annotations

import random

import torch

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


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def spd(n: int, seed: int, device, dtype=torch.float32) -> torch.Tensor:
    u = torch.rand((n, n), generator=_generator(device, seed),
                   device=device, dtype=dtype)
    u.sub_(0.5)
    a = u + u.T
    del u
    a.mul_(0.5)
    a.diagonal().add_(float(n))
    return a


def tall_skinny(rows: int, n: int, seed: int, device,
                dtype=torch.float32) -> torch.Tensor:
    a = torch.rand((rows, n), generator=_generator(device, seed),
                   device=device, dtype=dtype)
    a.sub_(0.5)
    a.mul_(torch.linspace(1.0, 2.0, n, dtype=dtype, device=device))
    return a


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
    pool = []
    for k in range(traffic["pool"]):
        s = mix(seed, k, rank)
        if config["operand"] == "spd":
            if ranks != 1:
                raise ValueError("an SPD operand is made on one device")
            pool.append(spd(dims["n"], s, device, dtype))
        elif config["operand"] == "tall_skinny":
            m, n = dims["m"], dims["n"]
            if m % ranks:
                raise ValueError(f"{m} rows do not split over {ranks} ranks")
            pool.append(tall_skinny(m // ranks, n, s, device, dtype))
        else:
            raise ValueError(f"unknown operand class {config['operand']!r}")
    return pool


def sample_index(traffic: dict, seed: int) -> int | None:
    """The call whose answer is compared; None: the window's last."""
    rule = traffic["sample"]
    if rule == "last":
        return None
    lo, hi = rule["among"]
    return random.Random(mix(seed, 0x5A17)).randrange(lo, hi)
