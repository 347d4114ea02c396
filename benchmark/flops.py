"""Useful flops of one call, by the formula a configuration names. Frozen
here, apart from the program, so that no change to the program moves
the yardstick.

  cholinv  2 n^3 / 3: the Cholesky factor (n^3 / 3) and the full
           triangular inverse (n^3 / 3)
  cacqr2   2 (4 m n^2 + 2 n^3 / 3): two CholeskyQR sweeps, each a Gram
           (2 m n^2, counted as a full product), Q = A R^-1 (2 m n^2) and
           the Gram's Cholesky and inverse (2 n^3 / 3); m the global rows
"""

from __future__ import annotations


def cholinv(n: int, **_) -> float:
    return 2.0 * n**3 / 3.0


def cacqr2(m: int, n: int, **_) -> float:
    return 2.0 * (4.0 * m * n * n + 2.0 * n**3 / 3.0)


FORMULAS = {"cholinv": cholinv, "cacqr2": cacqr2}


def per_call(config: dict, dims: dict) -> float:
    return FORMULAS[config["flops"]](**dims)
