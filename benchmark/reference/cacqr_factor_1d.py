"""Plain reference of cacqr.factor_1d: CholeskyQR2 of a tall-skinny A
whose rows may lie over several ranks, in plain PyTorch.

    sweep:  G = sum over ranks of A^T A;  R1, R1^-1 = chol(G);  Q1 = A R1^-1
    again:  G2 = Q1^T Q1;  R2, R2^-1;  Q = Q1 R2^-1;  R = R2 R1

The reference runs in float64 and never holds Q: it takes each Gram in
row blocks and compares the program's Q block by block with
A (R1^-1 R2^-1). `comm.sum` adds a Gram over the ranks (the identity on
one device). The control runs the same sweeps in float32 with TF32
products and returns Q and R as the program does.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import plain

ROWS = 1 << 18  # rows a block


def _blocks(rows: int):
    for r0 in range(0, rows, ROWS):
        yield slice(r0, min(rows, r0 + ROWS))


def _gram(a, dtype, mm, comm, right=None) -> torch.Tensor:
    """The Gram of A (times `right`), summed over the ranks."""
    n = a.shape[1]
    g = torch.zeros((n, n), dtype=dtype, device=a.device)
    for sl in _blocks(a.shape[0]):
        x = a[sl].to(dtype)
        if right is not None:
            x = mm(x, right)
        g += mm(x.mT, x)
    return comm.sum(g)


def _factors(a, dtype, rounding: bool, comm):
    """(R, R1^-1, R2^-1) of CholeskyQR2 on A's rows."""
    plain.exact_products()
    mm = plain.product(rounding)
    r1, r1inv = plain.chol_upper(_gram(a, dtype, mm, comm))
    r2, r2inv = plain.chol_upper(_gram(a, dtype, mm, comm, right=r1inv))
    return torch.triu(mm(r2, r1)), r1inv, r2inv


def check(a: torch.Tensor, outputs: dict, config: dict,
          comm=plain.OneDevice()) -> dict:
    """The program's Q (this rank's rows) and R against the float64
    reference: relative Frobenius distances over every rank's rows of Q,
    and of R (the largest over the ranks, each holding R whole)."""
    r_ref, r1inv, r2inv = _factors(a, torch.float64, False, comm)
    qinv = r1inv @ r2inv
    q = outputs["Q"]
    num = torch.zeros((), dtype=torch.float64, device=a.device)
    den = torch.zeros((), dtype=torch.float64, device=a.device)
    for sl in _blocks(a.shape[0]):
        q_ref = a[sl].double() @ qinv
        num += plain.squares(q[sl], q_ref)
        den += plain.squares(q_ref)
        del q_ref
    sums = comm.sum(torch.stack([num, den]))
    r_err = comm.max(torch.tensor([plain.rel_fro(outputs["R"], r_ref)],
                                  dtype=torch.float64))
    return {"q_err": math.sqrt(float(sums[0]) / float(sums[1])),
            "r_err": float(r_err[0])}


def control(a: torch.Tensor, config: dict, comm=plain.OneDevice()) -> dict:
    plain.exact_products()
    mm = plain.product(True)
    r1, r1inv = plain.chol_upper(_gram(a, torch.float32, mm, comm))
    q = torch.empty_like(a)
    for sl in _blocks(a.shape[0]):
        q[sl] = mm(a[sl], r1inv)
    r2, r2inv = plain.chol_upper(_gram(q, torch.float32, mm, comm))
    for sl in _blocks(a.shape[0]):
        q[sl] = mm(q[sl], r2inv)
    return {"Q": q, "R": torch.triu(mm(r2, r1))}
