"""Plain reference of cholinv.factor: A = R^T R with R upper triangular,
and R^-1, by the recursive blocked algorithm in plain PyTorch.

    n <= leaf:  R = cholesky(A)^T, R^-1 by a triangular solve
    else:       R11, R11^-1 of the leading half
                R12 = R11^-T A12
                S = A22 - R12^T R12; R22, R22^-1 of S
                R12^-1 = -R11^-1 R12 R22^-1

Every product is a dense matmul: exact in float64 for the reference,
with its inputs rounded to TF32 and summed in float32 for the control.
"""

from __future__ import annotations

import torch

from benchmark.reference import plain


def _rec(w, ri, off: int, n: int, leaf: int, mm) -> None:
    end = off + n
    if n <= leaf:
        r, rinv = plain.chol_upper(w[off:end, off:end])
        w[off:end, off:end] = r
        ri[off:end, off:end] = rinv
        return
    n1 = max(leaf, n >> 1)
    mid = off + n1
    _rec(w, ri, off, n1, leaf, mm)
    r12 = mm(ri[off:mid, off:mid].mT, w[off:mid, mid:end])
    w[off:mid, mid:end] = r12
    w[mid:end, mid:end] -= mm(r12.mT, r12)
    del r12
    _rec(w, ri, mid, n - n1, leaf, mm)
    t = mm(w[off:mid, mid:end], ri[mid:end, mid:end])
    ri[off:mid, mid:end] = -mm(ri[off:mid, off:mid], t)


def factor(a: torch.Tensor, leaf: int, dtype=torch.float64,
           rounding: bool = False):
    """(R, R^-1) of the SPD a, dense with zeros below the diagonal,
    computed in `dtype`, the products' inputs rounded to TF32 when
    `rounding`."""
    plain.exact_products()
    w = a.to(dtype=dtype, copy=True)
    ri = torch.zeros_like(w)
    _rec(w, ri, 0, a.shape[0], leaf, plain.product(rounding))
    return w.triu_(), ri


def check(a: torch.Tensor, outputs: dict, config: dict,
          comm=plain.OneDevice()) -> dict:
    """The program's R and R^-1 against the float64 reference: relative
    Frobenius distances of every entry off the diagonal (the part the
    products make, with the lower triangle that must stay zero; the f32
    storage of the diagonal, about sqrt(n), would swamp a whole-factor
    distance)."""
    r_ref, ri_ref = factor(a, config["settings"]["bc"])
    r, ri = outputs["R"], outputs["Rinv"]
    return {"r_off_err": plain.rel_fro(r, r_ref, offdiag=True),
            "rinv_off_err": plain.rel_fro(ri, ri_ref, offdiag=True)}


def control(a: torch.Tensor, config: dict, comm=plain.OneDevice()) -> dict:
    r, ri = factor(a, config["settings"]["bc"], torch.float32, rounding=True)
    return {"R": r, "Rinv": ri}
