"""High-level solvers over the factorization engine (counterpart of
capital_tpu/linalg.py), on one device:

  spd_solve:   A x = b for SPD A: cholinv once, then two TRMMs against the
               explicit inverse factor, with optional refinement.
  solve:       A x = b for general square A, by the normal equations
               (cholinv of A^T A), LU with partial pivoting, or QDWH polar.
  lstsq:       min ||A x - b|| for tall-skinny A, by CholeskyQR2 or TSQR.
  inv, slogdet_spd, expm, nearest_orthogonal, nearest_psd.

A 1-D b gives a 1-D x (spd_solve, solve, lstsq). Refinement residuals are
taken at 'highest'. pinv, cond and the funm_spd family need the QDWH
eigensolver and SVD, which are not ported yet (ROADMAP queue M, items
M18 and M19); they raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from capital_tpu_torch.algs import cacqr, cholinv
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.matrix import DistMatrix
from capital_tpu_torch.ops.precision import default_matmul_precision
from capital_tpu_torch.ops.precision import dot as _pdot
from capital_tpu_torch.parallel import summa


def _arr(x):
    return x.data if isinstance(x, DistMatrix) else x


def spd_solve(grid: Grid, a, b, cfg: cholinv.Config | None = None,
              refine: int = 0, factor=None):
    """x = A^{-1} b for SPD A ((n, n); b (n, k) or (n,)).

    A = R^T R, so x = R^{-1} (R^{-T} b): two TRMMs against the explicit
    inverse. refine: sweeps x <- x + R^{-1} R^{-T} (b - A x), the residual
    product at 'highest'. factor: a precomputed (R, Rinv) pair."""
    a, b = _arr(a), _arr(b)
    vec = b.ndim == 1
    if vec:
        b = b[:, None]
    cfg = cfg or cholinv.Config(summa_impl="gspmd")
    if factor is None:
        _, rinv = cholinv.factor(grid, a, cfg)
    else:
        _, rinv = factor

    def apply_inv(v):
        y = summa.trmm(grid, rinv, v, side="L", uplo="U", trans_a=True,
                       impl=cfg.summa_impl)
        return summa.trmm(grid, rinv, y, side="L", uplo="U",
                          impl=cfg.summa_impl)

    x = apply_inv(b)
    for _ in range(refine):
        with default_matmul_precision("highest"):
            res = b - summa.gemm(grid, a, x, impl=cfg.summa_impl)
        x = x + apply_inv(res)
    return x[:, 0] if vec else x


def inv(grid: Grid, a, cfg: cholinv.Config | None = None):
    """A^{-1} for SPD A: Rinv Rinv^T."""
    a = _arr(a)
    cfg = cfg or cholinv.Config(summa_impl="gspmd")
    _, rinv = cholinv.factor(grid, a, cfg)
    rinv = torch.triu(rinv)
    rinv_t = summa.transpose(grid, rinv, impl=cfg.summa_impl)
    return summa.gemm(grid, rinv, rinv_t, impl=cfg.summa_impl)


def _needs(item: str, what: str):
    raise NotImplementedError(
        f"{what} needs the QDWH {item}, which the port does not have yet "
        f"(ROADMAP queue M, items M18 eigh and M19 svd)")


def pinv(grid: Grid, a, rcond: float | None = None, cfg=None,
         layout: str = "auto"):
    """Moore-Penrose pseudo-inverse via QDWH-SVD: not ported yet."""
    _needs("SVD", "pinv")


def cond(grid: Grid, a, cfg=None, layout: str = "auto"):
    """Spectral condition number via QDWH-SVD: not ported yet."""
    _needs("SVD", "cond")


def funm_spd(grid: Grid, a, fn, cfg=None, clamp_min: float = 0.0):
    """f(A) = V f(L) V^T via the eigensolver: not ported yet."""
    _needs("eigensolver", "funm_spd")


def spd_sqrt(grid: Grid, a, cfg=None, inverse: bool = False):
    """A^{1/2} or A^{-1/2} (funm_spd): not ported yet."""
    _needs("eigensolver", "spd_sqrt")


def logm_spd(grid: Grid, a, cfg=None):
    """Principal logarithm (funm_spd): not ported yet."""
    _needs("eigensolver", "logm_spd")


def powm_spd(grid: Grid, a, p: float, cfg=None):
    """A^p (funm_spd): not ported yet."""
    _needs("eigensolver", "powm_spd")


def solve(grid: Grid, a, b, method: str = "auto", refine: int = 2,
          cfg: cholinv.Config | None = None, polar_cfg=None,
          factor_dtype=None):
    """x = A^{-1} b for general square A ((n, n); b (n, k) or (n,)).

    method 'normal' ('auto'): cholinv of A^T A (its product at 'highest')
        and refinement on the true residual, x <- x + (A^T A)^{-1} A^T
        (b - A x); stable while cond(A)^2 eps < 1.
    method 'lu': P A = L U (algs/lu.py) and two block substitutions, then
        refinement. factor_dtype factors a downcast copy of A and refines
        against A; bf16 LU factors are too inaccurate for the refinement
        to contract at large n (the JAX package's measurement), so the
        f32 factor is the production route.
    method 'polar': A = U H (QDWH), x = H^{-1} (U^T b) by spd_solve.
    Refinement residuals are taken at 'highest'."""
    a, b = _arr(a), _arr(b)
    vec = b.ndim == 1
    if vec:
        # 1-D b in, 1-D x out: an (n, 1) x would broadcast `a @ x - b`
        # to (n, n) in the caller's residual check
        b = b[:, None]
    cfg = cfg or cholinv.Config(summa_impl="gspmd")
    impl = cfg.summa_impl
    if method == "auto":
        method = "normal"
    if method == "polar":
        from capital_tpu_torch.algs import polar as _polar

        pcfg = polar_cfg or _polar.Config(chol=cfg)
        u, h = _polar.polar_jit(grid, a, pcfg, layout="2d")
        utb = summa.gemm(grid, summa.transpose(grid, u, impl=impl), b,
                         impl=impl)
        del u
        xp = spd_solve(grid, h, utb, cfg=cfg, refine=refine)
        return xp[:, 0] if vec else xp
    if method == "lu":
        from capital_tpu_torch.algs import lu as _lu

        wsrc = a if factor_dtype is None else a.to(factor_dtype)
        w, perm, _ = _lu.factor(grid, wsrc, _lu.Config(summa_impl=impl))
        if w.dtype != a.dtype:
            w = w.to(a.dtype)  # substitutions at the operand's precision
        x = _lu.solve_factored(grid, w, perm, b)
        for _ in range(refine):
            with default_matmul_precision("highest"):
                res = b - summa.gemm(grid, a, x, impl=impl)
            x = x + _lu.solve_factored(grid, w, perm, res)
        return x[:, 0] if vec else x
    if method != "normal":
        raise ValueError(f"unknown solve method {method!r}")

    at = summa.transpose(grid, a, impl=impl)
    with default_matmul_precision("highest"):
        gram = summa.gemm(grid, at, a, impl=impl)
    _, rinv = cholinv.factor(grid, gram, cfg)
    del gram

    def apply_pinv(v):
        atv = summa.gemm(grid, at, v, impl=impl)
        y = summa.trmm(grid, rinv, atv, side="L", uplo="U", trans_a=True,
                       impl=impl)
        return summa.trmm(grid, rinv, y, side="L", uplo="U", impl=impl)

    x = apply_pinv(b)
    for _ in range(refine):
        with default_matmul_precision("highest"):
            res = b - summa.gemm(grid, a, x, impl=impl)
        x = x + apply_pinv(res)
    return x[:, 0] if vec else x


# Pade-13 coefficients of exp (Higham 2005, the scipy/LAPACK table)
_EXPM_B13 = (
    64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
    1187353796428800.0, 129060195264000.0, 10559470521600.0,
    670442572800.0, 33522128640.0, 1323241920.0, 40840800.0,
    960960.0, 16380.0, 182.0, 1.0,
)


def expm(grid: Grid, a, cfg: cholinv.Config | None = None,
         solve_refine: int = 2):
    """e^A for square A by scaling and squaring with the degree-13 Pade
    approximant (Higham 2005, the scipy.linalg.expm algorithm): six gemms
    for the powers and polynomials, one `solve` (normal equations) for
    the quotient, s squarings. s comes from the 1-norm, read on the host
    once."""
    a = _arr(a)
    n = a.shape[0]
    if tuple(a.shape) != (n, n):
        raise ValueError(f"expm needs a square matrix, got {tuple(a.shape)}")
    cfg = cfg or cholinv.Config(summa_impl="gspmd")
    impl = cfg.summa_impl
    theta13 = 5.371920351148152
    norm1 = float(torch.max(torch.sum(torch.abs(a.float()), dim=0)))
    s = max(0, int(math.ceil(math.log2(max(norm1, 1e-30) / theta13)))) \
        if norm1 > theta13 else 0
    x = (a / torch.tensor(2.0**s, dtype=a.dtype, device=a.device)).to(a.dtype)

    def mm(p, q):
        return summa.gemm(grid, p, q, impl=impl)

    b = _EXPM_B13
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    x2 = mm(x, x)
    x4 = mm(x2, x2)
    x6 = mm(x2, x4)
    w1 = b[13] * x6 + b[11] * x4 + b[9] * x2
    w2 = b[7] * x6 + b[5] * x4 + b[3] * x2 + b[1] * eye
    u = mm(x, mm(x6, w1) + w2)
    z1 = b[12] * x6 + b[10] * x4 + b[8] * x2
    v = mm(x6, z1) + b[6] * x6 + b[4] * x4 + b[2] * x2 + b[0] * eye
    # r13 = (V - U)^{-1} (V + U); V - U is well-conditioned for the scaled
    # operand (||X|| <= theta13)
    r = solve(grid, v - u, v + u, method="normal", refine=solve_refine,
              cfg=cfg)
    r = r.to(a.dtype)
    for _ in range(s):
        r = mm(r, r)
    return r


def slogdet_spd(grid: Grid, a, cfg: cholinv.Config | None = None,
                factor=None):
    """(sign = 1, log|det A|) for SPD A: 2 sum(log diag R) of the cholinv
    factor (or of factor=(R, Rinv)), both 0-d f32 tensors."""
    a = _arr(a)
    cfg = cfg or cholinv.Config(summa_impl="gspmd")
    r = (factor or cholinv.factor(grid, a, cfg))[0]
    d = torch.diagonal(r).float()
    tiny = torch.finfo(torch.float32).tiny
    return (torch.ones((), dtype=torch.float32, device=r.device),
            2.0 * torch.sum(torch.log(torch.clamp(d, min=tiny))))


def nearest_orthogonal(grid: Grid, a, cfg=None, layout: str = "auto"):
    """The matrix with orthonormal columns nearest A in Frobenius norm:
    A's polar factor U (one QDWH sweep)."""
    from capital_tpu_torch.algs import polar as _polar

    cfg = cfg or _polar.Config()
    if cfg.compute_h:
        cfg = dataclasses.replace(cfg, compute_h=False)
    a = _arr(a)
    layout = _polar._resolve_layout(grid, a, layout)
    return _polar.polar_jit(grid, a, cfg, layout=layout)


def nearest_psd(grid: Grid, a, cfg=None):
    """The symmetric positive-semidefinite matrix nearest A in Frobenius
    norm (Higham 1988): (B + H)/2 with B = (A + A^T)/2 and H B's polar
    hermitian factor; symmetrized exactly."""
    from capital_tpu_torch.algs import polar as _polar

    cfg = cfg or _polar.Config()
    a = _arr(a)
    at = summa.transpose(grid, a, impl="gspmd")
    b = 0.5 * (a + at)
    _, h = _polar.polar_jit(grid, b, cfg, layout="2d")
    x = 0.5 * (b + h)
    xt = summa.transpose(grid, x, impl="gspmd")
    return 0.5 * (x + xt)


def lstsq(grid: Grid, a, b, cfg: cacqr.Config | None = None,
          refine: int = 0, method: str = "cqr2"):
    """min ||A x - b||_2 for tall-skinny A ((m, n), m >> n; b (m, k) or
    (m,)): x = R^{-1} Q^T b.

    method 'cqr2' (CholeskyQR2, cond(A) <= ~1e5 in f32) or 'tsqr'
    (Householder, any conditioning). refine: sweeps x <- x + R^{-1} Q^T
    (b - A x), the residual product at 'highest'. R's solve is
    torch.linalg.solve_triangular in f32."""
    a, b = _arr(a), _arr(b)
    vec = b.ndim == 1
    if vec:
        b = b[:, None]
    cfg = cfg or cacqr.Config(num_iter=2)
    if method == "tsqr":
        from capital_tpu_torch.algs import tsqr as _tsqr

        q, r = _tsqr.factor(grid, a)
    elif method == "cqr2":
        q, r = cacqr.factor_1d(grid, a, cfg)
    else:
        raise ValueError(f"unknown lstsq method {method!r}")
    rt = torch.triu(r).float()

    def solve_r(rhs):
        return torch.linalg.solve_triangular(rt, rhs.float(), upper=True)

    x = solve_r(cacqr.apply_q(grid, q, b, trans=True, cfg=cfg, layout="1d"))
    for _ in range(refine):
        with default_matmul_precision("highest"):
            res = b - _pdot(a, x.to(a.dtype)).to(a.dtype)
        x = x + solve_r(
            cacqr.apply_q(grid, q, res, trans=True, cfg=cfg, layout="1d"))
    x = x.to(a.dtype)
    return x[:, 0] if vec else x
