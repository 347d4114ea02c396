"""Local kernels (blas, lapack) and the hand-written CUDA kernels under them."""

from __future__ import annotations


def reset_counters() -> None:
    """Zero every kernel launch count and every fallback count."""
    from capital_tpu_torch.ops import blas, cuda_chol, cuda_getrf, cuda_syrk
    from capital_tpu_torch.ops import cuda_trmm, lapack

    cuda_trmm.trmm_upper.launches = 0
    cuda_trmm.trmm_upper.by_case = dict.fromkeys(cuda_trmm.CASES, 0)
    cuda_syrk.syrk_upper.launches = 0
    cuda_chol.chol_inv_cuda.launches = 0
    blas.trmm.dot_calls = 0
    blas.syrk.dot_calls = 0
    blas.gram_dot.calls = 0
    lapack.chol_inv.xla_calls = 0
    cuda_getrf.getrf_leaf.launches = 0
    cuda_getrf.getrf_leaf.by_route = dict.fromkeys(
        cuda_getrf.getrf_leaf.by_route, 0)
    cuda_getrf.getrf_leaf_plain.fallbacks = 0
    lapack.lu.library_calls = 0


def counters() -> dict:
    """Kernel launches since the last reset (`getrf_leaf_by_route` splits
    the LU leaf's by route: resident, tall), with the fallbacks that
    bypassed a kernel (`trmm_dot`, `syrk_dot`, `chol_xla`; `gram_dot`,
    cacqr's plain Gram, blas.gram_dot; for LU
    `leaf_plain`, the plain leaf that CAPITAL_LU_LEAF=jax asks for, and
    `lu_library`, torch.linalg.lu_factor panels)."""
    from capital_tpu_torch.ops import blas, cuda_chol, cuda_getrf, cuda_syrk
    from capital_tpu_torch.ops import cuda_trmm, lapack

    return {
        "trmm_upper": cuda_trmm.trmm_upper.launches,
        "trmm_upper_by_case": dict(cuda_trmm.trmm_upper.by_case),
        "syrk_upper": cuda_syrk.syrk_upper.launches,
        "chol_inv": cuda_chol.chol_inv_cuda.launches,
        "trmm_dot": blas.trmm.dot_calls,
        "syrk_dot": blas.syrk.dot_calls,
        "gram_dot": blas.gram_dot.calls,
        "chol_xla": lapack.chol_inv.xla_calls,
        "getrf_leaf": cuda_getrf.getrf_leaf.launches,
        "getrf_leaf_by_route": dict(cuda_getrf.getrf_leaf.by_route),
        "leaf_plain": cuda_getrf.getrf_leaf_plain.fallbacks,
        "lu_library": lapack.lu.library_calls,
    }
