"""Local kernels (blas, lapack) and the hand-written CUDA kernels under them."""

from __future__ import annotations


def reset_counters() -> None:
    """Zero every kernel launch count and every dot/xla fallback count."""
    from capital_tpu_torch.ops import blas, cuda_chol, cuda_syrk, cuda_trmm
    from capital_tpu_torch.ops import lapack

    cuda_trmm.trmm_upper.launches = 0
    cuda_trmm.trmm_upper.by_case = dict.fromkeys(cuda_trmm.CASES, 0)
    cuda_syrk.syrk_upper.launches = 0
    cuda_chol.chol_inv_cuda.launches = 0
    blas.trmm.dot_calls = 0
    blas.syrk.dot_calls = 0
    lapack.chol_inv.xla_calls = 0


def counters() -> dict:
    """Kernel launches since the last reset, with the fallbacks that
    bypassed a kernel (`trmm_dot`, `syrk_dot`, `chol_xla`)."""
    from capital_tpu_torch.ops import blas, cuda_chol, cuda_syrk, cuda_trmm
    from capital_tpu_torch.ops import lapack

    return {
        "trmm_upper": cuda_trmm.trmm_upper.launches,
        "trmm_upper_by_case": dict(cuda_trmm.trmm_upper.by_case),
        "syrk_upper": cuda_syrk.syrk_upper.launches,
        "chol_inv": cuda_chol.chol_inv_cuda.launches,
        "trmm_dot": blas.trmm.dot_calls,
        "syrk_dot": blas.syrk.dot_calls,
        "chol_xla": lapack.chol_inv.xla_calls,
    }
