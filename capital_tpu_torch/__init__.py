"""capital_tpu_torch: the PyTorch/CUDA port of capital_tpu.

Same module layout and public names as the JAX package (`Grid`,
`DistMatrix`, `cholinv.Config`, `cholinv.factor`,
`validate.cholesky_residual`, ...). It covers, on one device, the
recursive Cholesky + inverse, LU with partial pivoting, CholeskyQR2, and
the solvers over them (QDWH polar, Newton-Schulz, TSQR, `linalg`); their
four TPU kernels (TRMM, SYRK, the fused Cholesky leaf, the LU
panel leaf) are hand-written CUDA kernels for Hopper (sm_90a) under
`csrc/`, built with nvcc at first use.

Entry points run on cuda:0 unless the caller passes a CPU device. It
imports torch, numpy and the standard library, never JAX.
"""

from capital_tpu_torch.grid import Grid
from capital_tpu_torch.matrix import DistMatrix, Structure

__all__ = ["Grid", "DistMatrix", "Structure"]
