"""capital_tpu_torch: the PyTorch/CUDA port of capital_tpu.

Same module layout and public names as the JAX package (`Grid`,
`DistMatrix`, `cholinv.Config`, `cholinv.factor`,
`validate.cholesky_residual`, ...). It covers, on one device, the
recursive Cholesky + inverse, LU with partial pivoting, CholeskyQR2, the
solvers over them (QDWH polar, Newton-Schulz, TSQR, `linalg`), the
QDWH spectral layer (`eigh`, `svd`, the `linalg` matrix functions), the
applications (`apps.rsvd`, `apps.als`), the host-side storage (`io`,
`native`), the one-device hybrid CholeskyQR and cyclic-workspace
cholinv, the autotuner (`autotune.tune`), the drivers under `bench`, the
examples under `examples` and the one-device step `entry.entry`; their
four TPU kernels (TRMM, SYRK, the fused Cholesky leaf, the LU
panel leaf) are hand-written CUDA kernels for Hopper (sm_90a) under
`csrc/`, built with nvcc at first use.

Entry points run on cuda:0 unless the caller passes a CPU device. It
imports torch, numpy and the standard library, never JAX.
"""

from capital_tpu_torch.grid import Grid
from capital_tpu_torch.matrix import DistMatrix, Structure

__version__ = "0.1.0"

__all__ = ["Grid", "DistMatrix", "Structure", "__version__"]
