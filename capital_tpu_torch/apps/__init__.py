"""Applications built on the factorization engine (counterpart of
capital_tpu/apps): ALS matrix factorization by batched normal-equation
Cholesky solves (`als`), and the randomized SVD / PCA whose range finder
is CholeskyQR2 (`rsvd`)."""
