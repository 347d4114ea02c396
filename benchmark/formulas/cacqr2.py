"""cacqr2: 2 (4 m n^2 + 2 n^3 / 3), two CholeskyQR sweeps, each a Gram
(2 m n^2, counted as a full product), Q = A R^-1 (2 m n^2) and the
Gram's Cholesky and inverse (2 n^3 / 3); m the global rows."""


def per_call(m: int, n: int, **_) -> float:
    return 2.0 * (4.0 * m * n * n + 2.0 * n**3 / 3.0)
