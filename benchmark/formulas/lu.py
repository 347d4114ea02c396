"""lu: 2 n^3 / 3, the leading term of LAPACK's count for xGETRF, LU with
partial pivoting of an n x n matrix. The whole count is
2 n^3 / 3 - n^2 / 2 + 5 n / 6 (LAWN 41); HPL reports
2 n^3 / 3 + 3 n^2 / 2, which takes in the solve with one right-hand
side that a factorization alone does not do."""


def per_call(n: int, **_) -> float:
    return 2.0 * n**3 / 3.0
