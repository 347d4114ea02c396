"""cholinv: 2 n^3 / 3, the Cholesky factor (n^3 / 3) and the full
triangular inverse (n^3 / 3)."""


def per_call(n: int, **_) -> float:
    return 2.0 * n**3 / 3.0
