"""Algorithms built on the SUMMA engine and the local kernels."""
