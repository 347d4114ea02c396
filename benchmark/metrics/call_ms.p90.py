"""The 90th percentile, by nearest rank, of the host time from a call's
start to the end of its synchronise, over every call of the window."""

import math


def p90(values: list) -> float:
    s = sorted(values)
    return s[max(0, math.ceil(0.9 * len(s)) - 1)]


def read(r):
    return p90([(end - start) * 1e3 for start, _, end, _ in r.calls])
