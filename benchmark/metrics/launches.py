"""Kernel launches and fallbacks a call (the program's ops.counters()),
over the traced calls, on rank 0."""


def read(r):
    r0 = r.rank0
    if not r0["profiled"] or r0["launches"] is None:
        return None
    return r0["launches"] / r0["profiled"]
