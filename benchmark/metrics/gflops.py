"""Useful GFLOP/s: the frozen flop count of every call completed in the
window over the window's seconds (its start to the end of its last
call), host clock."""


def read(r):
    return r.flops_per_call * len(r.calls) / r.rank0["window_s"] / 1e9
