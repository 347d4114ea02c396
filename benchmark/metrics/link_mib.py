"""MiB a call that rank 0 moves over its links, as the program's cost
tracer (capital_tpu_torch.tracing) computes them from the shapes over the
traced calls: computed, not measured. None on one card."""


def read(r):
    r0 = r.rank0
    if len(r.ranks) < 2 or not r0["profiled"] or r0["link_bytes"] is None:
        return None
    return r0["link_bytes"] / r0["profiled"] / 2**20
