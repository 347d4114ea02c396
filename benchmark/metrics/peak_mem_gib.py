"""torch.cuda.max_memory_allocated() over the window (reset at its
start), the largest over the ranks, in GiB."""


def read(r):
    return max(rank["peak_window"] for rank in r.ranks) / 2**30
