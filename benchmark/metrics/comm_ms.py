"""Device ms a call of NCCL's kernels (the collectives between cards),
from torch.profiler over the traced calls, on rank 0."""

from benchmark.metrics._kernels import ms_per_call


def read(r):
    return ms_per_call(r, "nccl")
