"""Device ms a call of the SYRK kernels (names holding 'syrk_': the wgmma
and FFMA kernels of csrc/syrk_upper.cu, not the shared pack pass), from
torch.profiler over the traced calls, on rank 0."""

from benchmark.metrics._kernels import ms_per_call


def read(r):
    return ms_per_call(r, "syrk_")
