"""Seconds from the start of the benchmark's process to the window's
start: imports, the kernels' build where the checkout has none yet, the
operands, the warm-up call (and on several cards the ranks' spawn and
their process group)."""


def read(r):
    return r.setup_s
