"""Autotuner: config-space sweeps scored by measured time and analytic
costs (counterpart of capital_tpu/autotune)."""

from capital_tpu_torch.autotune.tune import (
    Candidate,
    sweep_cacqr,
    sweep_cholinv,
    write_tables,
)

__all__ = ["Candidate", "sweep_cholinv", "sweep_cacqr", "write_tables"]
