"""Benchmark drivers (python -m capital_tpu_torch.bench.cholinv)."""
