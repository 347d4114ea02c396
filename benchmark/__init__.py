"""The benchmark of capital_tpu_torch on NVIDIA H100 cards.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json`. Everything a cell,
configuration, traffic mix or metric needs is found by name under this
folder (README.md).
"""
