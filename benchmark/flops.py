"""Useful flops of one call, by the formula a configuration names under
`flops`: formulas/<name>.py, found by name. Frozen there, apart from the
program, so that no change to the program moves the yardstick."""

from __future__ import annotations

from benchmark import spec


def per_call(config: dict, dims: dict) -> float:
    return spec.load("formulas", config["flops"]).per_call(**dims)
