"""Flop formulas, one a file (formulas/<name>.py), found by the name a
configuration gives under `flops`: `per_call(**dims)` returns the useful
flops of one call at the operand's sizes (the configuration's `shape`
and the traffic mix's). They are the yardstick: a formula, once added,
changes only in a benchmark change, so that no change to the program
moves it."""
