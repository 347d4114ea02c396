"""Adapters that call the program, one a program entry
(entries/<entry>.py). Each gives `Entry(config, dims, device, world)`:
`entry.operand(local)` turns this rank's block of an operand into the
program's input, `entry(x)` makes one call under the configuration's
precision level, and `entry.outputs(result)` names the tensors of its
result that the reference judges (this rank's block of each).
"""
