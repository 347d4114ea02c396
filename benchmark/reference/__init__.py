"""Plain references, one a program entry (reference/<entry>.py), in plain
PyTorch. They import nothing of the program and take nothing it made:
each works its factors out again from the operand the benchmark made.

Each module gives `check(operand, outputs, config, comm)`, the compared
numbers of the program's outputs against the reference computed in
float64, and `control(operand, config, comm)`, the reference put in the
program's place and computed in the nearest precision below the
configuration's (TF32 products, `plain.tf32`), with the outputs in the
program's form.
"""
