"""Operand classes, one a file (operands/<class>.py), found by the name a
configuration gives under `operand`. Each gives
`make(dims, seed, device, dtype, rank, ranks)`: this rank's part of one
operand at the sizes `dims`, made on `device` from `seed` with a
torch.Generator of its own, in a few large calls. The class states its
layout over ranks and refuses the layouts it cannot make. The seed comes
from traffic.operands (`traffic.mix(seed, k, rank)`), so every class
draws from the same seeds. A class, once added, changes only in a
benchmark change."""
