"""The one-device step (counterpart of __graft_entry__.entry): a cholinv
factor of an n = 512 SPD operand, base method 'auto', so the fused
Cholesky leaf kernel on the card. The multi-device dry run
(__graft_entry__.dryrun_multichip) waits for the distributed substrate
(ROADMAP queue M, item M23b).

    fn, args = entry()          # cuda:0; entry('cpu') on the CPU
    r, rinv = fn(*args)
"""

from __future__ import annotations

import torch

from capital_tpu_torch.algs import cholinv
from capital_tpu_torch.grid import Grid


def entry(device=None):
    """(fn, example_args): fn(a) -> (R, Rinv) of cholinv.factor on a
    one-device grid; a = (U + U^T)/2 + n I with U Uniform(-0.5, 0.5)
    (seed 0), n = 512."""
    grid = Grid.square(c=1, d=1, device=device)
    cfg = cholinv.Config(base_method="auto", summa_impl="gspmd")

    def fn(a):
        r, rinv = cholinv.factor(grid, a, cfg)
        return r, rinv

    n = 512
    gen = torch.Generator(device=grid.device).manual_seed(0)
    u = torch.rand((n, n), generator=gen, device=grid.device) - 0.5
    a = (u + u.T) * 0.5 + n * torch.eye(n, device=grid.device)
    return fn, (a,)
