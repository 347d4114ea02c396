"""capital_tpu_torch.algs.cholinv.factor on one device: the recursive
Cholesky factor R of an SPD A with R^-1, A copied into the workspace and
left as it was."""

from __future__ import annotations

from capital_tpu_torch.algs import cholinv
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.ops import precision


class Entry:
    def __init__(self, config: dict, dims: dict, device, world: bool):
        if world:
            raise ValueError("cholinv_factor cells run on one device")
        s = config["settings"]
        self.grid = Grid.square(c=1, d=1, device=device)
        self.cfg = cholinv.Config(split=s["split"], min_bc=s["bc"],
                                  complete_inv=s["complete_inv"],
                                  base_method=s["base_method"])
        self.level = config["precision"]

    def operand(self, local):
        return local

    def __call__(self, a):
        with precision.default_matmul_precision(self.level):
            return cholinv.factor(self.grid, a, self.cfg)

    @staticmethod
    def outputs(result) -> dict:
        r, rinv = result
        return {"R": r, "Rinv": rinv}
