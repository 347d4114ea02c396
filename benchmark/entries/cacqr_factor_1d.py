"""capital_tpu_torch.algs.cacqr.factor_1d: CholeskyQR2 of a tall-skinny A
in the 1D layout, Q out of place (A left as it was). On one device A is
a tensor; in a world of ranks it is a DArray of rows over every rank of
Grid.rect(c=1), and the Gram is summed across them."""

from __future__ import annotations

from capital_tpu_torch.algs import cacqr
from capital_tpu_torch.grid import Grid
from capital_tpu_torch.parallel.darray import DArray
from capital_tpu_torch.ops import precision


class Entry:
    def __init__(self, config: dict, dims: dict, device, world: bool):
        s = config["settings"]
        self.grid = (Grid.rect(c=1) if world
                     else Grid.square(c=1, d=1, device=device))
        self.cfg = cacqr.Config(num_iter=s["num_iter"],
                                gram_policy=s["gram_policy"],
                                base_method=s["base_method"],
                                formq_chunks=s["formq_chunks"],
                                gram_kernel=s["gram_kernel"])
        self.level = config["precision"]
        self.shape = (dims["m"], dims["n"])

    def operand(self, local):
        if self.grid.mesh is None:
            return local
        return DArray(local, self.shape, cacqr.ROW1D, self.grid.mesh)

    def __call__(self, a):
        with precision.default_matmul_precision(self.level):
            return cacqr.factor_1d(self.grid, a, self.cfg)

    @staticmethod
    def outputs(result) -> dict:
        q, r = result
        return {"Q": q.local if isinstance(q, DArray) else q, "R": r}
