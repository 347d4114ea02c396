"""Device grid (counterpart of capital_tpu/grid.py), one device for now.

The JAX package runs on a c x d x d mesh with axes ('z', 'y', 'x'). This
slice of the port covers the single-device grid c = d = 1, on which every
distributed call reduces to a local one. Any grid with more than one
device raises NotImplementedError until the distributed substrate is
ported (ROADMAP queue M, item M9).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

def default_device(device=None) -> torch.device:
    """`device` as a torch.device; None means cuda:0, and raises when no
    GPU is present (the port never falls back to the CPU unasked). A CUDA
    device without an index gets the current one, so it compares equal to
    a tensor's device."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda", 0)


@dataclass(frozen=True)
class Grid:
    """A (c, d1, d2) device grid; this slice supports (1, 1, 1) only."""

    device: torch.device

    @classmethod
    def square(cls, c: int = 1, d: int | None = None, device=None,
               layout: int = 0) -> "Grid":
        """c-deep d x d grid (P = c*d*d devices) on `device`."""
        d = 1 if d is None else d
        if c * d * d != 1:
            raise NotImplementedError(
                f"grid c={c}, d={d} needs {c * d * d} devices; the port "
                "runs on one device until the distributed substrate lands "
                "(ROADMAP queue M, item M9)")
        if layout not in (0, 1, 2):
            raise ValueError(f"unknown layout {layout}")
        return cls(device=default_device(device))

    @property
    def c(self) -> int:
        return 1

    @property
    def d1(self) -> int:
        return 1

    @property
    def d2(self) -> int:
        return 1

    @property
    def d(self) -> int:
        return 1

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.c, self.d1, self.d2)

    @property
    def num_devices(self) -> int:
        return self.c * self.d1 * self.d2

    @property
    def platform(self) -> str:
        """'gpu' or 'cpu'."""
        return "gpu" if self.device.type == "cuda" else "cpu"

    @property
    def is_square(self) -> bool:
        return self.d1 == self.d2

    def constrain(self, x: torch.Tensor, spec=None) -> torch.Tensor:
        """Sharding constraint: nothing to do on one device."""
        return x
