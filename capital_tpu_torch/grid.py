"""Device grid (counterpart of capital_tpu/grid.py), one device for now.

The JAX package runs on a c x d x d mesh with axes ('z', 'y', 'x'): z the
depth (replication) axis, y the grid rows, x the grid columns. `roles`
maps the algorithmic roles (depth, row, col) onto those axis names, and
`view()` re-casts them (cacqr's hybrid path factors its Gram on the
(z, x) square view of a rect grid). This slice of the port covers the
single-device grid c = d1 = d2 = 1, on which every distributed call
reduces to a local one, with the JAX package's constructors (`square`,
`rect`, `hybrid`), views and sharding names. A sharding here is a
descriptor naming the grid's device and a partition spec `P`; on one
device every spec places the whole array on that device. Any grid with
more than one device raises NotImplementedError until the distributed
substrate is ported (ROADMAP queue M, item M9b).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Sequence

import torch

# Canonical axis names, outermost-first.
AXIS_Z = "z"  # depth / replication ("c")
AXIS_Y = "y"  # grid row coordinate
AXIS_X = "x"  # grid col coordinate
ALL_AXES = (AXIS_Z, AXIS_Y, AXIS_X)
_MESH_SHAPE = {AXIS_Z: 1, AXIS_Y: 1, AXIS_X: 1}  # the one-device mesh


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


class P(tuple):
    """Partition spec: one entry per array dimension, each an axis name, a
    tuple of axis names or None (replicated along that dimension). The
    counterpart of jax.sharding.PartitionSpec."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class Sharding:
    """Where an array of a grid lives: the grid's device and the spec that
    would split it over the mesh (the counterpart of NamedSharding)."""

    device: torch.device
    spec: P


def _device_table(devices: Sequence[Any] | None, device) -> list:
    if devices is not None:
        if device is not None:
            raise ValueError("pass devices= or device=, not both")
        return [default_device(d) for d in devices]
    return [default_device(device)]


def _one_device(kind: str, shape: tuple, devs: list, layout: int):
    """Refuse what needs more than one device, then the reference's own
    ValueErrors for the one-device grid."""
    c, d1, d2 = shape
    if c * d1 * d2 != 1:
        raise NotImplementedError(
            f"{kind} grid {shape} needs {c * d1 * d2} devices; the port "
            "runs on one device until the distributed substrate lands "
            "(ROADMAP queue M, item M9b)")
    if len(devs) != 1:
        raise ValueError(f"{kind} grid {shape} needs 1 device, got "
                         f"{len(devs)}")
    if layout not in (0, 1, 2):
        raise ValueError(f"unknown layout {layout}")
    if layout == 2:
        raise ValueError("layout=2 needs even grid sides")


@dataclass(frozen=True)
class Grid:
    """A (c, d1, d2) device grid; this slice supports (1, 1, 1) only.

    roles: the mesh axis names playing (depth, row, col); a role of None
    means "no axis", a dimension of size 1."""

    device: torch.device
    roles: tuple = ALL_AXES

    # ---- role indirection ----------------------------------------------

    @property
    def ax_z(self) -> str | None:
        return self.roles[0]

    @property
    def ax_y(self) -> str | None:
        return self.roles[1]

    @property
    def ax_x(self) -> str | None:
        return self.roles[2]

    def view(self, z=None, y=AXIS_Y, x=AXIS_X) -> "Grid":
        """The same mesh with its axes re-cast into new (depth, row, col)
        roles."""
        for name in (z, y, x):
            if name is not None and name not in _MESH_SHAPE:
                raise ValueError(f"unknown mesh axis {name!r}")
        return Grid(device=self.device, roles=(z, y, x))

    # ---- constructors -------------------------------------------------

    @classmethod
    def square(cls, c: int = 1, d: int | None = None,
               devices: Sequence[Any] | None = None, layout: int = 0,
               device=None) -> "Grid":
        """c-deep d x d grid over `devices` (P = c*d*d of them), or over
        the one `device` (default cuda:0)."""
        devs = _device_table(devices, device)
        if d is None:
            d = math.isqrt(len(devs) // c)
        _one_device("square", (c, d, d), devs, layout)
        return cls(device=devs[0])

    @classmethod
    def rect(cls, c: int = 1, devices: Sequence[Any] | None = None,
             layout: int = 0, device=None) -> "Grid":
        """d x c x c grid with the long axis d = P/c^2 on 'y'."""
        devs = _device_table(devices, device)
        p = len(devs)
        if c < 1 or c * c > p or p % (c * c):
            raise ValueError(f"rect grid needs c^2 | P: c={c}, P={p}")
        _one_device("rect", (c, p // (c * c), c), devs, layout)
        return cls(device=devs[0])

    @classmethod
    def hybrid(cls, c: int = 1, d: int | None = None,
               devices: Sequence[Any] | None = None,
               device=None) -> "Grid":
        """Multi-host grid (rows across hosts); on one host the JAX package
        builds square(), and so does the port."""
        return cls.square(c=c, d=d, devices=devices, device=device)

    # ---- properties ----------------------------------------------------

    @property
    def c(self) -> int:
        """Depth (replication) factor: the size of the depth-role axis."""
        return _MESH_SHAPE[self.ax_z] if self.ax_z else 1

    @property
    def d1(self) -> int:
        return _MESH_SHAPE[self.ax_y] if self.ax_y else 1

    @property
    def d2(self) -> int:
        return _MESH_SHAPE[self.ax_x] if self.ax_x else 1

    @property
    def d(self) -> int:
        """Side of the square slice; valid only when d1 == d2."""
        if self.d1 != self.d2:
            raise ValueError(f"grid is not square: {self.shape}")
        return self.d1

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

    # ---- shardings -----------------------------------------------------

    def sharding(self, spec: P) -> Sharding:
        """The descriptor of spec on this grid. Raises ValueError, as
        NamedSharding does, on an axis name the mesh lacks or one that two
        dimensions both name."""
        seen = []
        for entry in spec:
            names = entry if isinstance(entry, tuple) else (entry,)
            for name in names:
                if name is None:
                    continue
                if name not in ALL_AXES:
                    raise ValueError(f"axis {name!r} of {P(*spec)!r} is not "
                                     f"in the mesh's axes {ALL_AXES}")
                if name in seen:
                    raise ValueError(f"{P(*spec)!r} names axis {name!r} "
                                     "twice")
                seen.append(name)
        return Sharding(self.device, P(*spec))

    @property
    def slice_spec(self) -> P:
        """Partition spec of the (row, col) slice in this grid's roles."""
        return P(self.ax_y, self.ax_x)

    @property
    def block2d(self) -> Sharding:
        """Blocks over the (y, x) slice, replicated over z."""
        return self.sharding(P(self.ax_y, self.ax_x))

    @property
    def row1d(self) -> Sharding:
        """Rows over every device (the tall-skinny layout)."""
        return self.sharding(P(ALL_AXES, None))

    @property
    def replicated(self) -> Sharding:
        return self.sharding(P(None, None))

    def constrain(self, x: torch.Tensor, spec=None) -> torch.Tensor:
        """Sharding constraint: nothing to move on one device; spec is
        checked as sharding() checks it."""
        if spec is not None:
            self.sharding(spec)
        return x
