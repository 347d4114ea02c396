"""Device grids (counterpart of capital_tpu/grid.py).

The JAX package runs one program over a c x d1 x d2 mesh with axes
('z', 'y', 'x'): z the depth (replication) axis, y the grid rows, x the
grid columns. `roles` maps the algorithmic roles (depth, row, col) onto
those axis names, and `view()` re-casts them (cacqr's hybrid path factors
its Gram on the (z, x) square view of a rect grid).

The port runs one process per device (a rank). Outside a process group a
grid is the one-device grid c = d1 = d2 = 1 on one torch device, on which
every distributed call reduces to a local one; a grid of more than one
device needs a world. Inside one (`parallel/launch.py`, or `torchrun`
with `parallel.launch.init_from_env`), the constructors build on the
world's ranks, as the JAX package's build on `jax.devices()`: a `Mesh`
holds the (c, d1, d2) table of global ranks, permuted by `layout` as the
JAX package permutes devices, a torch `DeviceMesh` over it named
('z', 'y', 'x'), and a process group for every set of axes (the
collectives of parallel/collectives.py run on them). A grid of size 1
inside a world keeps the one-device routes of the algorithms.

A partition spec `P` names, for each array dimension, the mesh axes that
split it (major first) or None; a distributed array is a
parallel.darray.DArray, this rank's block of a global array.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

# Canonical axis names, outermost-first.
AXIS_Z = "z"  # depth / replication ("c")
AXIS_Y = "y"  # grid row coordinate
AXIS_X = "x"  # grid col coordinate
ALL_AXES = (AXIS_Z, AXIS_Y, AXIS_X)
_ONE_DEVICE_SHAPE = {AXIS_Z: 1, AXIS_Y: 1, AXIS_X: 1}


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


def spec_axes(entry) -> tuple:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class Sharding:
    """Where an array of a grid lives: the grid's device and the spec that
    splits it over the mesh (the counterpart of NamedSharding)."""

    device: torch.device
    spec: P


class Mesh:
    """The (c, d1, d2) table of global ranks of a world, axes ('z', 'y',
    'x'), with this rank's coordinates, the torch DeviceMesh over it and a
    process group for each non-empty set of axes (all created here, in
    one order on every rank, as process groups must be).

    The table may cover part of the world (the tuner's and the scaling
    sweep's sub-grids): every rank of the world builds the Mesh, since
    creating a group is collective, and a rank outside the table has
    `coord` None and holds no group."""

    def __init__(self, ranks: np.ndarray, device: torch.device):
        from torch.distributed.device_mesh import DeviceMesh

        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.shape = dict(zip(ALL_AXES, self.ranks.shape))
        me = dist.get_rank()
        where = np.argwhere(self.ranks == me)
        if len(where) > 1:
            raise ValueError(f"the mesh {self.ranks} names rank {me} twice")
        self.coord = (dict(zip(ALL_AXES, (int(i) for i in where[0])))
                      if len(where) else None)
        self.device_mesh = DeviceMesh(device.type,
                                      torch.from_numpy(self.ranks),
                                      mesh_dim_names=ALL_AXES)
        self._groups = {}
        for k in (1, 2, 3):
            for axes in itertools.combinations(ALL_AXES, k):
                if k == 1:
                    if self.coord is not None:
                        self._groups[axes] = self.device_mesh.get_group(
                            axes[0])
                    continue
                for members in self._partition(axes):
                    g = dist.new_group(sorted(members))
                    if me in members:
                        self._groups[axes] = g

    def _partition(self, axes: tuple) -> list:
        """The rank sets that vary only along `axes`, in a fixed order."""
        moved = np.moveaxis(self.ranks, [ALL_AXES.index(a) for a in axes],
                            list(range(3 - len(axes), 3)))
        flat = moved.reshape(-1, math.prod(self.shape[a] for a in axes))
        return [[int(r) for r in row] for row in flat]

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def axis_index(self, axes) -> int:
        """This rank's flat index over `axes` (row-major, first major)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coord[a]
        return idx

    def members(self, axes) -> list:
        """Global ranks that share this rank's other coordinates, by their
        flat index over `axes` in the order given."""
        index = [slice(self.coord[a], self.coord[a] + 1)
                 if a not in axes else slice(None) for a in ALL_AXES]
        sub = self.ranks[tuple(index)]
        order = [ALL_AXES.index(a) for a in axes]
        rest = [i for i in range(3) if i not in order]
        return [int(r) for r in np.transpose(sub, order + rest).reshape(-1)]

    def group(self, axes):
        """The process group of `axes` (any order) around this rank."""
        key = tuple(a for a in ALL_AXES if a in axes)
        return self._groups[key]


_MESHES: dict = {}


def _mesh(ranks: np.ndarray, device: torch.device) -> Mesh:
    """One Mesh per (world, rank table, device type): process groups are
    collective to create, and every rank builds the same grids in the same
    order, so a cache keyed on the table is consistent across ranks."""
    key = (id(dist.distributed_c10d._get_default_group()), device.type,
           ranks.shape, ranks.tobytes())
    if key not in _MESHES:
        _MESHES[key] = Mesh(ranks, device)
    return _MESHES[key]


def one_rank(grid: "Grid") -> "Grid | None":
    """The one-device grid on this rank's device when grid is a mesh of
    one rank (whose calls take the one-device route on the rank's block),
    else None."""
    if grid.mesh is not None and grid.num_devices == 1:
        return Grid(device=grid.device, roles=grid.roles)
    return None


def in_world() -> bool:
    """True when a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def _device_table(devices: Sequence[Any] | None, device) -> list:
    if devices is not None:
        if device is not None:
            raise ValueError("pass devices= or device=, not both")
        return [default_device(d) for d in devices]
    return [default_device(device)]


def _local_grid(kind: str, shape: tuple, devs: list, layout: int):
    """The one-device grid outside a world: refuse what needs more than
    one device, then the reference's own ValueErrors."""
    c, d1, d2 = shape
    if c * d1 * d2 != 1:
        raise RuntimeError(
            f"{kind} grid {shape} needs {c * d1 * d2} devices, one rank "
            "each: start a world (parallel.launch.launch, or torchrun with "
            "parallel.launch.init_from_env) and build the grid in every "
            "rank without devices= or device=")
    if len(devs) != 1:
        raise ValueError(f"{kind} grid {shape} needs 1 device, got "
                         f"{len(devs)}")
    if layout not in (0, 1, 2):
        raise ValueError(f"unknown layout {layout}")
    if layout == 2:
        raise ValueError("layout=2 needs even grid sides")


def _permute(ranks: np.ndarray, shape: tuple, layout: int) -> np.ndarray:
    """The JAX package's _build: the rank order for layout 0 (natural), 1
    (z innermost) and 2 (2 x 2 tiles of the slice first)."""
    c, d1, d2 = shape
    if layout == 0:
        return ranks.reshape(shape)
    if layout == 1:
        return ranks.reshape(d1, d2, c).transpose(2, 0, 1)
    if layout == 2:
        if d1 % 2 or d2 % 2:
            raise ValueError("layout=2 needs even grid sides")
        t = ranks.reshape(c, d1 // 2, d2 // 2, 2, 2)
        return t.transpose(0, 1, 3, 2, 4).reshape(shape)
    raise ValueError(f"unknown layout {layout}")


def _world_size() -> int:
    return dist.get_world_size()


@dataclass(frozen=True)
class Grid:
    """A (c, d1, d2) device grid.

    device: this rank's device. mesh: the world's Mesh, or None for the
    one-device grid outside a world. roles: the mesh axis names playing
    (depth, row, col); a role of None means "no axis", a dimension of
    size 1."""

    device: torch.device
    roles: tuple = ALL_AXES
    mesh: Mesh | None = field(default=None, compare=False, repr=False)

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

    @property
    def mesh_shape(self) -> dict:
        return self.mesh.shape if self.mesh is not None else _ONE_DEVICE_SHAPE

    def view(self, z=None, y=AXIS_Y, x=AXIS_X) -> "Grid":
        """The same mesh with its axes re-cast into new (depth, row, col)
        roles."""
        for name in (z, y, x):
            if name is not None and name not in ALL_AXES:
                raise ValueError(f"unknown mesh axis {name!r}")
        return Grid(device=self.device, roles=(z, y, x), mesh=self.mesh)

    # ---- constructors -------------------------------------------------

    @classmethod
    def _world(cls, shape: tuple, layout: int, ranks=None) -> "Grid":
        from capital_tpu_torch.parallel.launch import world_device

        if ranks is None:
            ranks = _permute(np.arange(_world_size()), shape, layout)
        return cls(device=world_device(), mesh=_mesh(ranks, world_device()))

    @classmethod
    def square(cls, c: int = 1, d: int | None = None,
               devices: Sequence[Any] | None = None, layout: int = 0,
               device=None, *, _prefix: bool = False) -> "Grid":
        """c-deep d x d grid: over the world's ranks (P = c*d*d of them)
        inside a world when neither devices= nor device= is given, else
        the one-device grid on `device` (default cuda:0).

        _prefix (the tuner's and the scaling sweep's sub-grids, the JAX
        package's Grid.square(c, d, devices=devs[:c*d*d])): over ranks
        0 .. c*d*d - 1 of a world that may hold more; every rank of the
        world builds it (creating groups is collective), and on a rank
        outside it `on_this_rank` is False."""
        if devices is None and device is None and in_world():
            p = _world_size()
            if d is None:
                d = math.isqrt(p // c)
            if c < 1 or d < 1 or c * d * d > p or (c * d * d != p
                                                   and not _prefix):
                rel = "<=" if _prefix else "=="
                raise ValueError(
                    f"square grid needs c*d*d {rel} P: c={c}, d={d}, P={p}")
            shape = (c, d, d)
            return cls._world(shape, layout, ranks=_permute(
                np.arange(math.prod(shape)), shape, layout))
        devs = _device_table(devices, device)
        if d is None:
            d = math.isqrt(len(devs) // c)
        _local_grid("square", (c, d, d), devs, layout)
        return cls(device=devs[0])

    @classmethod
    def rect(cls, c: int = 1, devices: Sequence[Any] | None = None,
             layout: int = 0, device=None) -> "Grid":
        """d x c x c grid with the long axis d = P/c^2 on 'y'."""
        world = devices is None and device is None and in_world()
        devs = None if world else _device_table(devices, device)
        p = _world_size() if world else len(devs)
        if c < 1 or c * c > p or p % (c * c):
            raise ValueError(f"rect grid needs c^2 | P: c={c}, P={p}")
        shape = (c, p // (c * c), c)
        if world:
            return cls._world(shape, layout)
        _local_grid("rect", shape, devs, layout)
        return cls(device=devs[0])

    @staticmethod
    def _hybrid_axes(c: int, d: int, n_hosts: int):
        """(per_host_shape, dcn_shape) for a c x d x d grid over n_hosts:
        exactly one axis is split across hosts, 'y' before 'z', so the
        column and depth collectives stay inside a host. Raises when no
        axis is divisible by n_hosts."""
        if d % n_hosts == 0:
            return (c, d // n_hosts, d), (1, n_hosts, 1)
        if c % n_hosts == 0:
            return (c // n_hosts, d, d), (n_hosts, 1, 1)
        raise ValueError(
            f"hybrid grid cannot split c={c} x d={d} x d={d} over "
            f"{n_hosts} hosts: none of the axes is divisible by the host "
            f"count; choose c/d so that n_hosts | d or n_hosts | c")

    @classmethod
    def hybrid(cls, c: int = 1, d: int | None = None,
               devices: Sequence[Any] | None = None,
               device=None) -> "Grid":
        """Multi-host grid: the row axis spans hosts, columns and depth
        stay inside one. One host (a world whose LOCAL_WORLD_SIZE, as
        torchrun sets it, is the whole world; or no world) builds
        square(). Ranks are taken host-major (rank = host * local size +
        local rank), as torchrun numbers them."""
        import os

        if not (devices is None and device is None and in_world()):
            return cls.square(c=c, d=d, devices=devices, device=device)
        p = _world_size()
        if d is None:
            d = math.isqrt(p // c)
        if c * d * d != p:
            raise ValueError(
                f"hybrid grid needs c*d*d == P: c={c}, d={d}, P={p}")
        local = int(os.environ.get("LOCAL_WORLD_SIZE", p))
        n_hosts = max(1, p // local)
        if n_hosts == 1:
            return cls.square(c=c, d=d)
        per_host, dcn = cls._hybrid_axes(c, d, n_hosts)
        t = np.arange(p).reshape(*dcn, *per_host)
        ranks = t.transpose(0, 3, 1, 4, 2, 5).reshape(c, d, d)
        return cls._world((c, d, d), 0, ranks=ranks)

    # ---- properties ----------------------------------------------------

    @property
    def on_this_rank(self) -> bool:
        """False on a rank of the world outside a square(_prefix=True)
        grid, which holds no block of it."""
        return self.mesh is None or self.mesh.coord is not None

    @property
    def c(self) -> int:
        """Depth (replication) factor: the size of the depth-role axis."""
        return self.mesh_shape[self.ax_z] if self.ax_z else 1

    @property
    def d1(self) -> int:
        return self.mesh_shape[self.ax_y] if self.ax_y else 1

    @property
    def d2(self) -> int:
        return self.mesh_shape[self.ax_x] if self.ax_x else 1

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
            for name in spec_axes(entry):
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

    def constrain(self, x, spec=None):
        """x laid out as spec. On the one-device grid outside a world
        there is nothing to move (spec is checked as sharding() checks
        it). On a mesh, x (a DArray, or a tensor every rank holds whole)
        is redistributed to spec, as a DArray; a dimension that does not
        divide its axes' size is replicated along them instead, the JAX
        package's rule."""
        if spec is None:
            return x
        self.sharding(spec)
        if self.mesh is None:
            return x
        from capital_tpu_torch.parallel import darray

        return darray.reshard(darray.as_darray(x, self.mesh),
                              darray.fit(self.mesh, x.shape, spec))
