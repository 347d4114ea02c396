"""The port's rank grids, distributed arrays, collectives and
born-sharded generators against the JAX package's mesh on its 8 virtual
CPU devices: one 8-rank gloo world (tests/torch_mesh_ranks.py) builds
every constructor and layout, lays a numpy operand out by every spec,
runs each collective on the layout-2 grid (whose process groups number
their ranks in another order than the mesh) and makes each generator on
three grids. Rank tables, coordinates, blocks and collective results are
exact; the generators' values are the same on every grid. Also the
launcher: a failing rank fails the whole call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import torch_mesh_ranks as R
from capital_tpu import matrix as jmatrix
from capital_tpu.grid import ALL_AXES
from capital_tpu.grid import Grid as JGrid
from capital_tpu_torch.grid import Grid

JMAKERS = {"square c2 l0": dict(kind="square", c=2, d=2),
           "square c2 l1": dict(kind="square", c=2, d=2, layout=1),
           "square c2 l2": dict(kind="square", c=2, d=2, layout=2),
           "square c8": dict(kind="square", c=8, d=1),
           "rect c2": dict(kind="rect", c=2),
           "rect c2 l1": dict(kind="rect", c=2, layout=1),
           "rect c1": dict(kind="rect", c=1),
           "hybrid c2": dict(kind="hybrid", c=2, d=2)}


@pytest.fixture(scope="module")
def port():
    return R.world(R.grid_world)


def _jgrid(cpus, kind, **kw):
    return getattr(JGrid, kind)(devices=cpus[:8], **kw)


def _ids(jg):
    return np.vectorize(lambda d: d.id)(jg.mesh.devices)


def test_rank_tables_match_jax(port, cpus):
    """Each constructor and layout: the rank table is the JAX mesh's
    device-id table, with its shape and sizes."""
    for name, kw in JMAKERS.items():
        kw = dict(kw)
        jg = _jgrid(cpus, kw.pop("kind"), **kw)
        np.testing.assert_array_equal(port["tables"][name], _ids(jg),
                                      err_msg=name)
        shape, c, d1, d2, nd, sq, plat, names = port["props"][name]
        assert (shape, c, d1, d2, nd, sq) == (jg.shape, jg.c, jg.d1, jg.d2,
                                              jg.num_devices, jg.is_square)
        assert plat == jg.platform == "cpu" and names == ALL_AXES


def test_coordinates_and_views_match_jax(port, cpus):
    """Every rank's mesh coordinates are its device's place in the JAX
    mesh; views re-cast roles as the JAX package's do."""
    for name, kw in JMAKERS.items():
        kw = dict(kw)
        ids = _ids(_jgrid(cpus, kw.pop("kind"), **kw))
        for row in port["ranks"]:
            assert row["coords"][name] == tuple(
                int(i) for i in np.argwhere(ids == row["rank"])[0]), name
    jg = JGrid.square(c=2, d=2, devices=cpus[:8], layout=2)
    for roles, got in port["views"].items():
        v = jg.view(*roles)
        assert got == (v.shape, v.num_devices, tuple(v.slice_spec),
                       tuple(v.block2d.spec), tuple(v.row1d.spec),
                       tuple(v.replicated.spec)), roles


def test_errors_and_hybrid_axes_match_jax(port, cpus):
    """The same arguments raise ValueError in both; _hybrid_axes (pure)
    agrees; one host's hybrid grid is the square grid."""
    jargs = {"square c3": ("square", dict(c=3)),
             "square d3": ("square", dict(c=1, d=3)),
             "rect c3": ("rect", dict(c=3)), "rect c4": ("rect", dict(c=4)),
             "layout odd": ("square", dict(c=8, d=1, layout=2)),
             "layout 5": ("square", dict(c=2, d=2, layout=5)),
             "hybrid c3": ("hybrid", dict(c=3))}
    for name, (kind, kw) in jargs.items():
        with pytest.raises(ValueError):
            _jgrid(cpus, kind, **kw)
        assert port["errors"][name][0] == "ValueError", (name,
                                                         port["errors"][name])
    for c, d, hosts in ((2, 4, 2), (4, 2, 2), (2, 2, 4), (1, 8, 4),
                        (3, 3, 2)):
        try:
            want = JGrid._hybrid_axes(c, d, hosts)
        except ValueError:
            with pytest.raises(ValueError):
                Grid._hybrid_axes(c, d, hosts)
            continue
        assert Grid._hybrid_axes(c, d, hosts) == want
    np.testing.assert_array_equal(port["tables"]["hybrid c2"],
                                  port["tables"]["square c2 l0"])


def test_blocks_and_redistributions_match_jax_shards(port, cpus):
    """Every rank's block of each spec is the JAX array's shard on the
    device of that id; every redistribution between the specs keeps the
    array; a dimension too narrow for its axes is replicated."""
    jg = JGrid.square(c=2, d=2, devices=cpus[:8], layout=2)
    a = R.operand(16, 8, 0)
    for name, spec in R.SPECS.items():
        arr = jax.device_put(jnp.asarray(a), NamedSharding(jg.mesh,
                                                          JP(*spec)))
        shards = {s.device.id: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for row in port["ranks"]:
            np.testing.assert_array_equal(row["blocks"][name],
                                          shards[row["rank"]], err_msg=name)
    assert all(port["trips"].values()), [k for k, v in port["trips"].items()
                                         if not v]
    narrow = jg.constrain(jnp.zeros((16, 1)), JP("y", "x"))
    assert tuple(narrow.sharding.spec)[:2] == ("y", None)
    assert all(row["narrow_spec"] == ("y", None) for row in port["ranks"])


def _jcollectives(jg):
    """The same collectives by lax inside the JAX package's shard_map,
    every device's block of the result by device id."""
    order = _ids(jg).reshape(-1)  # device id at each flat mesh position
    x = np.concatenate([R.operand(4, 6, 10 + int(i)) for i in order])
    x8 = np.concatenate([R.operand(4, 8, 10 + int(i)) for i in order])
    ops = {"gather_x1": lambda b: lax.all_gather(b, "x", axis=1, tiled=True),
           "gather_yx0": lambda b: lax.all_gather(b, ("y", "x"), axis=0,
                                                  tiled=True),
           "gather_xy0": lambda b: lax.all_gather(b, ("x", "y"), axis=0,
                                                  tiled=True),
           "psum_z": lambda b: lax.psum(b, "z"),
           "psum_all": lambda b: lax.psum(b, ALL_AXES),
           "scatter_y0": lambda b: lax.psum_scatter(
               b, "y", scatter_dimension=0, tiled=True),
           "scatter_zyx1": lambda b: lax.psum_scatter(
               b, ALL_AXES, scatter_dimension=1, tiled=True),
           "ppermute_yx": lambda b: lax.ppermute(
               b, ("y", "x"), [(0, 1), (1, 3), (3, 2), (2, 0)]),
           "ppermute_part": lambda b: lax.ppermute(b, "x", [(0, 1)])}
    out = {}
    for name, op in ops.items():
        src = x8 if name == "scatter_zyx1" else x
        f = jax.shard_map(op, mesh=jg.mesh, in_specs=JP(ALL_AXES),
                          out_specs=JP(ALL_AXES), check_vma=False)
        res = np.asarray(jax.jit(f)(jnp.asarray(src)))
        blocks = np.split(res, 8)
        out[name] = {int(order[p]): blocks[p] for p in range(8)}
    return out


def test_collectives_match_lax(port, cpus):
    jg = JGrid.square(c=2, d=2, devices=cpus[:8], layout=2)
    want = _jcollectives(jg)
    for row in port["ranks"]:
        for name, got in row["coll"].items():
            np.testing.assert_allclose(got, want[name][row["rank"]],
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} rank {row['rank']}")


def test_generators_born_sharded(port, grid222):
    """Every rank makes its own block: the matrix is the same on the
    layout-2 and layout-0 2 x 2 x 2 grids and the rect grid; shapes,
    padding and structure are the JAX package's (its values come from
    jax.random, the port's from a counter hash); debug and identity
    equal the JAX package's exactly."""
    gens = port["gens"]
    ref = gens["222"]
    for gname in ("222 l0", "rect"):
        for k in ("sym", "rand", "tall", "debug", "eye"):
            np.testing.assert_array_equal(gens[gname][k], ref[k],
                                          err_msg=f"{gname} {k}")
    key = jax.random.key(0)
    js = jmatrix.symmetric(grid222, 200, key, align=64)
    assert ref["sym"].shape == js.padded_shape and ref["sym_shape"] == (
        200, 200)
    s = ref["sym"]
    np.testing.assert_array_equal(s, s.T)
    np.testing.assert_array_equal(s[200:, :200], 0)
    np.testing.assert_array_equal(np.diag(s)[200:], 1)
    assert np.linalg.eigvalsh(ref["sym_global"].astype(np.float64)).min() > 0
    assert np.abs(s[:200, :200] - 200 * np.eye(200)).max() <= 0.5
    jr = jmatrix.rand(grid222, 100, 60, key)
    assert ref["rand"].shape == jr.padded_shape
    assert np.abs(ref["rand"]).max() <= 0.5
    jt = jmatrix.tall_skinny(grid222, 1000, 16, key)
    assert ref["tall"].shape == jt.padded_shape
    assert ref["tall_local"] == (125, 16)
    assert ref["tall_spec"] == (("z", "y", "x"), None)
    np.testing.assert_array_equal(ref["debug"],
                                  np.asarray(jmatrix.debug(grid222, 10,
                                                           6).data))
    np.testing.assert_array_equal(ref["eye"],
                                  np.asarray(jmatrix.identity(grid222,
                                                              6).data))


def test_launch_fails_when_a_rank_fails():
    """A rank that raises fails the whole call with its traceback, while
    the others wait in a collective it never joins."""
    with pytest.raises(RuntimeError, match="rank 1 failed") as exc:
        R.world(R.failing_world, ranks=2)
    assert "rank one fails on purpose" in str(exc.value)
