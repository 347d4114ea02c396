"""The port's one-device API surface against the JAX package's, on the
CPU: Grid.square/rect/hybrid with devices= (and the port's device=), the
view roles, partition specs and shardings, the matrix generators' spec=,
Tracer.model_time on the same recorded costs at the H100's rates,
__version__, and summa.gemm's impl check (F10)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import capital_tpu
import capital_tpu_torch
import torch_mesh_ranks
from capital_tpu import matrix as jmatrix
from capital_tpu import tracing as jtracing
from capital_tpu.algs import cholinv as jcholinv
from capital_tpu.grid import Grid as JGrid
from capital_tpu.parallel import summa as jsumma
from capital_tpu_torch import Grid, matrix, tracing
from capital_tpu_torch.algs import cholinv
from capital_tpu_torch.grid import P, Sharding
from capital_tpu_torch.parallel import summa
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(150, setup=120)

torch.set_num_threads(1)


def _one():
    return jax.devices("cpu")[:1]


def _props(g):
    return (g.shape, g.c, g.d1, g.d2, g.num_devices, g.is_square,
            tuple(g.roles), g.ax_z, g.ax_y, g.ax_x, g.platform)


CONSTRUCTORS = {
    "square": (lambda: JGrid.square(c=1, d=1, devices=_one()),
               lambda: Grid.square(c=1, d=1, devices=["cpu"])),
    "square_default_d": (lambda: JGrid.square(devices=_one()),
                         lambda: Grid.square(devices=[torch.device("cpu")])),
    "rect": (lambda: JGrid.rect(c=1, devices=_one()),
             lambda: Grid.rect(c=1, device="cpu")),
    "hybrid": (lambda: JGrid.hybrid(devices=_one()),
               lambda: Grid.hybrid(device="cpu")),
}


def test_constructors_match_jax():
    for kind, (jmake, make) in CONSTRUCTORS.items():
        jg, g = jmake(), make()
        assert _props(g) == _props(jg), kind
        assert g.device == torch.device("cpu") and g.d == jg.d == 1


def test_view_roles_match_jax():
    for roles in ((None, "z", "x"), ("z", "y", "x"), (None, None, None),
                  ("x", "y", None)):
        jg = JGrid.rect(c=1, devices=_one()).view(*roles)
        g = Grid.rect(c=1, device="cpu").view(*roles)
        assert _props(g) == _props(jg), roles
        assert tuple(g.slice_spec) == tuple(jg.slice_spec)
        for name in ("block2d", "row1d", "replicated"):
            sh = getattr(g, name)
            assert isinstance(sh, Sharding) and sh.device == g.device
            assert tuple(sh.spec) == tuple(getattr(jg, name).spec), name
        spec = g.slice_spec
        assert isinstance(spec, P) and repr(spec) == f"P{tuple(spec)!r}"
        assert g.sharding(spec) == Sharding(g.device, spec)
        x = torch.ones(3, 2)
        assert g.constrain(x, spec) is x and g.constrain(x) is x


def test_device_counts_raise_as_in_jax():
    """A device count the shape does not take is a ValueError in both. A
    grid of more than one device needs a world in the port (one rank a
    device): outside one it raises RuntimeError; inside a 4-rank world
    (tests/torch_mesh_ranks.py) the constructors build on the world's
    ranks, as the JAX package's build on its devices."""
    two, four = jax.devices("cpu")[:2], jax.devices("cpu")[:4]
    for jmake, make in (
            (lambda: JGrid.square(c=1, d=1, devices=two),
             lambda: Grid.square(c=1, d=1, devices=["cpu", "cpu"])),
            (lambda: JGrid.square(devices=two),
             lambda: Grid.square(devices=["cpu", "cpu"])),
            (lambda: JGrid.rect(c=2, devices=_one()),
             lambda: Grid.rect(c=2, device="cpu"))):
        with pytest.raises(ValueError):
            jmake()
        with pytest.raises(ValueError):
            make()
    assert JGrid.square(devices=four).shape == (1, 2, 2)
    for make in (lambda: Grid.square(devices=["cpu"] * 4),
                 lambda: Grid.rect(c=1, devices=["cpu"] * 2),
                 lambda: Grid.hybrid(c=2, d=1, device="cpu")):
        with pytest.raises(RuntimeError, match="start a world"):
            make()
    got = torch_mesh_ranks.world(torch_mesh_ranks.small_world, ranks=4)
    assert (got["square"], got["rect"], got["hybrid"]) == (
        JGrid.square(devices=four).shape, JGrid.rect(c=1, devices=four).shape,
        JGrid.hybrid(devices=four).shape) == ((1, 2, 2), (1, 4, 1), (1, 2, 2))
    assert got["local"] == (1, 1, 1)  # device= asks for the local grid
    assert got["too_big"][0] == "ValueError"
    with pytest.raises(ValueError, match="not both"):
        Grid.square(devices=["cpu"], device="cpu")
    with pytest.raises(ValueError, match="layout"):
        JGrid.square(devices=_one(), layout=2)
    with pytest.raises(ValueError, match="layout"):
        Grid.square(device="cpu", layout=2)
    assert Grid.square(device="cpu", layout=1).shape == (1, 1, 1)


def test_matrix_spec_matches_jax():
    """spec= places the result on the grid's device; shapes, padding and
    the deterministic generators' values are the JAX package's; a spec
    the mesh cannot take raises in both."""
    jg = JGrid.square(c=1, d=1, devices=_one())
    g = Grid.square(device="cpu")
    for jspec, spec in ((JP("y", "x"), P("y", "x")), (JP(None, None),
                                                      P(None, None))):
        pairs = (
            (jmatrix.rand(jg, 100, 60, jax.random.key(0), spec=jspec,
                          row_tile=128, col_tile=128),
             matrix.rand(g, 100, 60, 0, spec=spec, row_tile=128,
                         col_tile=128)),
            (jmatrix.symmetric(jg, 200, jax.random.key(0), spec=jspec,
                               align=128),
             matrix.symmetric(g, 200, 0, spec=spec, align=128)),
            (jmatrix.identity(jg, 96, spec=jspec),
             matrix.identity(g, 96, spec=spec)),
            (jmatrix.debug(jg, 40, 24, spec=jspec),
             matrix.debug(g, 40, 24, spec=spec)))
        for j, mine in pairs:
            assert mine.data.device == g.device
            assert (mine.shape, mine.padded_shape) == (j.shape,
                                                       j.padded_shape)
            # the pad region (zeros; an identity block for symmetric)
            jd, d = np.asarray(j.data), mine.data.numpy()
            m, n = j.shape
            np.testing.assert_array_equal(d[m:], jd[m:])
            np.testing.assert_array_equal(d[:, n:], jd[:, n:])
        np.testing.assert_array_equal(pairs[2][1].data.numpy(),
                                      np.asarray(pairs[2][0].data))
        np.testing.assert_array_equal(pairs[3][1].data.numpy(),
                                      np.asarray(pairs[3][0].data))
    t = matrix.tall_skinny(g, 300, 8, 0, spec=P(("z", "y", "x"), None))
    assert t.data.device == g.device and t.padded_shape == (300, 8)

    # a spec naming an axis the mesh lacks, or one axis twice, is refused
    # by both: by NamedSharding in JAX, by Grid.sharding here, and so by
    # constrain and every generator's spec=
    for entries in (("w", None), (("z", "q"), None), ("y", "y")):
        spec = P(*entries)
        with pytest.raises(Exception):  # ValueError, or DuplicateSpecError
            jg.sharding(JP(*entries))
        for make in (lambda: g.sharding(spec),
                     lambda: g.constrain(torch.zeros(2, 2), spec),
                     lambda: matrix.rand(g, 8, 8, 0, spec=spec),
                     lambda: matrix.symmetric(g, 8, 0, spec=spec),
                     lambda: matrix.identity(g, 8, spec=spec),
                     lambda: matrix.debug(g, 8, 8, spec=spec),
                     lambda: matrix.tall_skinny(g, 8, 4, 0, spec=spec)):
            with pytest.raises(ValueError):
                make()


def test_model_time_on_the_same_recorded_costs():
    """Both packages' cholinv cost records (n = 512, base case 128) give
    the same model time at each of the H100's rates, and it is the
    roofline formula: max(flops / rate, link bytes / link rate) + 1 us a
    message."""
    jg = JGrid.square(c=1, d=1, devices=_one())
    jcfg = jcholinv.Config(min_bc=128)
    with jtracing.trace() as jt:
        jax.eval_shape(lambda x: jcholinv.factor(jg, x, jcfg),
                       jnp.zeros((512, 512), jnp.float32))
    g = Grid.square(device="cpu")
    with tracing.trace() as t:
        cholinv.factor(g, matrix.symmetric(g, 512, 0),
                       cholinv.Config(min_bc=128))
    rates = tracing.H100
    assert rates.card == "NVIDIA H100 80GB HBM3, 700 W"
    assert (rates.flops_per_s["highest"], rates.flops_per_s["high"],
            rates.flops_per_s["default"], rates.link_bytes_per_s) == (
        67e12, 989e12 / 3, 989e12, 450e9)
    tot = t.totals()
    for level in ("highest", "high", "default"):
        got = t.model_time(rates.flops_per_s[level], rates.link_bytes_per_s)
        want = jt.model_time(rates.flops_per_s[level], rates.link_bytes_per_s)
        assert got == pytest.approx(want, rel=1e-12)
        assert got == pytest.approx(
            max(tot.flops / rates.flops_per_s[level],
                tot.comm_bytes / rates.link_bytes_per_s) + 1e-6 * tot.msgs,
            rel=1e-12)
    assert t.model_time(1e12, 1e9, latency_s=0.0) == pytest.approx(
        max(tot.flops / 1e12, tot.comm_bytes / 1e9))


def test_version_matches_jax():
    assert capital_tpu_torch.__version__ == capital_tpu.__version__
    assert "__version__" in capital_tpu_torch.__all__


def test_gemm_refuses_an_unknown_impl():
    """F10: summa.gemm (and syrk2, which goes through it) raise on an impl
    the engine does not have, as the JAX package does; every real impl
    computes the same product on one device."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 256)).astype(np.float32)
    b = rng.standard_normal((256, 128)).astype(np.float32)
    jg = JGrid.square(c=1, d=1, devices=_one())
    g = Grid.square(device="cpu")
    with pytest.raises(ValueError, match="unknown summa impl 'bogus'"):
        jsumma.gemm(jg, jnp.asarray(a), jnp.asarray(b), impl="bogus")
    with pytest.raises(ValueError, match="unknown summa impl 'bogus'"):
        summa.gemm(g, torch.from_numpy(a), torch.from_numpy(b),
                   impl="bogus")
    with pytest.raises(ValueError, match="unknown summa impl 'bogus'"):
        jsumma.syrk2(jg, jnp.asarray(a), jnp.asarray(a), impl="bogus")
    with pytest.raises(ValueError, match="unknown summa impl 'bogus'"):
        summa.syrk2(g, torch.from_numpy(a), torch.from_numpy(a),
                    impl="bogus")
    want = a.astype(np.float64) @ b
    for impl in ("shard_map", "ring", "gspmd"):
        got = summa.gemm(g, torch.from_numpy(a), torch.from_numpy(b),
                         impl=impl).double().numpy()
        jgot = np.asarray(jsumma.gemm(jg, jnp.asarray(a), jnp.asarray(b),
                                      impl=impl), np.float64)
        for x in (got, jgot):
            assert np.linalg.norm(x - want) / np.linalg.norm(want) < 1e-6
