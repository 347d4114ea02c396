"""The port's CholeskyQR2 across ranks against the JAX package's on its 8
virtual CPU devices: one 8-rank gloo world (tests/torch_mesh_ranks.py)
runs factor_1d on the 2 x 2 x 2, rect (c = 2) and 1D (c = 1) grids with
each Gram policy and with Q formed in place in 4 chunks; factor_1d with
the SYRK kernel's Gram (gram_kernel='tri': its plain version here; the
JAX package's Pallas SYRK in interpret mode, as its own tests run it);
factor_3d with the full and the partial inverse; factor_hybrid on the
rect grid with each Gram policy; and `factor`'s dispatch, from the same
numpy operands. Q and R agree with the JAX package's to relative
Frobenius 1e-5, and both packages' qr_orthogonality and qr_residual
(each package's own, across its ranks or devices) are below 1e-5; the
per-rank cost records equal the JAX package's per-device ones."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as R
from capital_tpu import tracing as jtracing
from capital_tpu import validate as jvalidate
from capital_tpu.algs import cacqr as jcacqr
from capital_tpu.algs import cholinv as jcholinv
from capital_tpu.grid import Grid as JGrid
from capital_tpu.ops import pallas_syrk

TOL = 1e-5
ROWS = jax.sharding.PartitionSpec(("z", "y", "x"), None)


@pytest.fixture(scope="module")
def port():
    return R.world(R.cacqr_world)


@pytest.fixture(scope="module")
def grids(grid222, grid_rect, grid1d8):
    return {"222": grid222, "rect": grid_rect, "1d8": grid1d8}


def _jcfg(chol=None, **kw):
    base = dict(base_method="xla", gram_kernel="dot")
    base.update(kw)
    cb = dict(min_bc=64, base_method="xla")
    cb.update(chol or {})
    return jcacqr.Config(chol=jcholinv.Config(**cb), **base)


def _rows(g, x):
    return jax.device_put(jnp.asarray(x), g.sharding(ROWS))


def _slice(g, x):
    return jax.device_put(jnp.asarray(x), g.sharding(g.slice_spec))


def _jqr(fn, g, a, cfg, layout):
    """(Q, R, orthogonality, residual, costs) of the JAX package, jitted."""
    with jtracing.trace() as t:
        q, r = jax.jit(lambda x: fn(g, x, cfg))(a)
    orth, res = jax.jit(lambda q, r, a: (
        jvalidate.qr_orthogonality(g, q, layout=layout),
        jvalidate.qr_residual(g, a, q, r, layout=layout)))(q, r, a)
    return np.asarray(q), np.asarray(r), float(orth), float(res), R.costs(t)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _match(got, want, key, costs=None):
    q, r, orth, res = got
    jq, jr, jorth, jres, jcosts = want
    assert _rel(q, jq) < TOL, (key, _rel(q, jq))
    assert _rel(r, jr) < TOL, (key, _rel(r, jr))
    assert max(orth, res, jorth, jres) < TOL, (key, got[2:], want[2:4])
    if costs is not None:
        assert set(costs) == set(jcosts), key
        for k in jcosts:
            assert costs[k][0] == jcosts[k][0] and \
                costs[k][3] == jcosts[k][3], (key, k)
            np.testing.assert_allclose(costs[k][1:3], jcosts[k][1:3],
                                       rtol=1e-12, err_msg=f"{key} {k}")


def test_gram_1d_each_policy_matches_jax(port, grids):
    a = R.tall(*R.QR_1D, 0)
    want = a.astype(np.float64).T @ a.astype(np.float64)
    for gname, g in grids.items():
        for pol in ("allreduce", "two_stage", "packed"):
            got = port["gram"][f"{gname} {pol}"]
            jg = jax.jit(lambda x: jcacqr.gram_1d(g, x, pol))(_rows(g, a))
            assert _rel(got, jg) < TOL and _rel(got, want) < TOL, (gname,
                                                                   pol)


def test_factor_1d_each_grid_and_policy_matches_jax(port, grids):
    a = R.tall(*R.QR_1D, 0)
    for gname, g in grids.items():
        for pol in ("allreduce", "two_stage", "packed"):
            key = f"1d {gname} {pol}"
            want = _jqr(jcacqr.factor_1d, g, _rows(g, a),
                        _jcfg(gram_policy=pol), "1d")
            _match(port["qr"][key], want, key, port["costs"][key])
        key = f"1d {gname} chunks"
        want = _jqr(jcacqr.factor_1d, g, _rows(g, a),
                    _jcfg(formq_chunks=4, num_iter=1), "1d")
        _match(port["qr"][key], want, key)


def test_factor_1d_syrk_kernel_gram_matches_jax(port, grid222):
    """gram_kernel='tri': the port's SYRK (its plain version on a CPU
    tensor; no plain-product Gram) against the JAX package's Pallas SYRK
    in interpret mode inside its shard_map."""
    a = R.tall(*R.QR_1D, 0)
    with mock.patch.object(pallas_syrk, "syrk_upper", functools.partial(
            pallas_syrk.syrk_upper, interpret=True)):
        want = _jqr(jcacqr.factor_1d, grid222, _rows(grid222, a),
                    _jcfg(gram_kernel="tri"), "1d")
    _match(port["qr"]["1d 222 tri"], want, "tri")
    assert port["tri_counts"]["gram_dot"] == 0
    assert port["dot_counts"]["gram_dot"] == 2  # one Gram a sweep


def test_factor_3d_matches_jax(port, grid222):
    b = R.tall(*R.QR_3D, 1)
    for ci in (True, False):
        key = f"3d {ci}"
        want = _jqr(jcacqr.factor_3d, grid222, _slice(grid222, b),
                    _jcfg(chol=dict(complete_inv=ci)), "2d")
        _match(port["qr"][key], want, key, port["costs"][key])


def test_factor_hybrid_each_policy_matches_jax(port, grid_rect):
    h = R.tall(*R.QR_HYB, 2)
    for pol in ("allreduce", "two_stage", "packed"):
        jg = jax.jit(lambda x: jcacqr.gram_hybrid(grid_rect, x, pol))(
            _rows(grid_rect, h))
        assert _rel(port["gram"][f"hybrid {pol}"], jg) < TOL, pol
        key = f"hybrid {pol}"
        want = _jqr(jcacqr.factor_hybrid, grid_rect, _rows(grid_rect, h),
                    _jcfg(gram_policy=pol, chol=dict(summa_impl="shard_map")),
                    "1d")
        _match(port["qr"][key], want, key, port["costs"][key])


def test_dispatch_and_errors_match_jax(port, grid_rect, cpus):
    h = R.tall(*R.QR_HYB, 2)
    want = _jqr(jcacqr.factor, grid_rect, _rows(grid_rect, h),
                _jcfg(local_thresh=128), "2d")
    _match(port["qr"]["dispatch"], want, "dispatch")
    g81 = JGrid.square(c=8, d=1, devices=cpus[:8])
    with pytest.raises(ValueError, match="c == d2"):
        jcacqr.factor_hybrid(g81, _rows(g81, h), _jcfg())
    kind, msg = port["errors"]["hybrid c != d2"]
    assert kind == "ValueError" and "c == d2" in msg


def test_validators_auto_layout_and_apply_q_match_jax(port, grid222):
    """layout='auto' reads Q's layout (rows over every rank: '1d'; the
    3D path's blocks: '2d') in both packages; apply_q(trans=True) of the
    row-sharded Q is R."""
    a = R.tall(*R.QR_1D, 0)
    g = grid222
    q, r = jax.jit(lambda x: jcacqr.factor_1d(g, x, _jcfg()))(_rows(g, a))
    want = (float(jvalidate.qr_orthogonality(g, q)),
            float(jvalidate.qr_residual(g, _rows(g, a), q, r)))
    got = port["auto"]["1d"]
    assert max(got + want) < TOL
    np.testing.assert_allclose(port["apply_qt"], np.asarray(r), atol=1e-4)
    b = R.tall(*R.QR_3D, 1)
    q, r = jax.jit(lambda x: jcacqr.factor_3d(g, x, _jcfg(
        chol=dict(complete_inv=False))))(_slice(g, b))
    want = (float(jvalidate.qr_orthogonality(g, q, layout="2d")),
            float(jvalidate.qr_residual(g, _slice(g, b), q, r,
                                        layout="2d")))
    assert max(port["auto"]["2d"] + want) < TOL
    np.testing.assert_allclose(port["auto"]["2d"], want, rtol=0.5)
