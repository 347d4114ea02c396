"""The port's CholeskyQR(2) against the JAX package's, on a one-device grid,
from the same numpy operand and config.

Two routes:
  * 'dot': both packages on their plain products (gram_kernel='dot', the
    CPU's 'auto' for TRMM and the Gram Cholesky);
  * 'tri': gram_kernel='tri', CAPITAL_TRMM_METHOD=tri and
    CAPITAL_CHOL_METHOD=pallas in both, so the JAX package runs its SYRK,
    TRMM and Cholesky-leaf Pallas kernels (in interpret mode, as its own
    tests run them) and the port its kernels' plain versions.

Q and R agree to relative Frobenius 1e-5 at 'highest' and 2e-5 at 'high'
(JAX's CPU tile_dot does not round the lo half to bf16; ROADMAP,
"Reference quirks"). Both packages' qr_orthogonality and qr_residual,
taken at the framework default 'highest' on plain products, are below
1e-5. The 17408-row operand is deeper than 32 x 512 rows, so the SYRK
fold fires.
"""

import contextlib
import dataclasses
import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu import validate as jvalidate
from capital_tpu.algs import cacqr as jcacqr
from capital_tpu.algs import cholinv as jcholinv
from capital_tpu.grid import Grid as JGrid
from capital_tpu.ops import pallas_chol, pallas_syrk, pallas_trmm
import torch_mesh_ranks
from capital_tpu_torch import Grid, interop, validate
from capital_tpu_torch.algs import cacqr
from capital_tpu_torch.ops import counters, reset_counters
from capital_tpu_torch.ops.precision import default_matmul_precision

torch.set_num_threads(1)

ENV = ("CAPITAL_TRMM_METHOD", "CAPITAL_SYRK_METHOD", "CAPITAL_CHOL_METHOD")
KERNEL_ENV = {"CAPITAL_TRMM_METHOD": "tri", "CAPITAL_SYRK_METHOD": "tri",
              "CAPITAL_CHOL_METHOD": "pallas"}
TOL = {"highest": 1e-5, "high": 2e-5}
N = 256


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


@functools.lru_cache(maxsize=None)
def _operand(m, n, seed):
    """tall_skinny's distribution, Uniform(-0.5, 0.5) times the column
    scale linspace(1, 2), made with numpy."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.5, 0.5, (m, n)) * np.linspace(1.0, 2.0, n)
    return a.astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@contextlib.contextmanager
def _route(route):
    """The route's environment; on 'tri' also the JAX package's three
    Pallas kernels in interpret mode (its call sites import them at call
    time, so the patch takes)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.dict(
            os.environ, KERNEL_ENV if route == "tri" else {}))
        if route == "tri":
            for mod, name in ((pallas_syrk, "syrk_upper"),
                              (pallas_trmm, "trmm_upper"),
                              (pallas_chol, "chol_inv_pallas")):
                stack.enter_context(mock.patch.object(
                    mod, name, functools.partial(getattr(mod, name),
                                                 interpret=True)))
        yield


def _jgrid():
    return JGrid.square(c=1, d=1, devices=jax.devices("cpu")[:1])


def _jcfg(route, chol=(), **kw):
    return jcacqr.Config(gram_kernel="tri" if route == "tri" else "dot",
                         chol=jcholinv.Config(**dict(chol)), **kw)


@functools.lru_cache(maxsize=None)
def _jax(fn, m, n, seed, level, route, chol=(), dtype="float32", **kw):
    """(Q, R, orthogonality, residual) of jcacqr.<fn> on _operand."""
    grid = _jgrid()
    a = jnp.asarray(_operand(m, n, seed), dtype)
    cfg = _jcfg(route, chol, **kw)
    with _route(route), jax.default_matmul_precision(level):
        q, r = jax.jit(lambda x: getattr(jcacqr, fn)(grid, x, cfg))(a)
    layout = "2d" if fn == "factor_3d" else "1d"
    orth = jax.jit(lambda x: jvalidate.qr_orthogonality(grid, x,
                                                        layout=layout))(q)
    res = jax.jit(lambda x, y, z: jvalidate.qr_residual(
        grid, x, y, z, layout=layout))(a, q, r)
    return (np.asarray(q.astype(jnp.float32)),
            np.asarray(r.astype(jnp.float32)), float(orth), float(res))


def _port(fn, m, n, seed, level, route, chol=(), dtype="float32", **kw):
    """(Q, R, orthogonality, residual, counters) of the port's cacqr.<fn>
    on the same operand, config from asdict of the JAX one."""
    grid = Grid.square(device="cpu")
    cfg = interop.cacqr_config_from_dict(
        dataclasses.asdict(_jcfg(route, chol, **kw)))
    a = torch.from_numpy(_operand(m, n, seed)).to(getattr(torch, dtype))
    with _route(route), default_matmul_precision(level):
        reset_counters()
        q, r = getattr(cacqr, fn)(grid, a, cfg)
        used = counters()
    layout = "2d" if fn == "factor_3d" else "1d"
    orth = float(validate.qr_orthogonality(grid, q, layout=layout))
    res = float(validate.qr_residual(grid, a, q, r, layout=layout))
    return q.float().numpy(), r.float().numpy(), orth, res, used


def _check(fn, m, level, route, tol=None, **kw):
    q_j, r_j, orth_j, res_j = _jax(fn, m, N, m, level, route, **kw)
    q, r, orth, res, used = _port(fn, m, N, m, level, route, **kw)
    tol = tol or TOL[level]
    assert _rel(q, q_j) < tol, _rel(q, q_j)
    assert _rel(r, r_j) < tol, _rel(r, r_j)
    assert max(orth, orth_j, res, res_j) < 1e-5, (orth, orth_j, res, res_j)
    return used


@pytest.mark.parametrize("route", ["tri", "dot"])
@pytest.mark.parametrize("level", ["highest", "high"])
@pytest.mark.parametrize("num_iter", [1, 2])
@pytest.mark.parametrize("m", [16384, 17408])
def test_factor_1d_matches_jax(m, num_iter, level, route):
    used = _check("factor_1d", m, level, route, num_iter=num_iter)
    gram_dot = used["gram_dot"]
    fallbacks = used["trmm_dot"] + used["syrk_dot"] + used["chol_xla"]
    if route == "tri":
        assert gram_dot == fallbacks == 0, used
    else:  # a plain Gram, TRMM and Cholesky a sweep, a TRMM to merge
        assert gram_dot == used["chol_xla"] == num_iter, used
        assert used["trmm_dot"] == 2 * num_iter - 1, used


@pytest.mark.parametrize("route", ["tri", "dot"])
def test_factor_1d_formq_chunks_matches_jax(route):
    """Q formed in place over the operand in 3 -> 2 chunks (16384 rows
    are no multiple of 3): two TRMMs a sweep, one to merge."""
    used = _check("factor_1d", 16384, "highest", route, formq_chunks=3)
    if route == "dot":
        assert used["trmm_dot"] == 2 * 2 + 1, used


@pytest.mark.parametrize("kernel", ["tri", "dot"])
@pytest.mark.parametrize("policy", ["allreduce", "two_stage", "packed"])
def test_gram_1d_matches_jax(policy, kernel):
    a = _operand(2048, N, 3)
    with _route(kernel):
        want = jax.jit(lambda x: jcacqr.gram_1d(_jgrid(), x, policy,
                                                kernel=kernel))(
            jnp.asarray(a))
        reset_counters()
        got = cacqr.gram_1d(Grid.square(device="cpu"), torch.from_numpy(a),
                            policy, kernel=kernel)
    assert counters()["gram_dot"] == (kernel == "dot")
    assert got.dtype == torch.float32 and got.shape == (N, N)
    assert _rel(got, want) < 1e-5
    if kernel == "tri" or policy == "packed":  # mirrored: exactly symmetric
        assert torch.equal(got, got.T)


def test_gram_1d_policy_checks():
    grid = Grid.square(device="cpu")
    a = torch.from_numpy(_operand(512, 96, 3))  # 128 does not divide 96
    with pytest.raises(ValueError, match="gram policy"):
        cacqr.gram_1d(grid, a, "ring")
    assert torch.equal(cacqr.gram_1d(grid, a, "packed"),
                       cacqr.gram_1d(grid, a, "allreduce"))


def test_tri_pack_round_trip_matches_jax():
    n = 384
    x = np.random.default_rng(7).standard_normal((n, n)).astype(np.float32)
    g = x + x.T
    packed = cacqr._pack_tri(torch.from_numpy(g))
    assert packed.shape == (6, 128, 128)
    assert packed.numel() == cacqr._tri_pack_size(n) == n * (n + 128) // 2
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jcacqr._pack_tri(g)))
    back = cacqr._unpack_tri(packed, n)
    np.testing.assert_array_equal(back.numpy(), g)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcacqr._unpack_tri(jnp.asarray(packed),
                                                      n)))


@pytest.mark.parametrize("route", ["tri", "dot"])
@pytest.mark.parametrize("chunks,nch", [(4, 4), (3, 2)])
def test_formq_inplace_matches_jax(chunks, nch, route):
    """Row chunks written over A, the largest count <= chunks that divides
    the 2048 rows (3 -> 2), as the JAX package chunks them."""
    a = _operand(2048, N, 4)
    rng = np.random.default_rng(5)
    rinv = np.triu(rng.standard_normal((N, N))).astype(np.float32)
    with _route(route):
        want = jax.jit(lambda x, t: jcacqr._formq_inplace(
            _jgrid(), x, t, chunks))(jnp.asarray(a), jnp.asarray(rinv))
        x = torch.from_numpy(a.copy())
        reset_counters()
        q = cacqr._formq_inplace(Grid.square(device="cpu"), x,
                                 torch.from_numpy(rinv), chunks)
    assert q.data_ptr() == x.data_ptr()
    assert counters()["trmm_dot"] == (nch if route == "dot" else 0)
    assert _rel(q, want) < 1e-5


@pytest.mark.parametrize("overwrite_a", [False, True])
@pytest.mark.parametrize("fn", ["factor_1d", "factor"])
def test_formq_chunks_overwrite_a(fn, overwrite_a):
    """With formq_chunks > 1 A keeps its values unless the caller passes
    overwrite_a=True, and then Q is A; Q and R match Q formed out of
    place."""
    grid = Grid.square(device="cpu")
    a0 = torch.from_numpy(_operand(2048, N, 6))
    a = a0.clone()
    q, r = getattr(cacqr, fn)(grid, a, cacqr.Config(formq_chunks=4),
                              overwrite_a=overwrite_a)
    q_ref, r_ref = cacqr.factor_1d(grid, a0, cacqr.Config())
    assert (q.data_ptr() == a.data_ptr()) == overwrite_a
    assert overwrite_a or torch.equal(a, a0)
    assert _rel(q, q_ref) < 1e-5 and _rel(r, r_ref) < 1e-5


@pytest.mark.parametrize("route", ["tri", "dot"])
@pytest.mark.parametrize("complete_inv", [True, False])
def test_factor_3d_matches_jax(complete_inv, route):
    """c = d = 1: Gram by summa.syrk, the recursive cholinv (base 128, so
    n = 256 splits once), Q by summa.trmm or, with a partial inverse,
    the 2-block back-substitution."""
    used = _check("factor_3d", 2048, "highest", route,
                  chol=(("min_bc", 128), ("complete_inv", complete_inv)))
    assert used["gram_dot"] == 0
    if route == "tri":
        assert used["trmm_dot"] == used["syrk_dot"] == 0, used


@pytest.mark.parametrize("local_thresh,path", [(4096, "factor_1d"),
                                               (128, "factor_3d")])
def test_factor_dispatch_matches_jax(local_thresh, path):
    kw = dict(chol=(("min_bc", 128),), local_thresh=local_thresh)
    _check("factor", 2048, "highest", "dot", **kw)
    q, r, *_ = _port("factor", 2048, N, 2048, "highest", "dot", **kw)
    q_p, r_p, *_ = _port(path, 2048, N, 2048, "highest", "dot", **kw)
    np.testing.assert_array_equal(q, q_p)
    np.testing.assert_array_equal(r, r_p)


def _row_sharded(grid, x):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from capital_tpu.grid import ALL_AXES

    return jax.device_put(x, NamedSharding(grid.mesh, P(ALL_AXES, None)))


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("layout", ["auto", "1d", "2d"])
def test_apply_q_matches_jax(layout, trans):
    """'auto' is '1d' on the one-device grid: the JAX package reads it
    from Q's row sharding."""
    m, k = 2048, 64
    q = _operand(m, N, 6)
    x = np.random.default_rng(8).standard_normal(
        (m if trans else N, k)).astype(np.float32)
    jg = _jgrid()
    want = jcacqr.apply_q(jg, _row_sharded(jg, jnp.asarray(q)),
                          jnp.asarray(x), trans=trans, layout=layout)
    got = cacqr.apply_q(Grid.square(device="cpu"), torch.from_numpy(q),
                        torch.from_numpy(x), trans=trans, layout=layout)
    assert got.shape == want.shape == (N if trans else m, k)
    assert _rel(got, want) < 1e-5


def test_apply_q_trans_out_dtype_matches_jax():
    """bf16 Q and X, the skinny projection Q^T X returned in f32."""
    q = _operand(2048, N, 6)
    x = np.random.default_rng(9).standard_normal((2048, 32))
    qb, xb = (jnp.asarray(v, jnp.bfloat16) for v in (q, x))
    want = jcacqr.apply_q(_jgrid(), qb, xb, trans=True, layout="1d",
                          out_dtype=jnp.float32)
    qt, xt = (torch.from_numpy(np.array(v.astype(jnp.float32))).bfloat16()
              for v in (qb, xb))
    got = cacqr.apply_q(Grid.square(device="cpu"), qt, xt, trans=True,
                        out_dtype=torch.float32)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert _rel(got, want) < 1e-5
    default = cacqr.apply_q(Grid.square(device="cpu"), qt, xt, trans=True)
    assert default.dtype == torch.bfloat16


def test_cholqr2_beats_cholqr1():
    """The second sweep is the conditioning fix: ill-conditioned columns
    (scaled over three decades) leave CholeskyQR's Q far from orthogonal
    and CholeskyQR2's within 1e-5."""
    from capital_tpu_torch import matrix

    grid = Grid.square(device="cpu")
    m, n = 2048, 32
    a = matrix.tall_skinny(grid, m, n, 1).data
    a = a * torch.logspace(0, 3, n)[None, :]
    orth = {}
    for it in (1, 2):
        q, r = cacqr.factor_1d(grid, a, cacqr.Config(num_iter=it,
                                                     base_method="xla"))
        orth[it] = float(validate.qr_orthogonality(grid, q))
    assert orth[2] < orth[1]
    assert orth[2] < 1e-5


def test_factor_1d_bf16_dot_matches_jax():
    """bf16 storage on the plain route: Q and R agree within one bf16 unit
    (2^-8 relative) and both Qs are orthogonal to bf16's storage limit."""
    q_j, r_j, orth_j, _ = _jax("factor_1d", 4096, N, 1, "highest", "dot",
                               dtype="bfloat16")
    q, r, orth, _, used = _port("factor_1d", 4096, N, 1, "highest", "dot",
                                dtype="bfloat16")
    assert used["gram_dot"] == 2
    assert _rel(q, q_j) < 2**-8, _rel(q, q_j)
    assert _rel(r, r_j) < 2**-8, _rel(r, r_j)
    assert max(orth, orth_j) < 2 * 2**-8, (orth, orth_j)


def test_cacqr_config_from_dict():
    jcfg = jcacqr.Config(num_iter=1, gram_policy="packed", local_thresh=512,
                         base_method="xla", formq_chunks=4,
                         gram_kernel="tri",
                         chol=jcholinv.Config(min_bc=128, split=2,
                                              complete_inv=False,
                                              base_policy="gather"))
    d = dataclasses.asdict(jcfg)
    cfg = interop.cacqr_config_from_dict(d)
    assert (cfg.num_iter, cfg.gram_policy, cfg.local_thresh,
            cfg.base_method, cfg.formq_chunks, cfg.gram_kernel) == (
        1, "packed", 512, "xla", 4, "tri")
    assert (cfg.chol.min_bc, cfg.chol.split, cfg.chol.complete_inv,
            cfg.chol.base_policy.value) == (128, 2, False, "gather")
    assert interop.cacqr_config_from_dict({}) == cacqr.Config()
    with pytest.raises(ValueError, match="unknown cacqr.Config fields"):
        interop.cacqr_config_from_dict(dict(d, tsqr=True))
    with pytest.raises(ValueError, match="unknown cholinv.Config fields"):
        interop.cacqr_config_from_dict(dict(d, chol=dict(d["chol"], x=1)))


def test_hybrid_path_needs_more_than_one_device():
    """The hybrid path across devices needs a rect grid of more than one
    device: outside a world the port refuses to build one; inside a
    2-rank world (tests/torch_mesh_ranks.py) it builds (1, 2, 1) and the
    hybrid path runs on it, Q's rows over both ranks, Q R = A to 1e-5.
    On the one-device rect grid it runs as before (its parity:
    tests/test_torch_cacqr_hybrid.py)."""
    with pytest.raises(RuntimeError, match="start a world"):
        Grid.rect(c=1, devices=["cpu", "cpu"])
    got = torch_mesh_ranks.world(torch_mesh_ranks.hybrid_world, ranks=2)
    assert got["grid"] == (1, 2, 1) and got["gram"] == (128, 128)
    assert got["q"] == (512, 128) and got["r"] == (128, 128)
    assert got["spec"] == (("z", "y", "x"), None) and got["res"] < 1e-5
    grid = Grid.rect(c=1, device="cpu")
    a = torch.from_numpy(_operand(512, 128, 0))
    assert cacqr.gram_hybrid(grid, a).shape == (128, 128)
    q, r = cacqr.factor_hybrid(grid, a)
    assert q.shape == a.shape and r.shape == (128, 128)


def test_construct_and_operand_device():
    q = torch.arange(20.0).reshape(5, 4)
    assert torch.equal(cacqr.construct_q(q, (3, 2)), q[:3, :2])
    assert cacqr.construct_q(q) is q
    assert torch.equal(cacqr.construct_r(q[:4]), torch.triu(q[:4]))
    assert torch.equal(cacqr.construct_r(q[:4], (2, 2)),
                       torch.triu(q[:4])[:2, :2])
    grid = Grid(device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="grid on cuda:0"):
        cacqr.factor_1d(grid, q)


def test_bf16_gates():
    """On a GPU grid bf16 takes the kernels from n = 1024 (measured on the
    card at cacqr's 2^22 x 1024 bf16 factor) and 'dot' below; f32 always
    the kernels; a CPU grid 'dot'. The CPU tensors here run the kernels'
    plain versions, so a fallback shows only in the dot counters."""
    from capital_tpu_torch.ops import blas

    assert blas.BF16_TRI_MIN_N == 1024
    resolve = cacqr._resolve_gram_kernel
    assert resolve("auto", torch.bfloat16, "gpu", 1024) == "tri"
    assert resolve("auto", torch.bfloat16, "gpu", 512) == "dot"
    assert resolve("auto", torch.float32, "gpu", 128) == "tri"
    assert resolve("auto", torch.float32, "cpu", 1024) == "dot"
    assert resolve("dot", torch.float32, "gpu", 1024) == "dot"
    rng = np.random.default_rng(2)
    for n, tri in ((1024, True), (512, False)):
        u = torch.from_numpy(np.triu(rng.standard_normal((n, n)))).bfloat16()
        b = torch.from_numpy(rng.standard_normal((4 * n + 128, n))).bfloat16()
        reset_counters()
        blas.trmm(u, b, side="R", platform="gpu")
        blas.syrk(b, platform="gpu")
        used = counters()
        assert used["trmm_dot"] == used["syrk_dot"] == (not tri), (n, used)
