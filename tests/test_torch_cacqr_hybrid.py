"""The port's hybrid CholeskyQR path (cacqr.gram_hybrid, factor_hybrid)
against the JAX package's, on a one-device rect grid (1 x 1 x 1), from
the same numpy operand, for each Gram policy:

  * 'dot': both packages on their plain products (gram_kernel='dot');
  * 'tri': gram_kernel='tri' and CAPITAL_TRMM_METHOD=tri in both, so the
    JAX package runs its Pallas SYRK and TRMM (in interpret mode, as its
    own tests run them) and the port its kernels' plain versions.

Q and R agree to relative Frobenius 1e-5; both packages' qr_orthogonality
and qr_residual are below 1e-5; the cost tables (CQR::gram's gram_hybrid
record, the Cholesky's on the square view) are the JAX package's.
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

import torch_mesh_ranks as R
from capital_tpu import tracing as jtracing
from capital_tpu import validate as jvalidate
from capital_tpu.algs import cacqr as jcacqr
from capital_tpu.grid import Grid as JGrid
from capital_tpu.ops import pallas_syrk, pallas_trmm
from capital_tpu_torch import Grid, interop, tracing, validate
from capital_tpu_torch.algs import cacqr
from capital_tpu_torch.ops import counters, reset_counters
from torch_mesh_ranks import limit_module, limit_test  # noqa: F401

pytestmark = pytest.mark.time_limit(60, setup=120)

torch.set_num_threads(1)

M, N = 1024, 64
POLICIES = ("two_stage", "allreduce", "packed")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in [v for v in os.environ if v.startswith("CAPITAL_")]:
        monkeypatch.delenv(var)


@functools.lru_cache(maxsize=None)
def _operand(m, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.5, 0.5, (m, n)) * np.linspace(1.0, 2.0, n)
    return a.astype(np.float32)


@contextlib.contextmanager
def _route(route):
    with contextlib.ExitStack() as stack:
        if route == "tri":
            R.setenv(stack.enter_context(pytest.MonkeyPatch.context()),
                     CAPITAL_TRMM_METHOD="tri")
            for mod, name in ((pallas_syrk, "syrk_upper"),
                              (pallas_trmm, "trmm_upper")):
                stack.enter_context(mock.patch.object(
                    mod, name, functools.partial(getattr(mod, name),
                                                 interpret=True)))
        yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _jgrid():
    return JGrid.rect(c=1, devices=jax.devices("cpu")[:1])


def _grid():
    return Grid.rect(c=1, device="cpu")


@pytest.mark.parametrize("route", ["tri", "dot"])
@pytest.mark.parametrize("policy", POLICIES)
def test_factor_hybrid_matches_jax(policy, route):
    a = _operand(M, N, 1)
    jcfg = jcacqr.Config(gram_policy=policy, gram_kernel=route)
    cfg = interop.cacqr_config_from_dict(dataclasses.asdict(jcfg))
    jg = _jgrid()
    with _route(route):
        jax.clear_caches()  # a cold trace records every cost
        with jtracing.trace() as jt:
            jax.eval_shape(lambda x: jcacqr.factor_hybrid(jg, x, jcfg),
                           jnp.asarray(a))
        jq, jr = jax.jit(lambda x: jcacqr.factor_hybrid(jg, x, jcfg))(
            jnp.asarray(a))
        reset_counters()
        with tracing.trace() as t:
            q, r = cacqr.factor_hybrid(_grid(), torch.from_numpy(a), cfg)
        used = counters()
    assert q.shape == (M, N) and r.shape == (N, N)
    assert _rel(q, jq) < 1e-5, _rel(q, jq)
    assert _rel(r, jr) < 1e-5, _rel(r, jr)
    assert torch.equal(r, torch.triu(r))
    jorth = float(jax.jit(lambda x: jvalidate.qr_orthogonality(
        jg, x, layout="1d"))(jq))
    jres = float(jax.jit(lambda x, y, z: jvalidate.qr_residual(
        jg, x, y, z, layout="1d"))(jnp.asarray(a), jq, jr))
    grid = _grid()
    orth = float(validate.qr_orthogonality(grid, q, layout="1d"))
    res = float(validate.qr_residual(grid, torch.from_numpy(a), q, r,
                                     layout="1d"))
    assert max(orth, res, jorth, jres) < 1e-5, (orth, res, jorth, jres)
    want = {k: dataclasses.astuple(v) for k, v in jt.by_phase.items()}
    got = {k: dataclasses.astuple(v) for k, v in t.by_phase.items()}
    assert got == want
    assert "CQR::gram/gram_hybrid" in got
    # the Gram is the SYRK kernel's plain version on 'tri', a plain
    # product on 'dot'
    assert used["gram_dot"] == (2 if route == "dot" else 0), used


def test_gram_hybrid_num_iter_1_and_checks():
    """gram_hybrid for each policy (128 | n: 'packed' packs and unpacks),
    factor_hybrid with one sweep, and the operand and policy checks."""
    a = _operand(2048, 128, 2)
    for policy in POLICIES:
        want = jax.jit(lambda x: jcacqr.gram_hybrid(
            _jgrid(), x, policy, kernel="dot"))(jnp.asarray(a))
        got = cacqr.gram_hybrid(_grid(), torch.from_numpy(a), policy,
                                kernel="dot")
        assert got.dtype == torch.float32 and got.shape == (128, 128)
        assert _rel(got, want) < 1e-6, policy
    with pytest.raises(ValueError, match="gram policy"):
        cacqr.gram_hybrid(_grid(), torch.from_numpy(a), "ring")
    a = _operand(M, N, 3)
    jcfg = jcacqr.Config(num_iter=1, gram_kernel="dot")
    jq, jr = jax.jit(lambda x: jcacqr.factor_hybrid(_jgrid(), x, jcfg))(
        jnp.asarray(a))
    q, r = cacqr.factor_hybrid(_grid(), torch.from_numpy(a),
                               cacqr.Config(num_iter=1, gram_kernel="dot"))
    assert _rel(q, jq) < 1e-5 and _rel(r, jr) < 1e-5
    with pytest.raises(ValueError, match="grid on cuda:0"):
        cacqr.factor_hybrid(Grid(device=torch.device("cuda", 0)),
                            torch.from_numpy(a))
