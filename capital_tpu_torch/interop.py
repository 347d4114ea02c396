"""Carry state across from the JAX package, as numpy.

The factorizations, solvers and applications have no weights: their
state is the operand (ratings, factors) and the configuration. Both cross
as plain data, so this module imports nothing of the JAX package: a
caller hands over `np.asarray(dist_matrix.data)` (or any array, through
torch.from_numpy), `dataclasses.asdict(cfg)` and, for sparse ALS, the
four arrays of a SparseRatings.

Across ranks a global numpy array becomes the port's distributed array
with `dist_from_numpy` (each rank copies only its own block to its
device), and `to_numpy` gathers one back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from capital_tpu_torch.algs import (cacqr, cholinv, eigh, newton, polar,
                                    svd, tsqr)
from capital_tpu_torch.apps import als, rsvd
from capital_tpu_torch.grid import P, Grid, default_device
from capital_tpu_torch.matrix import DistMatrix, Structure
from capital_tpu_torch.parallel import darray


def dist_matrix_from_numpy(data, shape, structure_value="rect",
                           device=None) -> DistMatrix:
    """A DistMatrix holding a copy of `data` (padded storage) on `device`
    (None: cuda:0, raising when no GPU is present), with logical `shape`
    and the Structure whose value is given."""
    t = torch.from_numpy(np.array(data, copy=True)).to(default_device(device))
    return DistMatrix(t, tuple(int(s) for s in shape),
                      Structure(getattr(structure_value, "value",
                                        structure_value)))


def dist_from_numpy(data, grid: Grid, spec=None):
    """The global numpy array `data` on the grid: on a mesh a DArray of
    `spec` (default the grid's slice spec), each rank copying its own
    block to its device; on the one-device grid a tensor on its device."""
    arr = np.asarray(data)
    if grid.mesh is None:
        return torch.from_numpy(np.array(arr, copy=True)).to(grid.device)
    spec = grid.slice_spec if spec is None else P(*spec)
    probe = darray.DArray(torch.empty(0), arr.shape, spec, grid.mesh)
    idx = tuple(slice(s, s + n) for s, n in
                (probe.block(i) for i in range(arr.ndim)))
    local = torch.from_numpy(np.array(arr[idx], copy=True))
    return darray.DArray(local.to(grid.device), arr.shape, probe.spec,
                         grid.mesh)


def to_numpy(x) -> np.ndarray:
    """A DArray gathered whole (a collective: every rank of its mesh
    calls it), a DistMatrix's data, or a tensor, as a numpy array."""
    if isinstance(x, DistMatrix):
        x = x.data
    return darray.to_global(x).detach().cpu().numpy()


def _check_fields(cls, d: dict) -> None:
    unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"unknown {cls.__module__.rsplit('.', 1)[-1]}."
                         f"Config fields: {sorted(unknown)}")


def config_from_dict(d: dict) -> cholinv.Config:
    """The port's cholinv.Config from `dataclasses.asdict` of the JAX one.
    base_policy may be the enum member or its string value; an unknown
    field raises."""
    _check_fields(cholinv.Config, d)
    kw = dict(d)
    if "base_policy" in kw:
        kw["base_policy"] = getattr(kw["base_policy"], "value",
                                    kw["base_policy"])
    return cholinv.Config(**kw)


def cacqr_config_from_dict(d: dict) -> cacqr.Config:
    """The port's cacqr.Config from `dataclasses.asdict` of the JAX one;
    the nested `chol` dict goes through config_from_dict. An unknown
    field, here or in `chol`, raises."""
    _check_fields(cacqr.Config, d)
    kw = dict(d)
    if "chol" in kw:
        kw["chol"] = config_from_dict(kw["chol"])
    return cacqr.Config(**kw)


def polar_config_from_dict(d: dict) -> polar.Config:
    """The port's polar.Config from `dataclasses.asdict` of the JAX one;
    the nested `chol` dict goes through config_from_dict. An unknown
    field, here or in `chol`, raises."""
    _check_fields(polar.Config, d)
    kw = dict(d)
    if "chol" in kw:
        kw["chol"] = config_from_dict(kw["chol"])
    return polar.Config(**kw)


def eigh_config_from_dict(d: dict) -> eigh.Config:
    """The port's eigh.Config from `dataclasses.asdict` of the JAX one; the
    nested `polar` dict goes through polar_config_from_dict. An unknown
    field, here or nested, raises."""
    _check_fields(eigh.Config, d)
    kw = dict(d)
    if "polar" in kw:
        kw["polar"] = polar_config_from_dict(kw["polar"])
    return eigh.Config(**kw)


def svd_config_from_dict(d: dict) -> svd.Config:
    """The port's svd.Config from `dataclasses.asdict` of the JAX one: its
    `polar` through polar_config_from_dict, its `eig` through
    eigh_config_from_dict. An unknown field, here or nested, raises."""
    _check_fields(svd.Config, d)
    kw = dict(d)
    if "polar" in kw:
        kw["polar"] = polar_config_from_dict(kw["polar"])
    if "eig" in kw:
        kw["eig"] = eigh_config_from_dict(kw["eig"])
    return svd.Config(**kw)


def newton_config_from_dict(d: dict) -> newton.Config:
    """The port's newton.Config from `dataclasses.asdict` of the JAX one;
    an unknown field raises."""
    _check_fields(newton.Config, d)
    return newton.Config(**d)


def tsqr_config_from_dict(d: dict) -> tsqr.Config:
    """The port's tsqr.Config from `dataclasses.asdict` of the JAX one;
    an unknown field raises."""
    _check_fields(tsqr.Config, d)
    return tsqr.Config(**d)


def rsvd_config_from_dict(d: dict) -> rsvd.Config:
    """The port's rsvd.Config from `dataclasses.asdict` of the JAX one; the
    nested `qr` dict goes through cacqr_config_from_dict. An unknown
    field, here or nested, raises."""
    _check_fields(rsvd.Config, d)
    kw = dict(d)
    if "qr" in kw:
        kw["qr"] = cacqr_config_from_dict(kw["qr"])
    return rsvd.Config(**kw)


def als_config_from_dict(d: dict) -> als.Config:
    """The port's als.Config from `dataclasses.asdict` of the JAX one; an
    unknown field raises."""
    _check_fields(als.Config, d)
    return als.Config(**d)


def sparse_ratings_from_numpy(idx, val, idx_t, val_t,
                              device=None) -> als.SparseRatings:
    """A SparseRatings on `device` (None: cuda:0, raising when no GPU is
    present) from the JAX one's four arrays: the index buckets as int64,
    the ratings in their own dtype."""
    dev = default_device(device)

    def t(x, dtype=None):
        x = torch.from_numpy(np.array(x, copy=True))
        return x.to(dev, dtype)

    return als.SparseRatings(idx=t(idx, torch.int64), val=t(val),
                             idx_t=t(idx_t, torch.int64), val_t=t(val_t))
