"""Carry state across from the JAX package, as numpy.

The factorizations and solvers have no weights: their state is the
operand and the configuration. Both cross as plain data, so this module
imports nothing of the JAX package: a caller hands over
`np.asarray(dist_matrix.data)` and `dataclasses.asdict(cfg)`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from capital_tpu_torch.algs import cacqr, cholinv, newton, polar, tsqr
from capital_tpu_torch.grid import default_device
from capital_tpu_torch.matrix import DistMatrix, Structure


def dist_matrix_from_numpy(data, shape, structure_value="rect",
                           device=None) -> DistMatrix:
    """A DistMatrix holding a copy of `data` (padded storage) on `device`
    (None: cuda:0, raising when no GPU is present), with logical `shape`
    and the Structure whose value is given."""
    t = torch.from_numpy(np.array(data, copy=True)).to(default_device(device))
    return DistMatrix(t, tuple(int(s) for s in shape),
                      Structure(getattr(structure_value, "value",
                                        structure_value)))


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
