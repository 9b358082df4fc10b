"""Carry solve inputs and results across from the JAX package as numpy.

This module never imports the JAX package: it takes plain dicts, class names
and numpy arrays, which is what ``dataclasses.asdict`` and ``np.asarray`` give
on the other side.
"""

import dataclasses

import numpy as np
import torch

from moptimizer_0_tpu_torch.core import loss as _loss
from moptimizer_0_tpu_torch.core.solver import LMConfig

_LOSSES = {
    cls.__name__: cls
    for cls in (_loss.TrivialLoss, _loss.GemanMcClure, _loss.Huber, _loss.Cauchy)
}


def config_from_fields(fields):
    """The port's LMConfig from ``dataclasses.asdict`` of the JAX LMConfig.
    A numpy/JAX dtype in ``accum_dtype`` becomes its torch dtype."""
    fields = dict(fields)
    if fields.get("accum_dtype") is not None:
        fields["accum_dtype"] = getattr(torch, np.dtype(fields["accum_dtype"]).name)
    return LMConfig(**fields)


def loss_from_numpy(kind, params=None):
    """A loss from its class name and numpy parameters, e.g.
    ``loss_from_numpy("GemanMcClure", {"tau": np.asarray(1.0)})``."""
    if kind not in _LOSSES:
        raise ValueError(f"unknown loss {kind!r}; expected one of {sorted(_LOSSES)}")
    params = params or {}
    return _LOSSES[kind](**{k: torch.as_tensor(np.asarray(v)) for k, v in params.items()})


def _to_numpy(value):
    if isinstance(value, dict):
        return {k: _to_numpy(v) for k, v in value.items()}
    return value.detach().cpu().numpy()


def result_to_numpy(result):
    """An LMResult as a dict of numpy arrays: x, status, iterations, cost,
    lam and the (nested) trace."""
    return {f.name: _to_numpy(getattr(result, f.name)) for f in dataclasses.fields(result)}
