"""Carry solve inputs and results across from the JAX package as numpy.

This module never imports the JAX package: it takes plain dicts, class names
and numpy arrays, which is what ``dataclasses.asdict`` and ``np.asarray`` give
on the other side.
"""

import dataclasses

import numpy as np
import torch

from moptimizer_0_tpu_torch.ba import BAProblem
from moptimizer_0_tpu_torch.ba_dense import DenseBAConfig
from moptimizer_0_tpu_torch.core import loss as _loss
from moptimizer_0_tpu_torch.core.solver import LMConfig
from moptimizer_0_tpu_torch.ops.grid_nn import HashGrid
from moptimizer_0_tpu_torch.pose_graph import PGOConfig, PGOPrior, PoseGraph
from moptimizer_0_tpu_torch.utils.device import require

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


def ba_problem_from_numpy(camera_params, points, cam_idx, pt_idx, pixels, intrinsics,
                          n_fixed_cameras=1, loss=None, device="cuda"):
    """The port's BAProblem from the numpy arrays of a JAX BAProblem's fields
    (``np.asarray`` of each); indices become int64, floats keep their dtype.
    ``loss`` is a port loss (e.g. from ``loss_from_numpy``) or None. On the
    card unless ``device`` says otherwise; without a card the default raises."""
    device = require(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)  # a writable copy

    return BAProblem(
        camera_params=t(camera_params),
        points=t(points),
        cam_idx=t(cam_idx, torch.int64),
        pt_idx=t(pt_idx, torch.int64),
        pixels=t(pixels),
        intrinsics=t(intrinsics),
        loss=loss,
        n_fixed_cameras=int(n_fixed_cameras),
    )


def hash_grid_from_numpy(table_idx, table_pts, cell_size, max_cell_occupancy=0, n_points=0,
                         device="cuda"):
    """The port's ``ops.grid_nn.HashGrid`` from the numpy arrays of a JAX
    HashGrid's fields (``np.asarray`` of each), so that both packages query
    one table. On the card unless ``device`` says otherwise."""
    device = require(device)
    return HashGrid(
        table_idx=torch.as_tensor(np.array(table_idx, dtype=np.int32), device=device),
        table_pts=torch.as_tensor(np.array(table_pts, dtype=np.float32), device=device),
        cell_size=torch.full((), float(np.asarray(cell_size)), dtype=torch.float32, device=device),
        max_cell_occupancy=int(max_cell_occupancy),
        n_points=int(n_points),
    )


def dense_config_from_fields(fields):
    """The port's DenseBAConfig from ``dataclasses.asdict`` of the JAX one."""
    return DenseBAConfig(**fields)


def pose_graph_from_numpy(poses, edge_i, edge_j, measurements, information, n_fixed=1, prior=None,
                          loss=None, device="cuda"):
    """The port's PoseGraph from the numpy arrays of a JAX PoseGraph's fields
    (``np.asarray`` of each); edge indices become int64, floats keep their
    dtype. ``prior``: a dict of the PGOPrior's arrays (x_ref, sqrt_info,
    offset, idx) or None; ``loss`` a port loss or None. On the card unless
    ``device`` says otherwise."""
    device = require(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    if prior is not None:
        prior = PGOPrior(x_ref=t(prior["x_ref"]), sqrt_info=t(prior["sqrt_info"]), offset=t(prior["offset"]),
                         idx=t(prior["idx"], torch.int64))
    return PoseGraph(
        poses=t(poses),
        edge_i=t(edge_i, torch.int64),
        edge_j=t(edge_j, torch.int64),
        measurements=t(measurements),
        information=t(information),
        loss=loss,
        prior=prior,
        n_fixed=int(n_fixed),
    )


def pgo_config_from_fields(fields):
    """The port's PGOConfig from ``dataclasses.asdict`` of the JAX one."""
    return PGOConfig(**fields)


def _to_numpy(value):
    if isinstance(value, dict):
        return {k: _to_numpy(v) for k, v in value.items()}
    return value.detach().cpu().numpy()


def result_to_numpy(result):
    """An LMResult, a BAResult or a PGOResult as a dict of numpy arrays, one
    per field, the (nested) trace as a dict of them."""
    return {f.name: _to_numpy(getattr(result, f.name)) for f in dataclasses.fields(result)}
