"""Checkpoint and resume of solver state.

PyTorch counterpart of ``moptimizer_0_tpu.utils.checkpoint``, in its archive
layout: a nest of tensors (dicts, tuples, lists, dataclasses such as
``LMResult``) flattened to an ``.npz`` with ``__keys__``, the leaves' paths
as the JAX package writes them (``['key']``, ``[i]``, ``.field``; dict keys
sorted; None holds no leaf), and ``arr_i``, the i-th leaf. ``load`` restores
into a matching template, with the structure, shapes and dtypes checked.
"""

import dataclasses

import numpy as np
import torch


def _flatten(tree, prefix=""):
    """[(path, leaf)] in the JAX package's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{prefix}[{i}]")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [kv for f in dataclasses.fields(tree) for kv in _flatten(getattr(tree, f.name), f"{prefix}.{f.name}")]
    return [(prefix, tree)]


def _unflatten(template, leaves):
    """template's structure with its leaves taken in order from ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves) for v in template)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves) for f in dataclasses.fields(template)
        })
    return next(leaves)


def _numpy(leaf):
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def save(path, tree):
    """Write a nest of tensors to an .npz archive."""
    flat = _flatten(tree)
    arrays = {f"arr_{i}": _numpy(v) for i, (_, v) in enumerate(flat)}
    np.savez(path, __keys__=np.array([k for k, _ in flat], dtype=object), **arrays)


def load(path, template):
    """Read an archive into the structure of ``template``: each leaf a tensor
    of the template leaf's dtype and device. Raises ValueError when the
    structure or a shape differs."""
    with np.load(path, allow_pickle=True) as data:
        keys = list(data["__keys__"])
        arrays = [data[f"arr_{i}"] for i in range(len(keys))]
    flat = _flatten(template)
    t_keys = [k for k, _ in flat]
    if t_keys != keys:
        raise ValueError(f"checkpoint structure mismatch: saved {keys[:5]}..., template {t_keys[:5]}...")
    for a, (_, t) in zip(arrays, flat):
        if tuple(a.shape) != tuple(np.shape(_numpy(t))):
            raise ValueError(f"shape mismatch: saved {a.shape} vs template {tuple(np.shape(_numpy(t)))}")

    def restore(a, t):
        if isinstance(t, torch.Tensor):
            return torch.as_tensor(a, device=t.device).to(t.dtype)
        return torch.as_tensor(a)

    return _unflatten(template, iter([restore(a, t) for a, (_, t) in zip(arrays, flat)]))
