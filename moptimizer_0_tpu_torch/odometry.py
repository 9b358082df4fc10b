"""Scan odometry: the sequential registration front end.

PyTorch counterpart of the front-end half of ``moptimizer_0_tpu.odometry``:
consecutive scans are registered with ICP (one ``PairwiseRegistrar`` for the
whole stream) and the relative transforms are chained into a trajectory.
The pose-graph back end (``scan_slam``, ``scan_slam_fixed_lag``) comes with
the ``pose_graph`` slice (ROADMAP.md); this module does not need it.

Conventions: world pose of scan k is P_k (params6) with P_0 = I. Registering
scan j onto scan i returns T_ij with p_i ≈ T_ij · p_j.
"""

import torch

from moptimizer_0_tpu_torch.lie import se3, so3
from moptimizer_0_tpu_torch.registration import (
    PairwiseRegistrar,
    _check_ported,
    default_pipeline_config,
    icp,
)
from moptimizer_0_tpu_torch.utils.device import as_input


def _params6_of(T):
    return torch.cat([T[..., :3, 3], so3.log(T[..., :3, :3])], dim=-1)


def _compose(a, b):
    """params6 of T(a)·T(b)."""
    return _params6_of(se3.transform_from_params6(a) @ se3.transform_from_params6(b))


def chain_poses(rels):
    """World poses (K, 6) from relative measurements (K-1, 6), P_0 = I: the
    running product of the 4×4 transforms, with no host read."""
    Ts = se3.transform_from_params6(rels)
    T = torch.eye(4, dtype=rels.dtype, device=rels.device)
    world = []
    for k in range(rels.shape[0]):
        T = T @ Ts[k]
        world.append(T)
    ps = _params6_of(torch.stack(world)) if world else rels.new_zeros((0, 6))
    return torch.cat([rels.new_zeros((1, 6)), ps], dim=0)


def register_pair(src, tgt, *, x0=None, method="icp", config=None, registrar=None, **kwargs):
    """Align src onto tgt; returns (params6, LMResult).

    x0 seeds the solve. Without a seed and with a gate (max_corr_dist), a
    coarse ungated pass runs first. ``registrar``: a PairwiseRegistrar to
    reuse; it carries its own settings, so extra kwargs or another config
    beside it raise."""
    _check_ported(method)
    if registrar is not None:
        if registrar.method != method:
            raise ValueError(f"registrar was built for method={registrar.method!r}, got {method!r}")
        if kwargs:
            raise ValueError(
                "registrar=... carries its own search settings; extra kwargs "
                f"{sorted(kwargs)} would be silently ignored — bake them into "
                "the PairwiseRegistrar instead"
            )
        if config is not None and config != registrar.config:
            raise ValueError(
                "registrar=... was built with a different LMConfig than the "
                "one passed; rebuild the registrar with this config"
            )
        res = registrar.register(src, tgt, x0=x0)
        return res.x, res
    if method != "icp":
        raise ValueError(f"unknown method {method!r}")
    if config is None:
        config = default_pipeline_config()
    if x0 is None and kwargs.get("max_corr_dist") is not None:
        coarse = dict(kwargs, max_corr_dist=None)
        x0 = icp(src, tgt, config=config, **coarse).x
    res = icp(src, tgt, x0, config=config, **kwargs)
    return res.x, res


def make_registrar(method, config, **kwargs):
    """PairwiseRegistrar for scan streams, or None when not applicable."""
    if method != "icp":
        _check_ported(method)
        return None
    if config is None:
        config = default_pipeline_config()
    return PairwiseRegistrar(config=config, method=method, **kwargs)


def scan_odometry(scans, *, method="icp", config=None, seed_motion=True, registrar=None, **kwargs):
    """Sequential odometry over a list of (N, 3) scans.

    Returns (poses (K, 6) world poses, relative (K-1, 6) measurements).

    seed_motion: seed each pairwise solve with the previous relative
    transform (constant-velocity motion model).

    Each pair's grid overflow flag is read late, in windows: the flags of W
    pairs are fetched together once W newer pairs were dispatched. On a True
    flag the first flagged pair and every later one (their seeds chained
    through it) are registered again synchronously.
    """
    _check_ported(method)
    if registrar is None:
        registrar = make_registrar(method, config, **kwargs)
    elif kwargs:
        raise ValueError(
            "registrar=... carries its own search settings; extra kwargs "
            f"{sorted(kwargs)} would be silently ignored — bake them into "
            "the PairwiseRegistrar instead"
        )
    first = as_input(scans[0])
    K = len(scans)
    if K <= 1:
        return first.new_zeros((K, 6)), first.new_zeros((0, 6))
    rels = [None] * (K - 1)
    prev_rel = None
    if registrar is not None:
        W = 8
        inflight = []  # [(pair index, x0 used, device overflow flag), ...]

        def redo_chain(from_idx, last_idx, x0):
            for k2 in range(from_idx, last_idx + 1):
                r = registrar.register(scans[k2], scans[k2 - 1], x0=x0)
                rels[k2 - 1] = r.x
                x0 = r.x if seed_motion else None
            return rels[last_idx - 1]

        def check(window, last_idx):
            # one read for the window's flags; the corrected prev_rel, or None
            flags = [p[2] for p in window if p[2] is not None]
            if not flags or not bool(torch.stack(flags).any()):
                return None
            flagged = {p[0] for p in window if p[2] is not None and bool(p[2])}
            f0 = min(flagged)
            x0 = window[[p[0] for p in window].index(f0)][1]
            return redo_chain(f0, last_idx, x0)

        for k in range(1, K):
            x0 = prev_rel if seed_motion else None
            res, ovf = registrar.register(scans[k], scans[k - 1], x0=x0, defer_overflow=True)
            rels[k - 1] = res.x
            prev_rel = res.x
            inflight.append((k, x0, ovf))
            if len(inflight) >= 2 * W:
                head, inflight = inflight[:W], inflight[W:]
                redone = check(head, k)
                if redone is not None:
                    prev_rel = redone
                    inflight = []
        if inflight:
            redone = check(inflight, inflight[-1][0])
            if redone is not None:
                prev_rel = redone
    else:
        for k in range(1, K):
            x0 = prev_rel if seed_motion else None
            rel, _ = register_pair(scans[k], scans[k - 1], x0=x0, method=method, config=config, **kwargs)
            rels[k - 1] = rel
            prev_rel = rel
    rels = torch.stack(rels)
    return chain_poses(rels), rels
