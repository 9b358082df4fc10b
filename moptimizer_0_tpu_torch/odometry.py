"""Scan odometry and mini-SLAM: the sequential registration front end and the
pose-graph back end.

PyTorch counterpart of ``moptimizer_0_tpu.odometry``: consecutive scans are
registered with ICP, point-to-plane ICP or GICP (one ``PairwiseRegistrar``
for the whole stream), the relative transforms are chained into a
trajectory, and loop-closure registrations feed a pose-graph optimization
(``pose_graph``) that redistributes the drift; ``scan_slam_fixed_lag`` keeps
a sliding window and marginalizes the oldest pose out of it.

Conventions: world pose of scan k is P_k (params6) with P_0 = I. Registering
scan j onto scan i returns T_ij with p_i ≈ T_ij · p_j, the pose-graph
measurement of the edge i → j.
"""

import dataclasses

import torch

from moptimizer_0_tpu_torch import pose_graph as pgo
from moptimizer_0_tpu_torch.lie import se3, so3
from moptimizer_0_tpu_torch.registration import (
    METHODS,
    PairwiseRegistrar,
    default_pipeline_config,
    gicp,
    icp,
    point2plane,
)
from moptimizer_0_tpu_torch.utils.device import as_input

_NO_KWARGS = (
    "registrar=... carries its own search settings; extra kwargs {} would be "
    "silently ignored — bake them into the PairwiseRegistrar instead"
)


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
    beside it raise. ``method``: "icp", "point2plane" or "gicp"."""
    if registrar is not None:
        if registrar.method != method:
            raise ValueError(f"registrar was built for method={registrar.method!r}, got {method!r}")
        if kwargs:
            raise ValueError(_NO_KWARGS.format(sorted(kwargs)))
        if config is not None and config != registrar.config:
            raise ValueError(
                "registrar=... was built with a different LMConfig than the "
                "one passed; rebuild the registrar with this config"
            )
        res = registrar.register(src, tgt, x0=x0)
        return res.x, res
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    solver = dict(icp=icp, gicp=gicp, point2plane=point2plane)[method]
    if config is None:
        config = default_pipeline_config()
    if x0 is None and kwargs.get("max_corr_dist") is not None:
        coarse = dict(kwargs, max_corr_dist=None)
        x0 = solver(src, tgt, config=config, **coarse).x
    res = solver(src, tgt, x0, config=config, **kwargs)
    return res.x, res


def make_registrar(method, config, **kwargs):
    """PairwiseRegistrar for scan streams, or None for a method it does not
    know (``register_pair`` then raises)."""
    if method not in METHODS:
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
    if registrar is None:
        registrar = make_registrar(method, config, **kwargs)
    elif kwargs:
        raise ValueError(_NO_KWARGS.format(sorted(kwargs)))
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


def scan_slam(
    scans,
    *,
    method="icp",
    loop_closures=(),
    config=None,
    pgo_config=None,
    information_scale=1.0,
    loop_information_scale=1.0,
    **kwargs,
):
    """Odometry, loop-closure registrations and pose-graph optimization.

    loop_closures: (i, j) scan-index pairs to register directly (scan j onto
    scan i), each seeded with the odometry's P_i⁻¹ · P_j. One registrar
    serves the front end and the closures; kwargs go into it and nowhere
    else. Returns (PGOResult, the odometry's poses (K, 6))."""
    registrar = make_registrar(method, config, **kwargs)
    rest = {} if registrar else kwargs
    poses_odo, rels = scan_odometry(scans, method=method, config=config, registrar=registrar, **rest)
    K = len(scans)
    dtype, dev = poses_odo.dtype, poses_odo.device

    edge_i = list(range(K - 1))
    edge_j = list(range(1, K))
    meas = [rels[k] for k in range(K - 1)]
    scales = [information_scale] * (K - 1)
    for i, j in loop_closures:
        Ti = se3.transform_from_params6(poses_odo[i])
        Tj = se3.transform_from_params6(poses_odo[j])
        z0 = _params6_of(torch.linalg.inv_ex(Ti)[0] @ Tj)
        z, _ = register_pair(scans[j], scans[i], x0=z0, method=method, config=config, registrar=registrar, **rest)
        edge_i.append(i)
        edge_j.append(j)
        meas.append(z)
        scales.append(loop_information_scale)

    eye = torch.eye(6, dtype=torch.float64)
    graph = pgo.PoseGraph(
        poses=poses_odo,
        edge_i=torch.as_tensor(edge_i, device=dev),
        edge_j=torch.as_tensor(edge_j, device=dev),
        measurements=torch.stack(meas),
        information=torch.stack([s * eye for s in scales]).to(dtype=dtype, device=dev),
        n_fixed=1,
    )
    if pgo_config is None:
        pgo_config = pgo.PGOConfig(max_iterations=30)
    return pgo.solve_pgo(graph, pgo_config), poses_odo


def scan_slam_fixed_lag(
    scans,
    *,
    window=8,
    method="icp",
    config=None,
    pgo_config=None,
    information_scale=1.0,
    **kwargs,
):
    """Streaming fixed-lag SLAM: bounded state, information kept.

    Per scan: register it against the previous scan (one registrar for the
    stream), append the odometry edge to a sliding window of poses, refine
    the window with PGO, and once the window holds more than ``window``
    poses marginalize the oldest out (``pose_graph.marginalize_oldest``): its
    pose is final and its information becomes a prior on the poses that
    stay. Returns the poses (K, 6): the finalized ones, then the window's."""
    registrar = make_registrar(method, config, **kwargs)
    rest = {} if registrar else kwargs
    if pgo_config is None:
        pgo_config = pgo.PGOConfig(max_iterations=15)
    first = as_input(scans[0])
    dtype, dev = first.dtype, first.device

    finalized = []
    graph = pgo.PoseGraph(
        poses=first.new_zeros((1, 6)),
        edge_i=torch.zeros(0, dtype=torch.int64, device=dev),
        edge_j=torch.zeros(0, dtype=torch.int64, device=dev),
        measurements=first.new_zeros((0, 6)),
        information=first.new_zeros((0, 6, 6)),
        n_fixed=1,
    )
    info = information_scale * torch.eye(6, dtype=dtype, device=dev)
    prev_rel = None
    for k in range(1, len(scans)):
        rel, _ = register_pair(scans[k], scans[k - 1], x0=prev_rel, method=method, config=config,
                               registrar=registrar, **rest)
        prev_rel = rel
        W = graph.poses.shape[0]
        ends = torch.arange(W - 1, W + 1, device=dev)
        graph = dataclasses.replace(
            graph,
            poses=torch.cat([graph.poses, _compose(graph.poses[-1], rel)[None]]),
            edge_i=torch.cat([graph.edge_i, ends[:1]]),
            edge_j=torch.cat([graph.edge_j, ends[1:]]),
            measurements=torch.cat([graph.measurements, rel[None]]),
            information=torch.cat([graph.information, info[None]]),
        )
        graph = dataclasses.replace(graph, poses=pgo.solve_pgo(graph, pgo_config).poses)
        if graph.poses.shape[0] > window:
            finalized.append(graph.poses[0])
            graph = pgo.marginalize_oldest(graph, 1)
    return torch.stack(finalized + list(graph.poses))
