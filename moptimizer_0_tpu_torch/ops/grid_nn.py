"""Voxel hash-grid nearest-neighbour search: the correspondence search of the
SLAM front end at scales where brute force is O(Q·M) too much.

PyTorch counterpart of ``moptimizer_0_tpu.ops.grid_nn``, in plain PyTorch on
both devices (the JAX package's query is XLA, not a Pallas kernel):

* **Build**, once per target cloud: voxelize at ``cell_size``, hash each
  occupied cell into a power-of-two table of S slots, bucket the points per
  slot and pad the buckets to the largest slot occupancy K. The result is a
  dense (S, K) index table and an (S, K, 3) coordinate table.
  ``build_hash_grid`` builds them in numpy on the host,
  ``build_hash_grid_device`` with tensor operations on the cloud's device
  (two host reads size the table), ``build_hash_grid_fixed`` at given
  capacities with no host read and a device overflow flag. All three give
  the same tables, slot for slot.
* **Query**: ``mode="cell"`` is the cell-major bucket join: queries are
  grouped by voxel cell (one stable sort), and each occupied cell's
  (2·rings+1)³-bucket neighbourhood is gathered once for all its queries.
  Where its capacities do not hold for a query set it falls back to
  ``mode="query"``, one neighbourhood gather per query. The two give equal
  results, element for element. The JAX package's ``lax.cond`` and
  ``while_loop`` become one host read per cell-major query (``HOST_READS``
  counts them). ``mode="auto"``, the default, is the JAX package's
  cell-major path for CPU tensors and the query-major path for CUDA
  tensors, where it takes a third of the cell-major time and reads nothing
  back (``chip_smoke.py``'s grid phase times both).

Semantics: the exact nearest neighbour of every query whose nearest target
lies closer than rings·cell_size; (−1, +inf) for every other query, a NaN
query included. Candidates beyond that radius are discarded even when a hash
collision surfaces one. d² is (dx·dx + dy·dy) + dz·dz in float32, each
operation rounded on its own, the arithmetic of the brute-force kernel K5;
ties go to the smallest point index. Cells must fit int32
(|coordinate / cell_size| < 2³¹), as in the JAX package.

The integer arithmetic of the JAX package wraps in uint32 and int32; here it
runs in int64, masked to 32 bits where the wrap matters, and every scatter
that JAX drops out of range is masked explicitly.
"""

import dataclasses

import numpy as np
import torch

from moptimizer_0_tpu_torch.ops.nn_search import knn
from moptimizer_0_tpu_torch.utils.device import as_input
from moptimizer_0_tpu_torch.utils.stats import median

# Large-prime XOR hash (Teschner et al.), wrapped to 32 bits on both sides.
_P1, _P2, _P3 = 73856093, 19349663, 83492791
_MASK32 = 0xFFFFFFFF

# Padding coordinate: (q − PAD_COORD)² overflows float32 to +inf for any
# finite query, so a padding slot never wins.
PAD_COORD = np.float32(1e30)

# Host reads made by grid_nearest_neighbors since import (or since a caller
# reset it to 0): one per cell-major query, none in query-major mode; and
# the cell-major queries among them that fell back to the query-major path.
HOST_READS = 0
FALLBACKS = 0


@dataclasses.dataclass
class HashGrid:
    """Dense bucketed voxel hash table.

    table_idx: (S, K) int32 point index per bucket slot, −1 in padding.
    table_pts: (S, K, 3) float32 coordinates, PAD_COORD in padding.
    cell_size: () float32 tensor, the voxel edge.
    max_cell_occupancy: the most points in one cell, rounded up to a
    multiple of 16 (sizes the cell-major query's per-cell capacity; 0 =
    unknown).
    n_points: M, the cloud's point count (0 = unknown).
    """

    table_idx: torch.Tensor
    table_pts: torch.Tensor
    cell_size: torch.Tensor
    max_cell_occupancy: int = 0
    n_points: int = 0

    @property
    def n_slots(self):
        return self.table_idx.shape[0]

    @property
    def bucket_size(self):
        return self.table_idx.shape[1]


def _hash_cells_np(cells, n_slots):
    c = cells.astype(np.int64).astype(np.uint32)
    h = (c[..., 0] * np.uint32(_P1)) ^ (c[..., 1] * np.uint32(_P2)) ^ (c[..., 2] * np.uint32(_P3))
    return (h & np.uint32(n_slots - 1)).astype(np.int64)


def _hash_cells_torch(cells, n_slots):
    """_hash_cells_np on integer tensors: the uint32 products in int64 (the
    low 32 bits of a product do not depend on the bits above them)."""
    c = cells.long() & _MASK32
    h = ((c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)) & _MASK32
    return h & (n_slots - 1)


def _cells(pts, cell_size):
    """Integer voxel cells of float32 points: floor(p / cell), a true float32
    division by a tensor on the points' device (CUDA divides by a host
    scalar through its reciprocal, which rounds differently)."""
    if not isinstance(cell_size, torch.Tensor):
        cell_size = torch.full((), cell_size, dtype=torch.float32, device=pts.device)
    return torch.floor(pts / cell_size).long()


def _round16(n):
    return ((n + 15) // 16) * 16


def _n_slots(n_occupied, occupancy_factor, min_slots):
    n = 1 << max(int(np.ceil(np.log2(max(occupancy_factor * n_occupied, 1)))), 4)
    return max(n, int(min_slots))


def _points(points):
    """(M, 3) float32 tensor: a tensor stays on its device, anything else
    goes to the card."""
    pts = as_input(points).to(torch.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be (M, 3); got {tuple(pts.shape)}")
    return pts


def _check_cell(cell_size):
    cell_size = float(cell_size)
    if not cell_size > 0:
        raise ValueError(f"cell_size must be positive; got {cell_size}")
    return cell_size


def _grid(table_idx, table_pts, cell_size, max_cell_occupancy, n_points):
    dev = table_idx.device
    return HashGrid(
        table_idx=table_idx,
        table_pts=table_pts,
        # filled on the device: a host copy would synchronise
        cell_size=torch.full((), cell_size, dtype=torch.float32, device=dev),
        max_cell_occupancy=int(max_cell_occupancy),
        n_points=int(n_points),
    )


def build_hash_grid(points, cell_size, *, occupancy_factor=2.0, min_slots=1, min_bucket=1,
                    min_cell_occupancy=0):
    """Bucket ``points`` (M, 3) into a hash grid with voxel edge ``cell_size``,
    in numpy on the host; the tables land on the device of a tensor
    ``points``, and on the card for anything else.

    S is the next power of two ≥ occupancy_factor · (occupied cells), at
    least 16; K the largest slot occupancy rounded up to a multiple of 16.
    min_slots / min_bucket / min_cell_occupancy are capacity floors (a scan
    stream passes its running maxima)."""
    pts_t = _points(points)
    pts = pts_t.cpu().numpy()
    M = pts.shape[0]
    cell_size = _check_cell(cell_size)

    cells = np.floor(pts / np.float32(cell_size)).astype(np.int64)
    # occupied-cell count through a 64-bit mixing key
    key = cells[:, 0] * np.int64(_P1) + cells[:, 1] * np.int64(_P2) + cells[:, 2] * np.int64(_P3)
    _, cell_counts = np.unique(key, return_counts=True)
    max_cell_occ = max(_round16(int(cell_counts.max())), int(min_cell_occupancy))
    n_slots = _n_slots(len(cell_counts), occupancy_factor, min_slots)

    slot = _hash_cells_np(cells, n_slots)
    order = np.argsort(slot, kind="stable")
    counts = np.bincount(slot, minlength=n_slots)
    K = max(_round16(max(int(counts.max()), 1)), int(min_bucket))

    starts = np.zeros(n_slots + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(M) - starts[slot[order]]
    table_idx = np.full((n_slots, K), -1, dtype=np.int32)
    table_pts = np.full((n_slots, K, 3), PAD_COORD, dtype=np.float32)
    rows = slot[order]
    table_idx[rows, rank] = order.astype(np.int32)
    table_pts[rows, rank] = pts[order]
    dev = pts_t.device
    return _grid(torch.as_tensor(table_idx, device=dev), torch.as_tensor(table_pts, device=dev),
                 cell_size, max_cell_occ, M)


def _device_occupancy(cells):
    """(distinct cells, largest cell occupancy) as device scalars, from 32-bit
    mixed keys: the JAX package's int32 key, wrapped explicitly. A key
    collision only undercounts the cells (the table size has a factor of
    margin) and overcounts the occupancy (the query falls back)."""
    key = (cells[:, 0] * _P1 + cells[:, 1] * _P2 + cells[:, 2] * _P3) & _MASK32
    sk = torch.sort(key).values
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    ar = torch.arange(sk.shape[0], device=sk.device)
    run = ar - torch.cummax(torch.where(first, ar, 0), 0).values
    return first.sum(), run.max() + 1


def _device_max_occupancy(cells, n_slots):
    return torch.bincount(_hash_cells_torch(cells, n_slots), minlength=n_slots).max()


def _device_fill_table_checked(pts, cells, n_slots, K):
    """The (S, K) tables at fixed capacities, and a device flag: True when a
    slot holds more than K points, whose extra points are then dropped."""
    M = pts.shape[0]
    slot = _hash_cells_torch(cells, n_slots)
    order = torch.argsort(slot, stable=True)
    slot_sorted = slot[order]
    counts = torch.bincount(slot, minlength=n_slots)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(M, device=pts.device) - starts[slot_sorted]
    keep = rank < K  # the JAX package's scatter drops the others
    flat_pos = (slot_sorted * K + rank)[keep]
    table_idx = torch.full((n_slots * K,), -1, dtype=torch.int32, device=pts.device)
    table_pts = torch.full((n_slots * K, 3), float(PAD_COORD), dtype=torch.float32, device=pts.device)
    kept = order[keep]
    table_idx[flat_pos] = kept.to(torch.int32)
    table_pts[flat_pos] = pts[kept]
    return table_idx.reshape(n_slots, K), table_pts.reshape(n_slots, K, 3), counts.max() > K


def _device_fill_table(pts, cells, n_slots, K):
    table_idx, table_pts, _ = _device_fill_table_checked(pts, cells, n_slots, K)
    return table_idx, table_pts


def build_hash_grid_device(points, cell_size, *, occupancy_factor=2.0, min_slots=1, min_bucket=1,
                           min_cell_occupancy=0):
    """``build_hash_grid`` with tensor operations on the cloud's device: the
    same tables (a stable sort by slot, as the host build's), sized by two
    host reads (the occupancy, then the largest bucket)."""
    pts = _points(points)
    cell_size = _check_cell(cell_size)
    cells = _cells(pts, cell_size)
    n_occupied, max_cell_occ = torch.stack(_device_occupancy(cells)).tolist()
    max_cell_occ = max(_round16(max_cell_occ), int(min_cell_occupancy))
    n_slots = _n_slots(n_occupied, occupancy_factor, min_slots)
    K = max(_round16(max(int(_device_max_occupancy(cells, n_slots)), 1)), int(min_bucket))
    table_idx, table_pts = _device_fill_table(pts, cells, n_slots, K)
    return _grid(table_idx, table_pts, cell_size, max_cell_occ, pts.shape[0])


def build_hash_grid_fixed(points, cell_size, n_slots, K, max_cell_occupancy=0):
    """A device build at given capacities, with no host read.

    Returns (HashGrid, overflow): overflow is a device bool, True when some
    slot held more than K points and the table lost points; the caller then
    rebuilds with ``build_hash_grid_device`` and redoes what used it."""
    pts = _points(points)
    cell_size = float(cell_size)
    table_idx, table_pts, overflow = _device_fill_table_checked(
        pts, _cells(pts, cell_size), int(n_slots), int(K)
    )
    return _grid(table_idx, table_pts, cell_size, max_cell_occupancy, pts.shape[0]), overflow


def _neighbor_offsets(rings, device):
    """The (2·rings+1)³ cell offsets (k³, 3) int64, made on ``device`` (a
    host copy would synchronise, and cannot be captured into a CUDA graph)."""
    r = torch.arange(-rings, rings + 1, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)


def _radius_sq(grid, rings):
    rc = rings * grid.cell_size
    return rc * rc


def _query_major(qf, grid, offsets, rings, chunk):
    """One gather of the (2·rings+1)³-cell neighbourhood per query, in
    chunks of ``chunk`` queries."""
    S = grid.n_slots
    r2 = _radius_sq(grid, rings)
    idx, dist = [], []
    for s in range(0, qf.shape[0], chunk):
        q = qf[s : s + chunk]
        cells = _cells(q, grid.cell_size)[:, None, :] + offsets[None, :, :]  # (n, k³, 3)
        slots = _hash_cells_torch(cells, S)  # (n, k³)
        cf = grid.table_pts[slots].reshape(q.shape[0], -1, 3)  # (n, k³·K, 3)
        cand_idx = grid.table_idx[slots].reshape(q.shape[0], -1)
        dx = q[:, 0:1] - cf[..., 0]
        dy = q[:, 1:2] - cf[..., 1]
        dz = q[:, 2:3] - cf[..., 2]
        d2 = dx * dx + dy * dy + dz * dz
        # padding and candidates beyond the radius (a hash collision may
        # surface a far bucket) never win
        d2 = torch.where((cand_idx >= 0) & (d2 < r2), d2, torch.inf)
        best_d2 = d2.min(dim=1).values
        # the smallest point index among exact ties
        best_idx = torch.where(d2 == best_d2[:, None], cand_idx, torch.iinfo(torch.int32).max).min(dim=1).values
        idx.append(torch.where(torch.isfinite(best_d2), best_idx, -1))
        dist.append(best_d2)
    return torch.cat(idx), torch.cat(dist)


# Packed cell key: 10 bits per axis relative to the query cloud's least cell;
# a larger extent falls back to the query-major path.
_KEY_BITS = 10
_KEY_SPAN = 1 << _KEY_BITS


def _auto_mode(device):
    """The query path of mode="auto" on ``device``."""
    return "query" if device.type == "cuda" else "cell"


def grid_nearest_neighbors(query, grid, *, rings=1, chunk=4096, mode="auto", query_capacity=None,
                           max_cells=None):
    """Nearest neighbour of each query within rings·cell_size, via the grid.

    Returns (idx (Q,) int32, d² (Q,) float32): the exact nearest neighbour
    where it lies closer than rings·cell_size, (−1, +inf) elsewhere.

    mode="cell" runs the cell-major bucket join and falls back to the
    query-major path when its capacities do not hold: a relative extent of
    1024 cells or more on an axis, a non-finite query, more than
    ``max_cells`` (default min(S, Q)) occupied query cells, more than
    ``query_capacity`` (default from the grid's cell occupancy) queries in a
    cell, or a cloud of 2²⁴ points or more (the index rides as a float).
    mode="query" forces the query-major path. Both give equal results.
    mode="auto" is "query" for CUDA tensors and "cell" otherwise.
    """
    global HOST_READS, FALLBACKS
    Q = query.shape[0]
    qf = query.to(torch.float32)
    offsets = _neighbor_offsets(rings, qf.device)  # (k³, 3) int64
    if mode == "auto":
        mode = _auto_mode(qf.device)
    if mode == "query" or Q < 2:
        return _query_major(qf, grid, offsets, rings, chunk)
    if mode != "cell":
        raise ValueError(f"unknown mode {mode!r}")

    S, K, n_off = grid.n_slots, grid.bucket_size, offsets.shape[0]
    if query_capacity is not None:
        Kq = int(query_capacity)
    elif grid.max_cell_occupancy > 0:
        # 1.25× the target's cell occupancy, for query clouds somewhat denser
        Kq = -(-(grid.max_cell_occupancy * 5 // 4 + 4) // 8) * 8
    else:
        Kq = K
    C_max = int(max_cells) if max_cells is not None else min(S, Q)
    # cells a chunk: the (CC, Kq, k³·K) distance block stays ~32 MB of f32
    CC = max(8, min(1024, (1 << 23) // max(Kq * n_off * K, 1)))
    C_pad = -(-C_max // CC) * CC

    # group the queries by cell: one stable sort of the packed keys
    cellf = torch.floor(qf / grid.cell_size)
    in_range = cellf.abs() < 2.0**30  # False for NaN and inf
    cell = torch.where(in_range, cellf, 0.0).long()
    rel = cell - cell.min(dim=0).values
    ok_extent = in_range.all() & (rel.max() < _KEY_SPAN)
    rel = rel.clamp(max=_KEY_SPAN - 1)
    key = (rel[:, 0] << (2 * _KEY_BITS)) | (rel[:, 1] << _KEY_BITS) | rel[:, 2]
    sk, order = torch.sort(key, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    gid = torch.cumsum(first, 0) - 1  # group id in sorted order
    n_cells = gid[-1] + 1
    arangeQ = torch.arange(Q, device=qf.device)
    rank = arangeQ - torch.cummax(torch.where(first, arangeQ, 0), 0).values  # rank in its cell
    n_pts = grid.n_points if grid.n_points > 0 else grid.table_idx.numel()
    ok = ok_extent & (n_cells <= C_max) & (rank.max() < Kq) & (n_pts < (1 << 24))
    # the one host read: the JAX package's lax.cond and while_loop bound
    ok, n_cells = torch.stack([ok.long(), n_cells]).tolist()
    HOST_READS += 1
    if not ok:
        FALLBACKS += 1
        return _query_major(qf, grid, offsets, rings, chunk)

    # (cell, rank)-padded query buffer; padding rows are zero and never read
    flat = gid * Kq + rank
    qpad = torch.zeros((C_pad * Kq, 3), dtype=torch.float32, device=qf.device)
    qpad[flat] = qf[order]
    r2 = _radius_sq(grid, rings)
    # coordinates and index in one (S, K, 4) row: one gather a cell and ring;
    # the index rides as an exact float (< 2²⁴, gated in ok)
    aug = torch.cat([grid.table_pts, grid.table_idx[..., None].to(torch.float32)], dim=-1)
    obuf = torch.empty((C_pad * Kq, 2), dtype=torch.float32, device=qf.device)
    obuf[:, 0] = torch.inf
    obuf[:, 1] = -1.0
    for c0 in range(0, n_cells, CC):
        qc = qpad[c0 * Kq : (c0 + CC) * Kq].reshape(CC, Kq, 3)
        # each cell's voxel from its (always present) rank-0 row
        nbr = _cells(qc[:, 0, :], grid.cell_size)[:, None, :] + offsets[None, :, :]  # (CC, k³, 3)
        cand4 = aug[_hash_cells_torch(nbr, S)]  # (CC, k³, K, 4)
        cf = cand4[..., :3].reshape(CC, n_off * K, 3)
        cand_idx = cand4[..., 3].reshape(CC, 1, n_off * K)
        dx = qc[:, :, 0:1] - cf[:, None, :, 0]
        dy = qc[:, :, 1:2] - cf[:, None, :, 1]
        dz = qc[:, :, 2:3] - cf[:, None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz  # (CC, Kq, k³·K)
        d2 = torch.where((d2 < r2) & (cand_idx >= 0), d2, torch.inf)
        bd2 = d2.min(dim=-1).values
        idx_win = torch.where(d2 == bd2[..., None], cand_idx, torch.inf).min(dim=-1).values
        idx_win = torch.where(torch.isfinite(bd2), idx_win, -1.0)
        obuf[c0 * Kq : (c0 + CC) * Kq] = torch.stack([bd2.reshape(-1), idx_win.reshape(-1)], dim=-1)
    got = torch.empty((Q, 2), dtype=torch.float32, device=qf.device)
    got[order] = obuf[flat]
    return got[:, 1].to(torch.int32), got[:, 0]


def estimate_spacing(points, *, sample=1024, seed=0, k=8, generator=None):
    """Median nearest-neighbour spacing of a point cloud: the first strictly
    positive distance among each sampled point's k nearest (skipping exact
    duplicates), over a sample of ``sample`` points drawn without
    replacement by ``generator`` (default: a CPU generator seeded with
    ``seed``). The JAX package draws with ``jax.random.choice``, which this
    does not reproduce: the two agree when sample ≥ M (the whole cloud)."""
    pts = _points(points)
    M = pts.shape[0]
    if M < 2:
        raise ValueError("need at least 2 points to estimate spacing")
    n = min(sample, M)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    sel = torch.randperm(M, generator=generator, device=generator.device)[:n].to(pts.device)
    _, d2 = knn(pts[sel], pts, min(k, M))
    first_pos = torch.where(d2 > 0, d2, torch.inf).min(dim=1).values
    valid = torch.isfinite(first_pos)
    if not bool(valid.any()):
        raise ValueError(
            f"all {n} sampled points have >= {k} exact duplicates; "
            "cannot estimate spacing — pass an explicit cell size"
        )
    return float(torch.sqrt(median(first_pos[valid])))
