"""Sharded linearization and distributed LM.

PyTorch counterpart of ``moptimizer_0_tpu.parallel.sharded``. The
Gauss-Newton sums of a block are sums over its rows, so the (cost, H, b) of
a block split into row shards is the sum of the shards' own: each shard is
linearized as a block of its own (every derivative mode, the fused
linearizer included) and ``Mesh.psum`` reduces them, in shard order and
then across processes.

* ``sharded_linearize`` / ``sharded_compute_cost``: one reduction of the
  shards' (cost, H, b) or cost.
* ``distributed_levenberg_marquardt``: every block with data padded and
  sharded, and ``core.solver.levenberg_marquardt`` run unchanged over a
  ``ShardedProblem``, whose update hooks run shard by shard (a
  correspondence search a shard) and whose linearization and costs are
  reduced over the mesh. Every process of a mesh that spans processes gets
  the same reduced bytes, so the solver's control flow is the same on all
  of them. On CUDA, with a mesh that captures on x's device
  (``Mesh.captures_on``: one process, or processes reducing on the device,
  through CUDA IPC buffers or NCCL), the solve is the unsharded one's CUDA graph in every
  process: one replay an outer iteration, the shards' data in its carry
  (``core.solver``). Over a process's several peer cards it is one graph
  a card, each running its own shards (``ShardedProblem.on``).
"""

import dataclasses
from typing import Any

import torch

from moptimizer_0_tpu_torch.core.linearize import _batched_residuals, _linearize_block
from moptimizer_0_tpu_torch.core.residual import Problem
from moptimizer_0_tpu_torch.core.solver import LMConfig, levenberg_marquardt
from moptimizer_0_tpu_torch.parallel.mesh import _rows, is_global, pad_block_to, shard_block_data


@dataclasses.dataclass
class ShardedProblem(Problem):
    """A problem whose blocks' rows are spread over the shards of a mesh.

    blocks: the problem's own blocks (their count and names).
    shards: one Problem a local shard, holding that shard's part of every
        block, on the shard's device. A captured solve carries every
        shard's data leaves (``core.solver._data_leaves``), as it does an
        unsharded problem's.
    """

    shards: tuple = ()
    mesh: Any = None

    def update(self, x):
        """Every shard's update hooks, each on its shard's device."""
        shards = tuple(p.update(x.to(dev)) for p, dev in zip(self.shards, self.mesh.devices))
        return dataclasses.replace(self, shards=shards)

    def on(self, view):
        """The part of this problem that ``view``, a card's view of its mesh
        (``Mesh.on_card``), runs: that card's shards, reducing over the
        whole mesh through the view."""
        return dataclasses.replace(self, shards=tuple(self.shards[j] for j in view.shards), mesh=view)

    def over_shards(self, fn, x):
        """Σ over the mesh of fn(shard's problem, x on the shard's device),
        on x's device; ``core.linearize`` evaluates a ShardedProblem so."""
        parts = [fn(p, x.to(dev)) for p, dev in zip(self.shards, self.mesh.devices)]
        return self.mesh.psum(parts, device=x.device)


def _shards_of(block, mesh, axis):
    if block.data is None:
        raise ValueError(f"block {block.name!r} has no data to shard")
    n_shards = mesh.check_axis(axis)
    if not is_global(block) and _rows(block) % n_shards:
        block = pad_block_to(block, n_shards)
    return shard_block_data(block, mesh, axis)


def sharded_linearize(block, x, mesh, axis="data", mode="auto"):
    """(cost, H, b) with per-shard linearization and a sum over the mesh.
    Rows that do not divide the shard count are padded (``pad_block_to``)."""
    shards = _shards_of(block, mesh, axis)
    parts = [_linearize_block(b, x.to(dev), mode) for b, dev in zip(shards, mesh.devices)]
    return mesh.psum(parts, device=x.device)


def sharded_compute_cost(block, x, mesh, axis="data"):
    """Σ valid ‖r‖² summed over the mesh (the reference's parallelComputeCost)."""

    def cost(b, xs):
        r, valid = _batched_residuals(b, xs)
        return torch.sum(torch.where(valid, torch.sum(r * r, dim=-1), 0.0))

    shards = _shards_of(block, mesh, axis)
    return mesh.psum([cost(b, x.to(dev)) for b, dev in zip(shards, mesh.devices)], device=x.device)


@dataclasses.dataclass(frozen=True)
class _Silenced:
    """A residual function with every row marked invalid. Equal for one
    inner function, so two solves of one layout share their step's key."""

    inner: Any

    def __call__(self, state, d):
        out = self.inner(state, d)
        return (out[0] if isinstance(out, tuple) else out), False


def _silenced(block):
    """The block with every residual marked invalid: it adds nothing (exact
    zeros unless its Jacobian is not finite)."""
    return dataclasses.replace(block, residual_fn=_Silenced(block.residual_fn), linearize_fn=None)


def distributed_levenberg_marquardt(problem, x0, mesh, config=LMConfig(), manifold=None, axis="data"):
    """LM with every block's residual rows sharded across the mesh.

    Blocks with data are padded to the shard count and split; a block
    without data counts once, on the mesh's first shard. The damped solve of
    the small (P, P) system runs on every process, on reduced inputs. On
    CUDA, with every local shard on x's device and the sums device work
    (``Mesh.captures_on``: one process, or processes reducing through
    ``kernels/mesh_reduce.py`` or ``kernels/nccl_transport.py``), the solve runs as
    ``levenberg_marquardt`` does: one replay an outer iteration of a graph
    captured once per layout (the mesh and every shard's block structure in
    its key), each update hook (a shard's correspondence search) inside it,
    no host read in the loop; over a process's several peer cards, one
    graph a card, each over its own shards. A gloo mesh or cards without peer access both ways run the LM
    step's eager body, one read a trial."""
    if not isinstance(problem, Problem):
        problem = Problem(blocks=(problem,))
    mesh.check_axis(axis)
    columns = []
    for blk in problem.blocks:
        if blk.data is None:
            columns.append(tuple(
                blk if mesh.first_shard + j == 0 else _silenced(blk) for j in range(mesh.n_local)
            ))
        else:
            columns.append(_shards_of(blk, mesh, axis))
    shards = tuple(Problem(blocks=tuple(row)) for row in zip(*columns))
    sharded = ShardedProblem(blocks=problem.blocks, shards=shards, mesh=mesh)
    return levenberg_marquardt(sharded, torch.as_tensor(x0), config, manifold)
