"""Device meshes and residual sharding.

PyTorch counterpart of ``moptimizer_0_tpu.parallel.mesh``. JAX runs one
program per device of a ``Mesh`` under ``shard_map`` and sums with
``psum``; PyTorch has no single-controller SPMD, so here a mesh is the list
of this process's shards, each on a device, and a process runs its shards
one after another:

* ``Mesh.psum`` sums per-shard values over the local shards in shard order,
  then, when the mesh spans processes, with one all-reduce over them. The
  order is fixed, so two sharded solves are bit-equal, and an all-reduce
  hands every process the same bytes, so the control scalars of an LM loop
  are equal on every process and the loops stay in lockstep. ``Mesh.pmax``
  is the same with a max.
* Shard ``j`` of process ``r`` is the mesh's shard ``r·n_local + j``: a
  block's rows split into ``mesh.size`` equal parts in that order.
* ``make_mesh(n)`` puts the shards round-robin on the visible cards: with k
  cards, card c holds shards c, c + k, ... (``Mesh.card_groups``).

A mesh's transport (``Mesh.transport``), chosen once by
``multihost.global_mesh`` (``multihost.choose_transport``):

* ``"local"``: one process, no group; a reduction is ``torch.add`` (or
  ``torch.maximum``) in shard order.
* ``"device"``: every process on this host, each pair of their cards one
  card or with peer access both ways. The all-reduce of CUDA tensors is the
  hand-written kernel of ``kernels/mesh_reduce.py`` (every process's
  partial summed in rank order through CUDA IPC buffers, with no host
  read; ``Mesh.link``, an ``IpcLinks`` of a buffer a card index); of CPU
  tensors its plain version, ``_all_reduce_plain`` (an all-gather over the
  gloo group, then the same rank-order sum).
* ``"nccl"``: processes on CUDA that the device transport cannot join
  (other hosts, cards without peer access both ways, cards a process cannot
  see) and no two of which share a card. The all-reduce of CUDA tensors is
  ``kernels/nccl_transport.py`` (an all-gather on the device, a
  communicator a card index, then the same rank-order combine, so the same
  bits as the device transport); of CPU tensors ``_all_reduce_plain``.
* ``"gloo"``: any other mesh (CPU processes of several hosts, a CPU process
  beside a card, processes sharing a card across hosts or more than
  ``mesh_reduce.MAX_MEMBERS`` of them): gloo's all-reduce on the host.

Which meshes the engines capture into CUDA graphs (``Mesh.captures_on``,
decided once a solve, before any capture; a failed capture raises and
never falls back):

* every local shard on the solve's card, with a ``"local"``, ``"device"``
  or ``"nccl"`` transport: a reduction is device work, and the step is one
  graph, as an unsharded one's is (``ops.device_loop``); across processes
  every process captures its own graph and replays it;
* a process over several cards, the solve on its first shard's card, every
  pair of its cards with peer access both ways
  (``torch.cuda.can_device_access_peer``), alone (``"local"``) or across
  processes that each hold as many cards (``"device"`` or ``"nccl"``): one
  graph a card (``device_loop.CardLoops``). Card c's graph runs the step
  over its own shards only, with the replicated state (x, λ, flags) in its
  own carry, and its reductions go through ``CardMesh``, the card's view of
  the mesh: to ``kernels.mesh_reduce.CardBuffers`` (a slot a shard, every
  card summing its process's slots in shard order), then, across
  processes, to card c's link of ``Mesh.link`` (the rank-order combine of
  the processes' sums with card c of every other process). That is the
  order ``Mesh.psum`` sums in, so each card's graph equals the mesh's eager
  body bit for bit and every card of every process holds the same bits.
  The host enqueues every card's replay before it waits on any. Cards
  without peer access both ways run the eager body, by that decision and
  nothing else.

The processes (or cards) stay in lockstep:

* every IF predicate of a step (a trial's, a PCG iteration's, ¬done) is
  computed from reduced values, which are the same bits everywhere, so
  every graph takes the same branches and runs the same reductions;
* a capture's warm-up runs every IF body everywhere, so the eager
  reductions that size the transport's buffers match too;
* a capture executes nothing, so it makes no reduction that a peer would
  wait for.

A peer that never arrives (a failed capture, a crash) makes the kernel's
bounded spin set an error word, and ``Mesh.check`` (called at the end of
every sharded solve) reads every process's or card's word and raises,
naming the epoch; the NCCL transport's watchdog aborts a reduction that
waits longer than its bound, and ``Mesh.check`` raises the same way. Gathers
after a loop (``gather_rows``, ``ba._global_pt_idx``) stay on the gloo
group; no step body runs one. A ``"gloo"`` mesh runs the eager loop.
"""

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from moptimizer_0_tpu_torch.kernels import mesh_reduce
from moptimizer_0_tpu_torch.ops import device_loop
from moptimizer_0_tpu_torch.utils.device import require

# Mesh.psum/pmax calls (reductions over a mesh's shards) run eagerly, and the
# all-reduces across processes that they make: counters for profiling, never
# reset here. A step's warm-up and capture record its reductions without
# counting them, and a replay runs them on the device, where nothing counts:
# a graph solve's reductions are reported as those of its eager body
# (``device_loop.eager()``), which makes the same ones and, in a CG solve,
# those of the PCG iterations it computes past the stop up to its next read.
REDUCTIONS = 0
ALL_REDUCES = 0

TRANSPORTS = ("local", "device", "nccl", "gloo")

# The card transports of one-process meshes over several cards, by the
# mesh's devices: made at a mesh's first graph and kept, since a cached
# graph points into their buffers (``Mesh.close`` frees them).
_CARD_TRANSPORTS = {}


def peers_both_ways(cards):
    """Whether every pair of these CUDA devices has peer access both ways
    (never without CUDA)."""
    return torch.cuda.is_available() and all(
        torch.cuda.can_device_access_peer(a.index, b.index) for a in cards for b in cards if a != b)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh: this process's shards and, across processes, a group.

    devices: the torch.device of each local shard, in shard order.
    axis_names: (name,) of the one mesh axis; ``shape[name]`` is the shard
        count over all processes.
    group: the torch.distributed process group the mesh spans, or None for
        a mesh inside one process.
    n_processes, process_index: the group's size and this process's rank.
    transport: "local", "device", "nccl" or "gloo" (module docstring); by
        default "local" without a group and "gloo" with one.
    link: the cross-process transport of a "device" or "nccl" mesh on CUDA
        (``kernels.mesh_reduce.IpcLinks`` or
        ``kernels.nccl_transport.NcclTransport``), a link for each of
        ``cards``.
    """

    devices: tuple
    axis_names: tuple = ("data",)
    group: Any = None
    n_processes: int = 1
    process_index: int = 0
    transport: str = None
    link: Any = None

    def __post_init__(self):
        if self.transport is None:
            object.__setattr__(self, "transport", "local" if self.group is None else "gloo")
        if self.transport not in TRANSPORTS or (self.transport == "local") != (self.group is None):
            raise ValueError(f"transport {self.transport!r} with group {self.group!r}")

    @property
    def n_local(self):
        """Shards of this process."""
        return len(self.devices)

    @property
    def size(self):
        """Shards over all processes."""
        return self.n_local * self.n_processes

    @property
    def shape(self):
        """{axis name: shard count}, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_names[0]: self.size}

    @property
    def shards(self):
        """This process's shards, as indices into its lists of shards (a
        card's view, ``CardMesh``, holds its card's)."""
        return tuple(range(self.n_local))

    @property
    def first_shard(self):
        """The mesh index of this process's first shard."""
        return self.process_index * self.n_local

    def card_groups(self):
        """((card, shard indices), ...): this process's shards grouped by
        device, the devices in the order of their first shard, each group's
        shards ascending. ``make_mesh(n)`` over k cards gives card c the
        shards c, c + k, ...."""
        groups = {}
        for j, d in enumerate(self.devices):
            groups.setdefault(torch.device(d), []).append(j)
        return tuple((d, tuple(js)) for d, js in groups.items())

    def card_of(self):
        """Each local shard's card, as an index into ``cards``."""
        index = {d: c for c, (d, _) in enumerate(self.card_groups())}
        return tuple(index[torch.device(d)] for d in self.devices)

    @property
    def cards(self):
        """The distinct devices of this process's shards, in shard order."""
        return tuple(d for d, _ in self.card_groups())

    def captures_on(self, device):
        """Whether a sharded step on ``device`` can be CUDA graphs (module
        docstring): every local shard there and its reductions device work
        (a "local", "device" or "nccl" transport; an NCCL transport whose
        all-gather cannot sit in IF bodies, ``kernels/nccl_transport.py``,
        runs the eager body), one graph; or a process over several cards,
        ``device`` its first shard's, every pair of its cards with peer
        access both ways, one graph a card (``per_card``). The engines
        capture a sharded step only then."""
        device = torch.device(device)
        if self.transport == "gloo" or self.link is not None and not self.link.in_if_bodies:
            return False
        cards = self.cards
        if len(cards) == 1:
            return cards[0] == device
        return (device.type == "cuda" and device == cards[0]
                and all(d.type == "cuda" for d in cards) and peers_both_ways(cards))

    def per_card(self, device):
        """Whether the engines capture a step on ``device`` as one graph a
        card (``captures_on`` with several cards)."""
        return len(self.cards) > 1 and self.captures_on(device)

    def card_transport(self):
        """The ``mesh_reduce.CardBuffers`` of this mesh's cards, made at the
        first call for these devices, then kept."""
        if self.devices not in _CARD_TRANSPORTS:
            _CARD_TRANSPORTS[self.devices] = mesh_reduce.CardBuffers(self.cards, self.card_of())
        return _CARD_TRANSPORTS[self.devices]

    def on_card(self, card, transport=None):
        """The ``CardMesh`` of the card ``self.cards[card]``: its shards and
        their reductions through ``transport``, the mesh's
        ``card_transport()``."""
        device, shards = self.card_groups()[card]
        return CardMesh(mesh=self, card=card, shards=shards, device=device, transport=transport)

    def layout(self):
        """The mesh by value, for a cache key: its devices, axis name,
        processes and transport, and the transport's buffers by identity (a
        graph points into them, and the key keeps them alive)."""
        return (self.devices, self.axis_names, self.n_processes, self.process_index, self.transport, self.link)

    def check(self):
        """Raise if an all-reduce of this mesh gave up on a peer (one read of
        the device, or of each card of a card transport, after a bounded wait
        for the NCCL transport's work); nothing for another transport."""
        if self.link is not None:
            self.link.check()
        cards = _CARD_TRANSPORTS.get(self.devices)
        if cards is not None:
            cards.check()

    def close(self):
        """Tear the transport down: drop every cached step graph (they may
        point into its buffers), then free the link's buffers or
        communicators (collectively across the mesh's processes) and the card
        transport's buffers on each card."""
        cards = _CARD_TRANSPORTS.pop(self.devices, None)
        if self.link is not None or cards is not None:
            device_loop.clear()
        if self.link is not None:
            self.link.close()
        if cards is not None:
            cards.close()

    def check_axis(self, axis):
        if axis not in self.axis_names:
            raise ValueError(f"mesh has axes {self.axis_names}, not {axis!r}")
        return self.size

    def psum(self, parts, device=None):
        """Σ over the mesh of per-shard values: ``parts[j]`` is local shard
        j's tensor, or tuple of tensors. Summed in shard order on ``device``
        (the first part's by default), then across processes."""
        return self._reduce(parts, device, "sum")

    def pmax(self, parts, device=None):
        """max over the mesh of per-shard values, as ``psum``."""
        return self._reduce(parts, device, "max")

    def _reduce(self, parts, device, op):
        global REDUCTIONS
        if not device_loop.tracing():
            REDUCTIONS += 1
        tuples = isinstance(parts[0], tuple)
        rows = [p if tuples else (p,) for p in parts]
        dev = rows[0][0].device if device is None else device
        acc = [t.to(dev) for t in rows[0]]
        for row in rows[1:]:
            acc = [COMBINE[op](a, t.to(dev)) for a, t in zip(acc, row)]
        if self.group is not None:
            acc = _all_reduce(acc, op, self)
        return tuple(acc) if tuples else acc[0]

    def gather_rows(self, t):
        """This process's rows of a row-sharded tensor → every process's rows,
        in process order (an all-gather over the gloo group; the tensor
        itself within one process). Every process must hold as many rows.
        Not inside a step body: raises in a warm-up or capture."""
        if self.group is None:
            return t
        if device_loop.tracing():
            raise RuntimeError("gather_rows inside a captured step: gathers run after the loop")
        as_bool = t.dtype == torch.bool
        src = (t.to(torch.uint8) if as_bool else t).contiguous()
        out = [torch.empty_like(src) for _ in range(self.n_processes)]
        dist.all_gather(out, src, group=self.group)
        out = torch.cat(out)
        return out.bool() if as_bool else out


COMBINE = mesh_reduce.COMBINE
_GLOO_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True, eq=False)
class CardMesh:
    """One card's view of a mesh whose process holds several cards, for the
    step body that card's graph runs (``Mesh.captures_on``).

    mesh: the whole mesh. card: the card's index in ``mesh.cards``.
    shards: this process's indices of the card's shards, ascending;
    ``devices`` (each the card) lines up with them as a mesh's devices do
    with its shards. transport: the mesh's ``card_transport()``.

    ``psum``/``pmax`` take this card's shards' parts and return the whole
    mesh's reduction in ``Mesh.psum``'s order, on the card, as every other
    card's graph does at the same point: one card-transport launch a dtype
    (the process's shards in shard order) and, across processes, the eager
    body's all-reduce (``_all_reduce``) over card c's link (the processes
    in rank order); the plain version of both is
    ``mesh_reduce.reduce_slots_plain``. In a graph's warm-up the card
    transport launches nothing (the other cards' warm-ups are not enqueued
    yet): it sizes the slots and stands in with the card's own parts'
    reduction, which the warm-up discards; the link launches, as every
    process warms its cards up in the same order.
    """

    mesh: Mesh
    card: int
    shards: tuple
    device: Any
    transport: Any = None

    @property
    def devices(self):
        return (self.device,) * len(self.shards)

    def psum(self, parts, device=None):
        return self._reduce(parts, device, "sum")

    def pmax(self, parts, device=None):
        return self._reduce(parts, device, "max")

    def _reduce(self, parts, device, op):
        if device is not None and torch.device(device) != self.device:
            raise ValueError(f"a card's reduction lands on its card {self.device}, not {device}")
        tuples = isinstance(parts[0], tuple)
        rows = [p if tuples else (p,) for p in parts]
        out = [None] * len(rows[0])
        by_dtype = {}
        for i, t in enumerate(rows[0]):
            by_dtype.setdefault(t.dtype, []).append(i)
        # one reduction a dtype: each shard's tensors of it in one flat, each
        # in the memory order of its layout and at a 256-byte boundary, so
        # that each output has the strides and alignment of the eager psum's
        # fresh torch.add result (a reduction's order, and cuBLAS's choice
        # of algorithm, follow both)
        for idx in by_dtype.values():
            dense = [[_dense(row[i]) for i in idx] for row in rows]
            likes = dense[0]
            if any(t.stride() != like.stride() for ts in dense for t, like in zip(ts, likes)):
                raise ValueError("a card's shards handed a reduction partials of different layouts")
            step = ALIGN_BYTES // likes[0].element_size()
            offsets, end = [], 0
            for t in likes:
                offsets.append(end)
                end = -(-(end + t.numel()) // step) * step
            flats = [_padded_flat(ts, offsets) for ts in dense]
            total = self._combine(flats, op)
            for i, like, off in zip(idx, likes, offsets):
                out[i] = torch.as_strided(total, like.shape, like.stride(), total.storage_offset() + off)
        if self.mesh.group is not None:
            # the process's sums across processes as the eager body sends
            # them (``_all_reduce``: packed, then split into views), over
            # this card's link: the later steps then see the eager body's
            # layouts, and so its bits
            out = _all_reduce(out, op, self.mesh)
        return tuple(out) if tuples else out[0]

    def _combine(self, flats, op):
        if device_loop.tracing() and not device_loop.capturing():
            self.transport.reserve(flats[0].numel() * flats[0].element_size())
            acc = flats[0]
            for f in flats[1:]:
                acc = COMBINE[op](acc, f)
            return acc
        return self.transport.reduce(flats, self.shards, self.card, op)


# A card reduction's outputs start at this alignment, as a fresh allocation's
# would (cuBLAS picks its algorithm by alignments up to 256 bytes).
ALIGN_BYTES = 256


def _dense(t):
    """t where it is non-overlapping and dense (its elements fill a block of
    memory in some order of its dimensions); else a copy in the layout
    ``empty_like`` gives it, which is that of an elementwise op's output."""
    dims = sorted((st, n) for st, n in zip(t.stride(), t.shape) if n != 1)
    expected = 1
    for st, n in dims:
        if st != expected:
            d = torch.empty_like(t)
            return d.copy_(t)
        expected *= n
    return t


def _padded_flat(tensors, offsets):
    """Dense tensors in their memory order, one flat, tensor k at
    ``offsets[k]`` (zeros between them)."""
    pieces, end = [], 0
    for t, off in zip(tensors, offsets):
        if off > end:
            pieces.append(t.new_zeros(off - end))
        pieces.append(torch.as_strided(t, (t.numel(),), (1,)))
        end = off + t.numel()
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def _all_reduce(tensors, op, mesh):
    """One all-reduce over the mesh's processes of a list of same-dtype
    tensors (each reshaped back), by the mesh's transport: on a "device" or
    "nccl" mesh the link of the tensors' card for CUDA tensors (it launches
    or raises) and ``_all_reduce_plain`` for CPU ones; on a "gloo" mesh
    gloo's."""
    global ALL_REDUCES
    if len({t.dtype for t in tensors}) != 1:
        return [_all_reduce([t], op, mesh)[0] for t in tensors]
    if not device_loop.tracing():
        ALL_REDUCES += 1
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if mesh.transport == "gloo":
        dist.all_reduce(flat, op=_GLOO_OPS[op], group=mesh.group)
    elif not flat.is_cuda:
        flat = _all_reduce_plain(flat, op, mesh.group)
    elif mesh.link is None or flat.device not in mesh.cards:
        raise RuntimeError(f"a {mesh.transport} mesh with no CUDA transport on {flat.device} got a tensor there")
    else:
        flat = mesh.link.all_reduce(flat, op, mesh.cards.index(flat.device))
    out, off = [], 0
    for t in tensors:
        out.append(flat[off : off + t.numel()].reshape(t.shape))
        off += t.numel()
    return out


def _all_reduce_plain(flat, op, group):
    """The device and NCCL transports' plain version: every process's ``flat``
    gathered over the gloo group, then combined in rank order
    (((x0 ∘ x1) ∘ x2) ...), the same bits on every process."""
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat.contiguous(), group=group)
    acc = parts[0]
    for p in parts[1:]:
        acc = COMBINE[op](acc, p)
    return acc


def make_mesh(n_devices=None, axis="data", device="cuda"):
    """1-D mesh of ``n_devices`` shards placed round-robin on the visible
    devices of ``device``'s type (one shard a device when None), or on the
    devices of a list or tuple ``device``. On the CPU, or on a machine with
    one card, n shards share that one device, as the JAX package's tests
    share one CPU between 8 forced host devices; on several peer cards the
    engines run it as a graph a card (``Mesh.captures_on``). Raises without
    a card unless ``device`` says otherwise."""
    if isinstance(device, (list, tuple)):
        visible = [require(d) for d in device]
    elif (dev := require(device)).index is not None:
        visible = [dev]
    elif dev.type == "cuda":
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        visible = [torch.device(dev.type)]
    n = len(visible) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_devices}")
    return Mesh(devices=tuple(visible[i % len(visible)] for i in range(n)), axis_names=(axis,))


@dataclasses.dataclass(frozen=True, eq=False)
class GlobalArray:
    """This process's rows of an array whose rows are spread over the
    processes of a mesh (``multihost.make_global_array``).

    local: the rows this process supplied. shape: the global shape, rows
    summed over the processes."""

    local: torch.Tensor
    mesh: Mesh
    axis: str
    shape: tuple


def tree_map(fn, tree):
    """fn over the leaves of a nest of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _rows(block):
    return tree_leaves(block.data)[0].shape[0]


def pad_block_to(block, multiple):
    """Pad a block's residual axis to a multiple of ``multiple``.

    Padded rows repeat row 0's data and are masked invalid: the data becomes
    ``{"_inner": data, "_valid": (target,) bool}`` and the residual and
    Jacobian functions are wrapped to unwrap it; the fused point-to-point
    linearizer sees through it. As in the JAX package, ``update_fn`` and
    ``weight_fn`` are not wrapped: a padded block with either fails.
    """
    if block.data is None:
        return block
    n = _rows(block)
    target = -(-n // multiple) * multiple
    if target == n:
        return block
    pad = target - n

    def pad_leaf(leaf):
        return torch.cat([leaf, leaf[:1].expand(pad, *leaf.shape[1:])])

    valid = torch.arange(target, device=tree_leaves(block.data)[0].device) < n
    data = dict(_inner=tree_map(pad_leaf, block.data), _valid=valid)
    inner_fn = block.residual_fn

    def wrapped(state, d):
        out = inner_fn(state, d["_inner"])
        if isinstance(out, tuple):
            r, v = out
            return r, v & d["_valid"]
        return out, d["_valid"]

    wrapped_jac = None
    if block.jacobian_fn is not None:
        inner_jac = block.jacobian_fn

        def wrapped_jac(state, d):
            return inner_jac(state, d["_inner"])

    return dataclasses.replace(block, data=data, residual_fn=wrapped, jacobian_fn=wrapped_jac)


def is_global(block):
    """True for a block whose data holds ``GlobalArray`` leaves."""
    return block.data is not None and isinstance(tree_leaves(block.data)[0], GlobalArray)


def shard_block_data(block, mesh, axis="data"):
    """The blocks of this process's shards, one a local shard, each with its
    rows of the data on its shard's device; everything else (loss, Σ) is
    shared. A block of ``GlobalArray`` leaves splits this process's rows
    over its local shards; any other block is the global data, split over
    all of the mesh's shards. The rows must divide the shard count
    (``pad_block_to``). A block with no data is returned once, unsplit."""
    n_shards = mesh.check_axis(axis)
    if block.data is None:
        return (block,)
    if is_global(block):
        data, parts, first = tree_map(lambda g: g.local, block.data), mesh.n_local, 0
    else:
        data, parts, first = block.data, n_shards, mesh.first_shard
    n = tree_leaves(data)[0].shape[0]
    if n % parts:
        raise ValueError(
            f"block {block.name!r}: {n} rows do not divide {parts} shards; pad_block_to first"
        )
    rows = n // parts

    def shard(j, dev):
        s = (first + j) * rows
        return dataclasses.replace(block, data=tree_map(lambda leaf: leaf[s : s + rows].to(dev), data))

    return tuple(shard(j, dev) for j, dev in enumerate(mesh.devices))
