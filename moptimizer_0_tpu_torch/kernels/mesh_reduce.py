"""Binding of ``csrc/mesh_reduce.cu``: the device all-reduce of a mesh's
members, the processes of one host (through CUDA IPC buffers) or the cards
of one process (through buffers the cards read from each other). One kernel
serves both: every member copies its shards' partials into their slots,
waits at a device-side barrier for every other member, and combines all the
slots in shard order, as ``Mesh.psum`` does, so every member writes psum's
bits. It launches on the current stream and reads nothing back, so a CUDA
graph can capture it (inside IF nodes too); it takes CUDA tensors only and
raises on anything else.

``_Transport`` keeps the buffers of one transport: a generation of buffers,
one a member, grown (a new generation, larger slots) only outside a capture
and kept until ``close()``, since a cached graph may point into any of
them; ``check()`` reads the error word that a member's bounded spin sets
when a peer does not arrive within ``timeout_s``, and raises, naming the
epoch. Its two kinds differ only in how a generation's buffers are had:

* ``IpcBuffers``, one process's side of a ``"device"`` mesh
  (``parallel.multihost.global_mesh`` makes it on CUDA): its own buffer,
  and every peer's mapped from the handles exchanged over the gloo group,
  which every process reaches at the same reduction because they run in
  lockstep. ``all_reduce`` reduces one partial a process, in rank order;
  its plain version is ``parallel.mesh._all_reduce_plain``.
* ``CardBuffers``, the transport of a process's several cards
  (``parallel.mesh.CardMesh``): a buffer ``cudaMalloc``'d on every card,
  which the others read through peer access. ``reduce`` is one card's
  launch, in that card's own CUDA graph, with the partials of the card's
  shards. Its plain version, for CPU tensors, is ``reduce_slots_plain``. A
  graph's warm-up does not launch it (a launch would wait for cards whose
  warm-up has not been enqueued yet): it sizes the slots (``reserve``) and
  stands in with the card's own partials' sum, which the warm-up discards
  with the rest of its values.

Processes that each hold several cards (the grouped device transport)
reduce in two launches a card: ``CardBuffers`` sums the process's shards
on every card, then ``IpcLinks``, an ``IpcBuffers`` a card index, combines
card c's sum with card c of every other process in rank order. Each
process's shards in shard order, then the processes in rank order, is
``Mesh.psum``'s order (((s0 + s1) + (s2 + s3)) for 2 × 2 shards, not
the flat ((s0 + s1) + s2) + s3); ``reduce_slots_plain(groups, op,
n_processes)`` is the plain version of both launches. Every IPC handle is
opened once a process, on its own card of that index.
"""

import ctypes
import functools

import torch
import torch.distributed as dist

from moptimizer_0_tpu_torch.kernels import build
from moptimizer_0_tpu_torch.kernels.launches import ReplayCounter

NAME = "mesh_reduce"
SOURCES = ("mesh_reduce.cu",)

# Members (processes or cards) and shards a transport spans at most
# (MR_MAX_MEMBERS, MR_MAX_SHARDS in the source).
MAX_MEMBERS = 8
MAX_SHARDS = 32
# The dtypes the engines' mesh reductions carry.
DTYPES = {torch.float32: 0, torch.float64: 1}
OPS = ("sum", "max")
# A peer that has not arrived after this long is an error, not a wait.
TIMEOUT_S = 60.0
# Slot bytes of a new transport; a larger reduction grows it (eagerly).
INITIAL_SLOT_BYTES = 1 << 20

# Kernel launches since import, or since ``reset_launches()``: LAUNCHES
# counts the launches made eagerly, ``replayed()`` those that CUDA-graph
# replays made (``kernels.launches``), ``launches()`` both.
LAUNCHES = 0
_REPLAYED = ReplayCounter("mesh_reduce")


def replayed():
    return _REPLAYED.total()


def launches():
    return LAUNCHES + replayed()


def replayed_by_card():
    """{card: launches that graph replays made there} (one read a card)."""
    return _REPLAYED.by_device()


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0
    _REPLAYED.reset()


def _count(device):
    global LAUNCHES
    if not _REPLAYED.captured(device):
        LAUNCHES += 1


@functools.lru_cache(maxsize=None)
def _library():
    path, _ = build.build(NAME, SOURCES)
    lib = ctypes.CDLL(str(path))
    p, i, u64, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_longlong
    sig = {
        "mr_header_bytes": [], "mr_handle_bytes": [], "mr_max_members": [], "mr_max_shards": [],
        "mr_alloc": [i, u64, ctypes.POINTER(p)],
        "mr_handle": [p, p],
        "mr_open": [i, p, ctypes.POINTER(p)],
        "mr_close": [p], "mr_free": [p],
        "mr_prepare": [i, i],
        "mr_reduce": [ctypes.POINTER(u64), i, p, ll, i, i, ctypes.POINTER(u64), i, ctypes.POINTER(i),
                      ctypes.POINTER(i), i, i, i, u64, u64, p],
        "mr_error": [p, ctypes.POINTER(u64), p],
        "mr_pingpong": [p, p, i, ll, ll, u64, p],
    }
    for name, args in sig.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i
    limits = (lib.mr_max_members(), lib.mr_max_shards())
    if limits != (MAX_MEMBERS, MAX_SHARDS):
        raise RuntimeError(f"mesh_reduce.cu takes {limits} members, shards; the binding {(MAX_MEMBERS, MAX_SHARDS)}")
    return lib


def _ok(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


class _Generation:
    """One buffer of every member: ``bases``, each member's as mapped here;
    ``owned``, the (device, pointer) of those this process allocated; and
    their slot bytes."""

    def __init__(self, bases, owned, cap):
        self.bases, self.owned, self.cap = bases, owned, cap
        self.array = (ctypes.c_ulonglong * len(bases))(*bases)


def _check_flat(flat, device):
    if not flat.is_cuda or flat.device != device:
        raise ValueError(f"mesh_reduce: the tensor is on {flat.device}, the transport on {device}")
    if flat.dtype not in DTYPES:
        raise TypeError(f"mesh_reduce: {flat.dtype} is not one of {list(DTYPES)}")
    if flat.ndim != 1 or not flat.is_contiguous():
        raise ValueError("mesh_reduce: the tensor must be 1-D and contiguous")


class _Transport:
    """The buffers of a transport whose shard j lies on member
    ``member_of[j]``, and its launch; a subclass says how a generation's
    buffers are had (``_alloc``) and given back (``close``)."""

    def __init__(self, member_of, timeout_s):
        self.member_of = tuple(int(m) for m in member_of)
        self.pos_of = tuple(self.member_of[:j].count(m) for j, m in enumerate(self.member_of))
        self.per = max(self.member_of.count(m) for m in self.member_of)
        self.timeout_s = float(timeout_s)
        self.generations = []
        self._placement = ((ctypes.c_int * len(self.member_of))(*self.member_of),
                           (ctypes.c_int * len(self.pos_of))(*self.pos_of))

    @property
    def slot_bytes(self):
        return self.generations[-1].cap

    def _buffer_bytes(self, cap):
        return _library().mr_header_bytes() + 2 * self.per * cap

    def _grow(self, cap):
        """New buffers with slots of at least ``cap`` bytes on every member."""
        self.generations.append(self._alloc(-(-int(cap) // 4096) * 4096))

    def reserve(self, n_bytes):
        """Slots of at least ``n_bytes`` on every member; grows them outside
        a capture and raises inside one (graphs already captured keep the
        buffers they point into)."""
        if n_bytes <= self.slot_bytes:
            return
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"mesh_reduce: a {n_bytes}-byte reduction under capture exceeds the "
                               f"{self.slot_bytes}-byte slots; the eager warm-up sizes them")
        self._grow(max(n_bytes, 2 * self.slot_bytes))

    def _launch(self, flats, me, device, op):
        """Member ``me``'s launch: ``flats``, the partials of its shards in
        shard order, 1-D, contiguous, of one dtype and size, on ``device``;
        returns every shard's, combined in shard order, as a new tensor."""
        for f in flats:
            _check_flat(f, device)
        if len({(f.dtype, f.numel()) for f in flats}) != 1 or len(flats) != self.member_of.count(me):
            raise ValueError("mesh_reduce: a member's partials must be one a shard it holds, of one dtype and size")
        if op not in OPS:
            raise ValueError(f"mesh_reduce: op must be one of {OPS}, got {op!r}")
        first = flats[0]
        self.reserve(first.numel() * first.element_size())
        gen = self.generations[-1]
        out = torch.empty_like(first)
        ins = (ctypes.c_ulonglong * len(flats))(*(f.data_ptr() for f in flats))
        with torch.cuda.device(device):
            err = _library().mr_reduce(
                ins, len(flats), out.data_ptr(), first.numel(), DTYPES[first.dtype], OPS.index(op), gen.array,
                len(gen.bases), *self._placement, len(self.member_of), me, self.per, gen.cap,
                int(self.timeout_s * 1e9), torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"mr_reduce launch failed with code {err}")
        _count(device)
        return out

    def _who(self, device):
        return str(device)

    def check(self):
        """Raise if a reduction of any buffer this process owns timed out
        waiting for a peer (one read of the device a buffer, after the
        current stream's work)."""
        lib = _library()
        for g in self.generations:
            for dev, base in g.owned:
                word = ctypes.c_ulonglong()
                with torch.cuda.device(dev):
                    _ok(lib.mr_error(base, ctypes.byref(word), torch.cuda.current_stream().cuda_stream), "mr_error")
                if word.value:
                    raise RuntimeError(
                        f"mesh all-reduce: {self._who(dev)} waited more than {self.timeout_s:g} s for a peer at "
                        f"epoch {word.value} (a peer skipped a reduction, failed or stopped)"
                    )

    def _free_owned(self):
        lib = _library()
        for g in self.generations:
            for dev, base in g.owned:
                with torch.cuda.device(dev):
                    _ok(lib.mr_free(base), "mr_free")
        self.generations = []


class IpcBuffers(_Transport):
    """One process's side of a device transport over ``group`` (``size``
    processes, this one ``rank``, one shard each), its buffer on
    ``device``. Collective: every process of the group makes it at the same
    point."""

    def __init__(self, group, rank, size, device, timeout_s=TIMEOUT_S):
        if not 1 < size <= MAX_MEMBERS:
            raise ValueError(f"a device transport spans 2..{MAX_MEMBERS} processes, not {size}")
        super().__init__(range(size), timeout_s)
        self.group, self.rank, self.size = group, rank, size
        self.device = torch.device(device)
        self._pings = 0
        with torch.cuda.device(self.device):
            _ok(_library().mr_prepare(self.device.index, -1), "mr_prepare")
        _REPLAYED.prepare(self.device)
        self._grow(INITIAL_SLOT_BYTES)

    def _alloc(self, cap):
        """This process's buffer, and every peer's mapped from the handles
        exchanged over the group."""
        lib = _library()
        own, handle = ctypes.c_void_p(), ctypes.create_string_buffer(lib.mr_handle_bytes())
        with torch.cuda.device(self.device):
            _ok(lib.mr_alloc(self.device.index, self._buffer_bytes(cap), ctypes.byref(own)), "mr_alloc")
            _ok(lib.mr_handle(own, handle), "mr_handle")
        handles = [None] * self.size
        dist.all_gather_object(handles, handle.raw, group=self.group)
        bases = []
        for r, h in enumerate(handles):
            if r == self.rank:
                bases.append(own.value)
                continue
            ptr = ctypes.c_void_p()
            with torch.cuda.device(self.device):
                _ok(lib.mr_open(self.device.index, h, ctypes.byref(ptr)), f"mr_open of rank {r}'s buffer")
            bases.append(ptr.value)
        return _Generation(bases, ((self.device, own.value),), cap)

    def all_reduce(self, flat, op):
        """Σ (op "sum") or max (op "max") of ``flat`` over the processes, in
        rank order, as a new tensor; one kernel launch on the current stream.
        ``flat``: a contiguous 1-D CUDA tensor on the transport's device, of
        a dtype in DTYPES."""
        return self._launch([flat], self.rank, self.device, op)

    def _who(self, device):
        return f"rank {self.rank}"

    def pingpong(self, iters, peer=None):
        """``iters`` flag round trips between rank 0 and ``peer`` (rank 1) in
        one launch on the current stream: the barrier's latency, for
        ``chip_profile.py --path mesh_barrier``. Both ranks call it."""
        peer = 1 - self.rank if peer is None else peer
        gen = self.generations[-1]
        with torch.cuda.device(self.device):
            _ok(_library().mr_pingpong(gen.bases[self.rank], gen.bases[peer], self.rank, self._pings, iters,
                                       int(self.timeout_s * 1e9), torch.cuda.current_stream().cuda_stream),
                "mr_pingpong")
        self._pings += iters

    def close(self):
        """Unmap every peer's buffers and free this process's. Collective:
        every process's work is finished before any buffer goes."""
        if not self.generations:
            return
        lib = _library()
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)
        with torch.cuda.device(self.device):
            for g in self.generations:
                for r, base in enumerate(g.bases):
                    if r != self.rank:
                        _ok(lib.mr_close(base), "mr_close")
        dist.barrier(group=self.group)
        self._free_owned()


class IpcLinks:
    """The device transport of a process over its cards: an ``IpcBuffers``
    a card index, card c's buffer shared with card c of every other process
    (all of one host, each pair of them one card or peers both ways), made
    collectively in card order. ``all_reduce(flat, op, card)`` reduces one
    partial a process on that card, in rank order, as the NCCL transport's
    does (``kernels/nccl_transport.py``); a process over several cards
    first sums its own shards on every card (``CardBuffers``), so the two
    launches give ``Mesh.psum``'s order: each process's shards in shard
    order, then the processes in rank order."""

    in_if_bodies = True  # its kernel records inside IF nodes

    def __init__(self, group, rank, size, cards, timeout_s=TIMEOUT_S):
        self.cards = tuple(torch.device(c) for c in cards)
        self.buffers = tuple(IpcBuffers(group, rank, size, c, timeout_s) for c in self.cards)

    def all_reduce(self, flat, op, card=0):
        return self.buffers[card].all_reduce(flat, op)

    def check(self):
        for b in self.buffers:
            b.check()

    def close(self):
        for b in self.buffers:
            b.close()


# The combine of a reduction, as Mesh.psum/pmax apply it.
COMBINE = {"sum": torch.add, "max": torch.maximum}


def reduce_slots_plain(groups, op, n_processes=1):
    """The card transport's plain version, followed by the processes'
    rank-order combine where there are several: ``groups`` holds each card's
    (shard indices, partials) of every process, shard j of process r being
    ``r·n + j`` for n shards a process; every partial goes into its shard's
    slot, each process's slots are combined in shard order and the
    processes' results in rank order (((p0 ∘ p1) ∘ p2) ...), the order of
    ``Mesh.psum`` (with one process, (((s0 ∘ s1) ∘ s2) ...)). Returns each
    card's result (the same tensor, on the first card's device, for every
    card)."""
    slots = {}
    for shards, parts in groups:
        for j, part in zip(shards, parts):
            if j in slots:
                raise ValueError(f"shard {j} is in two cards' groups")
            slots[j] = part
    if sorted(slots) != list(range(len(slots))) or len(slots) % n_processes:
        raise ValueError(f"the groups hold shards {sorted(slots)}, not 0..{len(slots) - 1} over {n_processes} "
                         f"processes")
    per = len(slots) // n_processes
    total = None
    for r in range(n_processes):
        acc = slots[r * per]
        for j in range(r * per + 1, (r + 1) * per):
            acc = COMBINE[op](acc, slots[j].to(acc.device))
        total = acc if total is None else COMBINE[op](total, acc.to(total.device))
    return [total] * len(groups)


class CardBuffers(_Transport):
    """The transport of a one-process mesh over several cards: ``cards``
    (torch.devices, pairwise peers both ways) and ``card_of``, each shard's
    index into ``cards``. Every card enables peer access to every other and
    loads the kernel once here, so that no capture does either."""

    def __init__(self, cards, card_of, timeout_s=TIMEOUT_S):
        cards = tuple(torch.device(c) for c in cards)
        card_of = tuple(int(c) for c in card_of)
        if not 1 < len(cards) <= MAX_MEMBERS or len(card_of) > MAX_SHARDS:
            raise ValueError(f"a card transport spans 2..{MAX_MEMBERS} cards and at most {MAX_SHARDS} shards, not "
                             f"{len(cards)} and {len(card_of)}")
        if sorted(set(card_of)) != list(range(len(cards))):
            raise ValueError(f"shards on cards {card_of}: every one of {len(cards)} cards needs a shard")
        super().__init__(card_of, timeout_s)
        self.cards, self.card_of = cards, card_of
        lib = _library()
        for dev in self.cards:
            for peer in [d for d in self.cards if d != dev]:
                with torch.cuda.device(dev):
                    _ok(lib.mr_prepare(dev.index, peer.index), f"mr_prepare of {dev} with {peer}")
            _REPLAYED.prepare(dev)
        self._grow(INITIAL_SLOT_BYTES)

    def _alloc(self, cap):
        """A buffer on every card."""
        lib = _library()
        bases = []
        for dev in self.cards:
            ptr = ctypes.c_void_p()
            with torch.cuda.device(dev):
                _ok(lib.mr_alloc(dev.index, self._buffer_bytes(cap), ctypes.byref(ptr)), f"mr_alloc on {dev}")
            bases.append(ptr.value)
        return _Generation(bases, tuple(zip(self.cards, bases)), cap)

    def reduce(self, flats, shards, card, op):
        """Card ``card``'s launch of one reduction over the mesh: ``flats``
        are the partials of its shards ``shards`` (mesh indices, every shard
        of the card, ascending); returns Σ (or max) over every shard in
        shard order, a new tensor on the card. One kernel launch on the
        card's current stream, nothing read back: every other card must
        launch its own for the same reduction."""
        if tuple(shards) != tuple(j for j, c in enumerate(self.card_of) if c == card):
            raise ValueError(f"mesh_reduce: shards {shards} are not card {card}'s")
        return self._launch(flats, card, self.cards[card], op)

    def close(self):
        """Free every card's buffers, after every card's work."""
        for dev in self.cards:
            torch.cuda.synchronize(dev)
        self._free_owned()
