"""Multi-process initialization and global-array helpers.

PyTorch counterpart of ``moptimizer_0_tpu.parallel.multihost``, on
torch.distributed with the gloo backend, which makes the group, exchanges
the handles and carries the gathers (the default group stays gloo: NCCL
refuses two processes on one card). A mesh's all-reduces take the
transport ``choose_transport`` picks from where the processes run
(``parallel.mesh``): processes of one host whose cards are one or peers
reduce on the device (``kernels/mesh_reduce.py``, through CUDA IPC
buffers), other processes on CUDA that share no card over NCCL
(``kernels/nccl_transport.py``, still on the device), any other mesh over
gloo. Every process runs the same program:

    from moptimizer_0_tpu_torch.parallel import multihost
    multihost.initialize(coordinator_address="host:port", num_processes=N,
                         process_id=i)        # or no arguments under torchrun
    mesh = multihost.global_mesh()            # this process's shards + the group
    blk = multihost.make_global_block(local_block, mesh)   # local rows in
    res = distributed_levenberg_marquardt(problem(blk), x0, mesh, cfg)

Each process feeds only its own rows; the engine's sums over the mesh end in
one all-reduce over the group (``mesh.Mesh.psum``). ``mesh.close()``, on
every process, tears a device transport down before the group goes.

One process over several cards needs none of this: ``make_mesh(n)`` puts
its shards on every visible card and reduces them on the cards (one graph
a card, ``mesh.CardMesh``). Processes that each hold several cards (as
many each; ``global_mesh(device=[...])`` names them where a process sees
more) capture a graph a card too: card c sums its process's shards with
the process's other cards, then combines that sum with card c of every
other process (an IPC buffer or an NCCL communicator a card index).
"""

import dataclasses
import datetime
import itertools
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from moptimizer_0_tpu_torch.kernels import mesh_reduce, nccl_transport
from moptimizer_0_tpu_torch.parallel.mesh import GlobalArray, Mesh, make_mesh, tree_map

BACKEND = "gloo"
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def is_initialized():
    """True when torch.distributed has a process group."""
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address=None, num_processes=None, process_id=None, initialization_timeout=300):
    """Idempotent ``torch.distributed.init_process_group``, with the JAX
    package's keyword names (``initialization_timeout`` in seconds).

    * already initialized: a no-op;
    * explicit arguments: a group at ``tcp://coordinator_address`` of
      ``num_processes`` ranks, this one ``process_id``; failures propagate
      (an unreachable coordinator raises after the timeout);
    * no arguments: the torchrun environment (MASTER_ADDR, MASTER_PORT,
      WORLD_SIZE, RANK) when it is set, else a single-process run, unchanged.
    """
    if is_initialized():
        return
    timeout = datetime.timedelta(seconds=initialization_timeout)
    given = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in given):
        if any(v is None for v in given):
            raise ValueError("initialize: give coordinator_address, num_processes and process_id together")
        dist.init_process_group(
            BACKEND, init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
            rank=int(process_id), timeout=timeout,
        )
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group(BACKEND, init_method="env://", timeout=timeout)


def _rank_and_size():
    if is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def placement(devices):
    """Where this process reduces: (host name, ((card, peers), ...)) for
    each of its cards (a device or a sequence of them), a card by its UUID
    and its peers the UUIDs of the visible cards it has peer access to; a
    CPU device is ("cpu", frozenset())."""
    devices = [torch.device(d) for d in (devices if isinstance(devices, (list, tuple)) else (devices,))]
    host = socket.gethostname()

    def uuid(i):
        return str(torch.cuda.get_device_properties(i).uuid)

    def card(device):
        if device.type != "cuda":
            return device.type, frozenset()
        index = device.index if device.index is not None else torch.cuda.current_device()
        peers = frozenset(uuid(j) for j in range(torch.cuda.device_count())
                          if j != index and torch.cuda.can_device_access_peer(index, j))
        return uuid(index), peers

    return host, tuple(card(d) for d in devices)


def choose_transport(places):
    """A mesh's transport from every process's ``placement``: "local" for
    one process; "device" when every process is on one host, there are at
    most ``mesh_reduce.MAX_MEMBERS`` of them, and every two cards of two
    processes are one card or have peer access both ways; "nccl" when every
    card is a CUDA card and no two processes share one (NCCL refuses a
    shared card), a card known by its host and UUID; "gloo" otherwise."""
    if len(places) == 1:
        return "local"

    def joined(a, b):
        (card_a, peers_a), (card_b, peers_b) = a, b
        return card_a == card_b or (card_b in peers_a and card_a in peers_b)

    one_host = len({host for host, _ in places}) == 1
    if one_host and len(places) <= mesh_reduce.MAX_MEMBERS and all(
            joined(a, b) for (_, cards_i), (_, cards_j) in itertools.combinations(places, 2)
            for a in cards_i for b in cards_j):
        return "device"
    held = [{(host, card) for card, _ in cards} for host, cards in places]
    on_cuda = all(card != "cpu" for _, cards in places for card, _ in cards)
    return "nccl" if on_cuda and sum(map(len, held)) == len(set().union(*held)) else "gloo"


def global_mesh(axis="data", shards_per_process=None, device="cuda"):
    """A mesh over every process's shards: this process's
    ``make_mesh(shards_per_process, axis, device)`` (``device`` a list of
    devices names this process's cards), the default group (every process
    must have as many shards and as many cards) and the transport
    ``choose_transport`` picks from the processes' placements of their
    cards. A "device" or "nccl" mesh on CUDA gets its link, a transport a
    card index (process r's card c joined with card c of every other
    process), made here collectively and outside any capture; NCCL missing
    from a CUDA build raises here. Without a group, that local mesh, which
    captures a graph a card when it spans several peer cards."""
    local = make_mesh(shards_per_process, axis, device)
    rank, size = _rank_and_size()
    if size == 1:
        return local
    counts = [None] * size
    dist.all_gather_object(counts, (local.n_local, len(local.cards)))
    if len(set(counts)) != 1:
        raise ValueError(f"global_mesh: processes have different (shard, card) counts {counts}")
    places = [None] * size
    dist.all_gather_object(places, placement(local.cards))
    transport = choose_transport(places)
    group = dist.group.WORLD
    link = None
    if transport == "device" and local.devices[0].type == "cuda":
        link = mesh_reduce.IpcLinks(group, rank, size, local.cards)
    elif transport == "nccl":
        link = nccl_transport.NcclTransport(group, rank, size, local.cards)
    return dataclasses.replace(local, group=group, n_processes=size, process_index=rank, transport=transport,
                               link=link)


def host_local_shard(array, axis=0):
    """This process's contiguous part of an array every process holds
    (split by rank; the last rank takes the remainder)."""
    i, n = _rank_and_size()
    size = array.shape[axis]
    chunk = size // n
    start = i * chunk
    stop = size if i == n - 1 else start + chunk
    index = [slice(None)] * array.ndim
    index[axis] = slice(start, stop)
    return array[tuple(index)]


def make_global_array(local_rows, mesh, axis="data"):
    """This process's rows of a global array sharded along ``axis``
    (``mesh.GlobalArray``): its ``shape`` counts the rows of every
    process. The local rows must divide the process's shards."""
    mesh.check_axis(axis)
    t = local_rows if isinstance(local_rows, torch.Tensor) else torch.as_tensor(np.asarray(local_rows))
    if t.shape[0] % mesh.n_local:
        raise ValueError(f"{t.shape[0]} local rows do not divide {mesh.n_local} local shards")
    rows = t.shape[0]
    if mesh.group is not None:
        counts = [None] * mesh.n_processes
        dist.all_gather_object(counts, rows, group=mesh.group)
        rows = sum(counts)
    return GlobalArray(local=t, mesh=mesh, axis=axis, shape=(rows, *t.shape[1:]))


def make_global_block(block, mesh, axis="data"):
    """The block whose data every process supplies as its own rows: its
    leaves become ``GlobalArray``s, which ``parallel.sharded`` splits over
    this process's shards."""
    if block.data is None:
        return block
    return dataclasses.replace(block, data=tree_map(lambda leaf: make_global_array(leaf, mesh, axis), block.data))
