"""Multi-process initialization and global-array helpers.

PyTorch counterpart of ``moptimizer_0_tpu.parallel.multihost``, on
torch.distributed with the gloo backend (NCCL refuses two processes on one
card), which makes the group, exchanges the handles and carries the
gathers. A mesh's all-reduces take the transport ``choose_transport``
picks from where the processes run (``parallel.mesh``): processes of one
host whose cards are one or peers reduce on the device
(``kernels/mesh_reduce.py``, through CUDA IPC buffers), any other mesh
over gloo. Every process runs the same program:

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
a card, ``mesh.CardMesh``). Processes that each hold several cards reduce
across processes from their first shard's card and run the eager loop: a
process's graph would have to span its cards and the other processes at
once, which no transport here does.
"""

import dataclasses
import datetime
import itertools
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from moptimizer_0_tpu_torch.kernels import mesh_reduce
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


def placement(device):
    """Where this process reduces: (host name, card, cards it has peer
    access to), a card by its UUID, or "cpu" for a CPU device."""
    device = torch.device(device)
    host = socket.gethostname()
    if device.type != "cuda":
        return host, device.type, frozenset()
    index = device.index if device.index is not None else torch.cuda.current_device()

    def uuid(i):
        return str(torch.cuda.get_device_properties(i).uuid)

    peers = frozenset(uuid(j) for j in range(torch.cuda.device_count())
                      if j != index and torch.cuda.can_device_access_peer(index, j))
    return host, uuid(index), peers


def choose_transport(places):
    """A mesh's transport from every process's ``placement``: "local" for
    one process; "device" when every process is on one host, there are at
    most ``mesh_reduce.MAX_MEMBERS`` of them, and every pair shares a card
    or has peer access both ways; "gloo" otherwise."""
    if len(places) == 1:
        return "local"
    if len({host for host, _, _ in places}) > 1 or len(places) > mesh_reduce.MAX_MEMBERS:
        return "gloo"
    for (_, a, peers_a), (_, b, peers_b) in itertools.combinations(places, 2):
        if a != b and not (b in peers_a and a in peers_b):
            return "gloo"
    return "device"


def global_mesh(axis="data", shards_per_process=None, device="cuda"):
    """A mesh over every process's shards: this process's
    ``make_mesh(shards_per_process, axis, device)``, the default group
    (every process must have as many shards) and the transport
    ``choose_transport`` picks from the processes' placements of their
    first shard, where a process's sums over its shards land and its
    all-reduce runs; a "device" mesh on CUDA gets its IPC buffers there
    (collectively). A process whose shards lie on several cards gets the
    same transport for that all-reduce and the eager loop
    (``Mesh.captures_on``). Without a group, that local mesh, which
    captures a graph a card when it spans several peer cards."""
    local = make_mesh(shards_per_process, axis, device)
    rank, size = _rank_and_size()
    if size == 1:
        return local
    counts = [None] * size
    dist.all_gather_object(counts, local.n_local)
    if len(set(counts)) != 1:
        raise ValueError(f"global_mesh: processes have different shard counts {counts}")
    places = [None] * size
    dist.all_gather_object(places, placement(local.devices[0]))
    transport = choose_transport(places)
    group = dist.group.WORLD
    ipc = None
    if transport == "device" and local.devices[0].type == "cuda":
        ipc = mesh_reduce.IpcBuffers(group, rank, size, local.devices[0])
    return dataclasses.replace(local, group=group, n_processes=size, process_index=rank, transport=transport, ipc=ipc)


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
