"""An outer LM iteration as one CUDA-graph replay, with IF nodes inside it.

The JAX package jits ``ba_step`` and ``lm_step`` (one dispatch an outer
iteration) and runs ``solve_ba`` and ``levenberg_marquardt`` as one
``lax.while_loop`` over that body, whose LM trials and PCG iterations are
``while_loop``s that test their flag on the device. The port's counterpart
on CUDA, for the BA engines and the LM solver (``core.solver``), is a graph
captured once per layout and replayed:

* ``cond(pred, fn, read)`` runs ``fn`` where the 0-dim bool ``pred`` holds.
  Under capture it is an IF node (``kernels/graph_cond.py``) whose body is
  fn's work, taken or skipped on the device at replay; eagerly it reads
  ``pred`` through the caller's counted ``read``. fn writes its results in
  place into tensors made before it, so a skipped body leaves them as they
  were.
* ``StepLoop`` keeps the carry of an outer LM loop (parameters, λ, and
  the problem's data leaves that update hooks rewrite), the iteration
  counter, ``done``, the status and the trace in fixed buffers, and
  advances them by one outer iteration under IF(¬done). With
  ``graph=True`` that iteration is captured once and every step is one
  replay: a solve enqueues max_iterations replays and reads nothing back.
* ``CardLoops`` stands for a StepLoop over a one-process mesh of several
  cards (``parallel.mesh``): a StepLoop a card, each captured on its card
  with the step over that card's shards, replayed in card order;
  ``card_loops`` makes one StepLoop or the other for the engines.
* ``cached(parts, make)`` keeps the StepLoops of the last few layouts.
* ``eager()`` is a context in which the engines run the step's body eagerly
  on the card, op by op: the reference the graph must equal bit for bit.

Tracing (``utils.tracing``): an outer iteration's body lies between the
markers ``step_begin`` and ``step_end``, inside its IF(¬done), so a
replay's device trace shows each step that ran; ``lookup`` is the span
``layout`` (on a miss with the warm-up and capture), and a solve's
enqueue of its replays, or its eager loop, the span ``replays``.

Capture: a warm-up first runs the step once outside capture with every IF
body taken and no read, on the streams the capture uses, so that kernel
builds, plans, library handles and their workspaces exist before it; the
caller sets the carry again before the first replay. The capture stream
allocates from the graph's private pool and the IF bodies, each captured on
a stream of its nesting depth, from a second pool that lives as long as the
graph. Nothing catches a failed capture: it raises. A fault inside a
replayed kernel shows at the next synchronisation.
"""

import collections
import contextlib
import threading
import time

import torch

from moptimizer_0_tpu_torch.kernels import graph_cond
from moptimizer_0_tpu_torch.utils.tracing import mark, span

# IF bodies nest this deep at most: the step, an LM trial, a PCG iteration.
MAX_DEPTH = 3
# StepLoops that ``cached`` keeps, the least recently used dropped first.
MAX_LOOPS = 8

# One dict per capture since import: the loop's name, the warm-up's,
# capture's and instantiation's ms and the bytes of its two pools.
CAPTURES = []

_local = threading.local()
_STREAMS = {}
_LOOPS = collections.OrderedDict()


def _flag(name):
    return getattr(_local, name, False)


def _stack():
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def graphs(t):
    """Whether the engines capture their step for tensors like t: on CUDA,
    outside ``eager()``."""
    return t.is_cuda and not _flag("eager")


@contextlib.contextmanager
def eager():
    """Run the engines' step bodies eagerly on the card, as on the CPU."""
    prev = _flag("eager")
    _local.eager = True
    try:
        yield
    finally:
        _local.eager = prev


def tracing():
    """True while a step is warmed up or captured: every IF body is then
    recorded (or run) whatever its flag, and nothing reads the device."""
    return _flag("warm") or _flag("capturing")


def capturing():
    """True while a step is captured (not in its warm-up)."""
    return _flag("capturing")


def _stream(device, role):
    key = (torch.device(device).index, role)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device=device)
    return _STREAMS[key]


@contextlib.contextmanager
def _body(pred):
    """fn's work on the stream of its nesting depth: captured as the body of
    an IF node on ``pred`` or, in a warm-up (pred None), run there."""
    parent = torch.cuda.current_stream()
    stack = _stack()
    if len(stack) >= MAX_DEPTH:
        raise RuntimeError(f"IF bodies nest deeper than {MAX_DEPTH}")
    child = _stream(parent.device, len(stack))
    if pred is None:
        child.wait_stream(parent)
    else:
        graph_cond.begin_if(parent, child, pred)
    stack.append(parent)
    torch.cuda.set_stream(child)
    try:
        yield
    finally:
        torch.cuda.set_stream(parent)
        stack.pop()
        if pred is None:
            parent.wait_stream(child)
        else:
            graph_cond.end_if(child)


def cond(pred, fn, read=None):
    """fn() where the 0-dim bool tensor ``pred`` is true; fn returns nothing
    and writes in place. Under capture an IF node, in a warm-up fn() whatever
    pred; both return True. Eagerly ``read(pred)`` decides, and cond returns
    what it read."""
    if _flag("capturing"):
        with _body(pred):
            fn()
        return True
    if _flag("warm"):
        with _body(None):
            fn()
        return True
    if not read(pred):
        return False
    fn()
    return True


class StepLoop:
    """An outer LM loop's state in fixed buffers and one iteration over it.

    body(*carry) → (carry′, terminal, status, record) is one outer
    iteration: carry′ like carry (an entry may be the carry's own buffer,
    left as it is), terminal a 0-dim bool, status a 0-dim int32, record a
    dict of tensors. ``record`` gives the record's names and dtypes, or
    (dtype, shape) for a record that is not 0-dim; ``lanes`` leading axes
    of every shape are lanes, and the trace puts its iteration axis after
    them: a record of shape (B, n) has a trace of (B, n_trace, n).
    ``n_trace`` is the trace's length (max_iterations), ``status0`` the
    status before any iteration. An iteration, under IF(¬done), runs the
    body, writes the carry, the record and its row of the trace (at the
    device counter ``it``), the status and done, and advances ``it`` unless
    the iteration was terminal (that one is not counted as executed). With
    ``graph=True`` (CUDA) it is captured at construction; otherwise it runs
    eagerly, reading ¬done before each. ``context``: what the engine keeps
    beside the loop (its mesh and shards, or its layout)."""

    def __init__(self, body, carry, n_trace, record, status0, graph=False, name="", context=None, lanes=0):
        self.body = body
        self.context = context
        self.carry = [torch.empty_like(t) for t in carry]
        dev = self.carry[0].device
        self.status0 = int(status0)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.it = torch.zeros((), dtype=torch.int32, device=dev)
        self.status = torch.full((), self.status0, dtype=torch.int32, device=dev)
        spec = {k: v if isinstance(v, tuple) else (v, ()) for k, v in record.items()}
        self.record = {k: torch.zeros(shape, dtype=dt, device=dev) for k, (dt, shape) in spec.items()}
        self.trace = {k: torch.zeros((*shape[:lanes], n_trace, *shape[lanes:]), dtype=dt, device=dev)
                      for k, (dt, shape) in spec.items()}
        self._lanes = lanes
        self._slots = torch.arange(n_trace, dtype=torch.int32, device=dev)
        self.graph = self.bodies = None
        self.replays = 0
        self.stats = {}
        self.start(carry)
        if graph:
            self._capture(name)

    def start(self, carry):
        """Set the carry (tensors or Python numbers); clear done, the
        counter, the status and the trace (NaN, and 0 for integers)."""
        for s, t in zip(self.carry, carry):
            if isinstance(t, torch.Tensor):
                s.copy_(t)
            else:
                s.fill_(float(t))
        self.done.fill_(False)
        self.it.zero_()
        self.status.fill_(self.status0)
        for v in self.trace.values():
            v.fill_(float("nan") if v.is_floating_point() else 0)

    def _advance(self):
        mark("step_begin", self.done)
        new, terminal, status, record = self.body(*self.carry)
        for s, t in zip(self.carry, new):
            if t is not s:
                s.copy_(t)
        at = self._slots == self.it
        n = self._lanes
        for k, v in record.items():
            self.record[k].copy_(v)
            row = at.reshape((1,) * n + at.shape + (1,) * (v.ndim - n))
            self.trace[k].copy_(torch.where(row, v.unsqueeze(n), self.trace[k]))
        self.status.copy_(status)
        self.it.copy_(torch.where(terminal, self.it, self.it + 1))
        self.done.copy_(terminal)
        mark("step_end", self.done)

    def _iterate(self, read=None):
        return cond(~self.done, self._advance, read)

    def step(self, read):
        """One outer iteration: one replay, or the body eagerly under
        cond(¬done). False when run eagerly on a finished loop."""
        if self.graph is None:
            return self._iterate(read)
        with torch.cuda.device(self.done.device):
            self.graph.replay()
        self.replays += 1
        return True

    def solve(self, n, read, host_loop=False):
        """At most n outer iterations from the carry ``start`` set. A graph
        replays n times, each IF(¬done), and reads nothing back; with
        ``host_loop`` it reads done after each replay and stops there. The
        eager loop reads ¬done before each iteration."""
        with span("replays"):
            for _ in range(n):
                if not self.step(read):
                    break
                if host_loop and self.graph is not None and read(self.done):
                    break

    def outputs(self):
        """Copies of the carry, of done (the step's terminal), the status and
        the record."""
        return ([t.clone() for t in self.carry], self.done.clone(), self.status.clone(),
                {k: v.clone() for k, v in self.record.items()})

    def _capture(self, name):
        self.warm_up()
        self.capture(name)

    def warm_up(self):
        """The capture's warm-up (module docstring), on the loop's card."""
        dev = self.done.device
        with torch.cuda.device(dev):
            graph_cond.load()
            for d in range(MAX_DEPTH):
                _stream(dev, d)
            stream = _stream(dev, "capture")
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                _local.warm = True
                try:
                    self._iterate()
                finally:
                    _local.warm = False
            torch.cuda.synchronize(dev)
        self.stats = dict(warm_ms=(time.perf_counter() - t0) * 1e3)

    def capture(self, name):
        """Capture one iteration into the loop's graph, after ``warm_up``."""
        dev = self.done.device
        with torch.cuda.device(dev):
            stream = _stream(dev, "capture")
            t1 = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            self.bodies = torch.cuda.MemPool()
            with torch.cuda.graph(self.graph, stream=stream):
                with torch.cuda.use_mem_pool(self.bodies, device=dev):
                    _local.capturing = True
                    try:
                        self._iterate()
                    finally:
                        _local.capturing = False
            t2 = time.perf_counter()
            self.graph.instantiate()
            torch.cuda.synchronize(dev)
            t3 = time.perf_counter()
        self.stats = dict(name=name, warm_ms=self.stats["warm_ms"], capture_ms=(t2 - t1) * 1e3,
                          instantiate_ms=(t3 - t2) * 1e3, pool_bytes=self.pool_bytes())
        CAPTURES.append(self.stats)

    def pool_bytes(self):
        """Bytes the card holds for the graph's two pools."""
        pools = {tuple(self.graph.pool()), tuple(self.bodies.id)}
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) in pools)

    def close(self):
        """Drop the graph, then its pools."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.bodies = None


class CardLoops:
    """The loops of one solve over a one-process mesh of several cards
    (``parallel.mesh.Mesh.captures_on``): a StepLoop a card, each with the
    step body over that card's shards, its own carry and its own graph, and
    in their place everything a StepLoop offers a solve (``start``,
    ``step``, ``solve``, ``outputs``, ``carry``, ``done``, ``it``,
    ``status``, ``record``, ``trace``, ``replays``, ``stats``).

    loops: each card's StepLoop, made with graph=False; the first card's is
    the first shard's, where the result lands. owners: for each entry of
    the solve's whole carry, None for a replicated entry (x, λ, cameras: on
    every card) or the card whose carry holds it (a shard's data or
    points), in the order each card's carry lists them. Every card's
    warm-up runs before any capture, so every graph points into the same
    transport buffers; each capture runs on its card's streams and pools.
    A step enqueues every card's replay before anything waits, and the
    replicated entries, done, the counter, the status, the record and the
    trace are read from the first card."""

    def __init__(self, loops, owners, name="", context=None):
        self.loops = list(loops)
        self.owners = tuple(owners)
        self.context = context
        self._index = [[i for i, o in enumerate(self.owners) if o is None or o == c] for c in range(len(self.loops))]
        for c, loop in enumerate(self.loops):
            if len(loop.carry) != len(self._index[c]):
                raise ValueError(f"card {c}'s carry has {len(loop.carry)} entries, its owners say {len(self._index[c])}")
        for loop in self.loops:
            loop.warm_up()
        for c, loop in enumerate(self.loops):
            loop.capture(f"{name} card={c}")
        first = self.loops[0]
        self.done, self.it, self.status = first.done, first.it, first.status
        self.record, self.trace = first.record, first.trace

    @property
    def graph(self):
        return self.loops[0].graph

    @property
    def replays(self):
        return self.loops[0].replays

    @property
    def stats(self):
        return self.loops[0].stats

    @property
    def carry(self):
        """The whole carry: a replicated entry from the first card, a
        card's own from that card."""
        out = []
        for i, o in enumerate(self.owners):
            c = 0 if o is None else o
            out.append(self.loops[c].carry[self._index[c].index(i)])
        return out

    def start(self, carry):
        """Each card's part of the whole carry into its loop (copied onto
        the card)."""
        for c, loop in enumerate(self.loops):
            loop.start([carry[i] for i in self._index[c]])

    def step(self, read):
        """One outer iteration: every card's replay, enqueued in card order
        with nothing read between them."""
        for loop in self.loops:
            loop.step(read)
        return True

    def solve(self, n, read, host_loop=False):
        """n steps; with ``host_loop`` reads the first card's done after
        each (after every card's replay is enqueued) and stops there."""
        with span("replays"):
            for _ in range(n):
                self.step(read)
                if host_loop and read(self.done):
                    break

    def outputs(self):
        return ([t.clone() for t in self.carry], self.done.clone(), self.status.clone(),
                {k: v.clone() for k, v in self.record.items()})

    def close(self):
        for loop in self.loops:
            loop.close()


def card_loops(mesh, graph, make_loop, carry, shard_of, name, context=None):
    """The loop of a step over ``mesh`` (None: unsharded) from ``carry``:
    ``make_loop(mesh, carry, graph)``; or, over one process's several peer
    cards with ``graph`` (``mesh.per_card`` on the carry's device), a
    CardLoops of ``make_loop(view, the card's carry, False)`` for each
    card's view (``mesh.on_card``: its shards, ``view.shards``, reducing
    through the mesh's card transport). shard_of: for each carry entry,
    None where every card holds it (x, λ, the cameras), else the shard it
    belongs to; a card's carry is its entries in the carry's order, on the
    card."""
    if mesh is None or not (graph and mesh.per_card(carry[0].device)):
        return make_loop(mesh, carry, graph)
    card_of = mesh.card_of()
    owners = tuple(None if j is None else card_of[j] for j in shard_of)
    transport = mesh.card_transport()
    loops = []
    for c, card in enumerate(mesh.cards):
        own = tuple(t.to(card) for t, o in zip(carry, owners) if o is None or o == c)
        loops.append(make_loop(mesh.on_card(c, transport), own, False))
    return CardLoops(loops, owners, name, context=context)


def key_part(p):
    """p as a part of a cache key: a tensor by its identity, version, shape,
    dtype and device, a hashable object as itself, any other by identity."""
    if isinstance(p, torch.Tensor):
        return ("tensor", id(p), p._version, tuple(p.shape), p.dtype, p.device)
    try:
        hash(p)
    except TypeError:
        return ("object", id(p))
    return p


def lookup(store, parts, make, size, drop=None):
    """store[parts] of an LRU dict, made by make() on a miss; at most
    ``size`` entries, drop(value) called on each one evicted. A tensor in
    parts stands for its identity, version (an in-place change is a new
    key), shape, dtype and device, an unhashable object for its identity;
    the entry keeps parts alive, so no identity is reused while it lives."""
    with span("layout"):
        key = tuple(key_part(p) for p in parts)
        entry = store.pop(key, None)
        if entry is None:
            entry = (make(), parts)
            while len(store) >= size:
                _, (old, _) = store.popitem(last=False)
                if drop is not None:
                    drop(old)
        store[key] = entry
        return entry[0]


def cached(parts, make):
    """The StepLoop (or CardLoops, one entry for all its cards) of a layout
    (``lookup`` over the last MAX_LOOPS)."""
    return lookup(_LOOPS, parts, make, MAX_LOOPS, drop=lambda loop: loop.close())


def clear():
    """Drop every cached StepLoop and its graph."""
    while _LOOPS:
        _LOOPS.popitem()[1][0].close()
