"""A mesh of one process over several cards: the pieces that need no card.

The engines capture such a mesh's step as one CUDA graph a card
(``device_loop.CardLoops``): card c's graph runs the step over its own
shards and reduces through ``kernels/mesh_reduce.py``'s card transport,
which puts every shard's partial in a slot of its own and sums the slots in
shard order on every card. Here, on the CPU:

* the transport's plain version, ``mesh_reduce.reduce_slots_plain``, is bit
  for bit ``Mesh.psum``'s (``pmax``'s) shard order for n ∈ {2, 4, 8} shards
  grouped over k ∈ {1, 2, 4} cards, float32 and float64, over partials
  spread across 16 decades, where the order shows in the bits: a card-major
  order (card 0's shards first) gives other bits;
* ``Mesh.card_groups``/``card_of``/``cards``/``on_card`` group a mesh's
  shards by card as ``make_mesh`` places them (round-robin: card c holds c,
  c + k, ...);
* ``Mesh.captures_on`` (and ``per_card``) decide once, from
  ``torch.cuda.can_device_access_peer`` (stubbed here): one card, several
  cards with peer access both ways (a graph a card, on the first shard's
  card only), one pair without it, a process group, a gloo mesh;
* ``device_loop.CardLoops`` splits a solve's carry over the cards' loops and
  joins it back (replicated entries from the first card, a shard's from its
  card), with the cards' warm-up and capture left out, and
  ``device_loop.card_loops`` hands each card's view its part;
* a registration block's update hook, called for a shard on another device
  (the "meta" device stands in for a second card), searches its own copy
  of the target there; with the target on the first card only, a shard on
  another card would hand K5 a query and a target on two cards, which
  ``nn_cuda`` refuses.

The transport kernel itself runs on the card only (``chip_smoke.py`` phase
23, with two or more cards).
"""

import numpy as np
import pytest
import torch

from moptimizer_0_tpu_torch.kernels import mesh_reduce
from moptimizer_0_tpu_torch.ops import device_loop
from moptimizer_0_tpu_torch.parallel import make_mesh
from moptimizer_0_tpu_torch.parallel import mesh as mesh_module
from moptimizer_0_tpu_torch.parallel.mesh import Mesh

CUDA = [torch.device("cuda", i) for i in range(4)]
LAYOUTS = [(n, k) for n in (2, 4, 8) for k in (1, 2, 4) if k <= n]


def _round_robin(n, k):
    return Mesh(devices=tuple(CUDA[j % k] for j in range(n)))


def _parts(n, dtype, seed):
    """n partials of 33 entries, magnitudes over 16 decades and both signs,
    so that another summation order gives other bits."""
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=33) * 10.0 ** rng.uniform(-8, 8, size=33), dtype=dtype)
            for _ in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("n,k", LAYOUTS, ids=[f"{n}shards-{k}cards" for n, k in LAYOUTS])
def test_slot_order_equals_psum(n, k, op, dtype):
    parts = _parts(n, dtype, seed=100 * n + k)
    mesh = _round_robin(n, k)
    groups = [(shards, [parts[j] for j in shards]) for _, shards in mesh.card_groups()]
    outs = mesh_reduce.reduce_slots_plain(groups, op)
    local = make_mesh(n, device="cpu")
    want = local.psum(parts) if op == "sum" else local.pmax(parts)
    assert len(outs) == k
    for out in outs:
        assert torch.equal(out.view(torch.uint8), want.view(torch.uint8))


def test_the_order_shows_in_the_bits():
    """Card-major order (each card's shards, card after card) is not shard
    order: over 4 shards on 2 cards the sums' bits differ, so the slot-order
    test above can tell them apart."""
    for dtype in (torch.float32, torch.float64):
        parts = _parts(4, dtype, seed=7)
        card_major = ((parts[0] + parts[2]) + parts[1]) + parts[3]
        assert not torch.equal(card_major, make_mesh(4, device="cpu").psum(parts))


GROUPED = [(2, 2, 1), (2, 2, 2), (2, 4, 2), (4, 2, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("p,n,k", GROUPED, ids=[f"{p}procs-{n}shards-{k}cards" for p, n, k in GROUPED])
def test_grouped_slot_order_equals_psum(p, n, k, op, dtype):
    """Processes × cards: ``reduce_slots_plain`` over p processes of n
    shards each, round-robin on k cards a process, is bit for bit
    ``Mesh.psum``'s order: each process's shards in shard order (its local
    psum), then the processes' sums in rank order (``_all_reduce_plain``)."""
    parts = _parts(p * n, dtype, seed=1000 * p + 10 * n + k)
    local = _round_robin(n, k)
    groups = [(tuple(r * n + j for j in js), [parts[r * n + j] for j in js])
              for r in range(p) for _, js in local.card_groups()]
    outs = mesh_reduce.reduce_slots_plain(groups, op, n_processes=p)
    cpu = make_mesh(n, device="cpu")
    sums = [(cpu.psum if op == "sum" else cpu.pmax)(parts[r * n:(r + 1) * n]) for r in range(p)]
    want = sums[0]
    for s_r in sums[1:]:
        want = mesh_module.COMBINE[op](want, s_r)
    assert len(outs) == p * k
    for out in outs:
        assert torch.equal(out.view(torch.uint8), want.view(torch.uint8))


def test_grouped_and_flat_orders_differ_in_the_bits():
    """Over 2 processes × 2 shards, (s0 + s1) + (s2 + s3), the grouped
    order, is not ((s0 + s1) + s2) + s3, the flat one: the grouped plain
    version is not the one-process card transport's order."""
    for dtype in (torch.float32, torch.float64):
        parts = _parts(4, dtype, seed=11)
        groups = [((j,), [parts[j]]) for j in range(4)]
        grouped = mesh_reduce.reduce_slots_plain(groups, "sum", n_processes=2)[0]
        flat = mesh_reduce.reduce_slots_plain(groups, "sum")[0]
        assert torch.equal(grouped, (parts[0] + parts[1]) + (parts[2] + parts[3]))
        assert not torch.equal(grouped, flat)


class _SlotsTransport:
    """A card transport's stand-in on the CPU: the card's own shards in
    shard order (the process's sum, where the card holds them all)."""

    def reduce(self, flats, shards, card, op):
        acc = flats[0]
        for f in flats[1:]:
            acc = mesh_module.COMBINE[op](acc, f)
        return acc


def test_card_mesh_across_processes_sends_what_the_eager_body_sends(monkeypatch):
    """A card's view of a mesh across processes sums its process's shards
    through the card transport, then hands the sums to the eager body's
    all-reduce (``mesh._all_reduce``, here its plain version: the same
    packing, one flat a dtype, and the same views back), so the step sees
    the eager body's layouts; without a group there is no second stage."""
    sent = []

    def plain(flat, op, group):
        sent.append((flat.dtype, flat.numel(), op))
        return flat + 1

    monkeypatch.setattr(mesh_module, "_all_reduce_plain", plain)
    cpu = torch.device("cpu")
    mesh = Mesh(devices=(cpu, cpu), group=object(), n_processes=2, transport="nccl")
    view = mesh_module.CardMesh(mesh=mesh, card=1, shards=(0, 1), device=cpu, transport=_SlotsTransport())
    parts = [(torch.full((2, 3), 1.0), torch.full((3, 2), 3.0).T, torch.full((4,), 2.0, dtype=torch.float64))
             for _ in range(2)]
    a, t, b = view.psum(parts)
    assert sent == [(torch.float32, 6, "sum"), (torch.float32, 6, "sum"), (torch.float64, 4, "sum")]
    eager = mesh.psum(parts)
    for got, want in zip((a, t, b), eager):
        assert torch.equal(got, want) and got.stride() == want.stride()
    alone = mesh_module.CardMesh(mesh=Mesh(devices=(cpu, cpu)), card=0, shards=(0, 1), device=cpu,
                                 transport=_SlotsTransport())
    assert torch.equal(alone.psum([torch.ones(3), torch.ones(3)]), torch.full((3,), 2.0))


def test_reduce_slots_plain_refuses_bad_groups():
    a = torch.ones(3)
    with pytest.raises(ValueError, match="two cards"):
        mesh_reduce.reduce_slots_plain([((0, 1), [a, a]), ((1,), [a])], "sum")
    with pytest.raises(ValueError, match="not 0"):
        mesh_reduce.reduce_slots_plain([((0,), [a]), ((2,), [a])], "sum")
    with pytest.raises(ValueError, match="over 2 processes"):
        mesh_reduce.reduce_slots_plain([((0, 1, 2), [a, a, a])], "sum", n_processes=2)


@pytest.mark.parametrize("n,k", LAYOUTS, ids=[f"{n}shards-{k}cards" for n, k in LAYOUTS])
def test_card_groups_of_make_mesh(monkeypatch, n, k):
    """make_mesh(n) on k cards places shard j on card j mod k; the groups
    list card c's shards c, c + k, ... in order, and a card's view holds
    those shards, all on its card."""
    monkeypatch.setattr(mesh_module, "require", torch.device)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: k)
    mesh = make_mesh(n)
    assert mesh.devices == tuple(CUDA[j % k] for j in range(n))
    groups = mesh.card_groups()
    assert groups == tuple((CUDA[c], tuple(range(c, n, k))) for c in range(k))
    assert mesh.cards == tuple(CUDA[:k])
    assert mesh.card_of() == tuple(j % k for j in range(n))
    for c in range(k):
        view = mesh.on_card(c)
        assert view.shards == tuple(range(c, n, k)) and view.device == CUDA[c]
        assert view.devices == (CUDA[c],) * len(view.shards)


def test_card_groups_keep_first_appearance_order():
    mesh = Mesh(devices=(CUDA[2], CUDA[0], CUDA[2], CUDA[1]))
    assert mesh.card_groups() == ((CUDA[2], (0, 2)), (CUDA[0], (1,)), (CUDA[1], (3,)))
    assert mesh.card_of() == (0, 1, 0, 2)


def _peers(monkeypatch, refuse=()):
    """CUDA present, every pair of cards with peer access but the ordered
    pairs in ``refuse``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: (a, b) not in refuse)


def test_captures_on_one_card():
    one = Mesh(devices=(CUDA[1],) * 3)
    assert one.captures_on(CUDA[1]) and not one.captures_on(CUDA[0])
    assert not one.per_card(CUDA[1])


def test_captures_on_peer_cards(monkeypatch):
    """With peer access both ways a one-process mesh over several cards
    captures a graph a card, for a solve on its first shard's card."""
    _peers(monkeypatch)
    for mesh in (_round_robin(2, 2), _round_robin(4, 2), _round_robin(8, 4)):
        assert mesh.captures_on(CUDA[0]) and mesh.per_card(CUDA[0])
        assert not mesh.captures_on(CUDA[1]) and not mesh.per_card(CUDA[1])


@pytest.mark.parametrize("refuse", [((0, 1),), ((1, 0),), ((2, 3), (3, 2))], ids=["0to1", "1to0", "2and3"])
def test_captures_on_without_peer_access(monkeypatch, refuse):
    """One pair of cards without peer access, either way: the eager loop."""
    _peers(monkeypatch, refuse)
    mesh = _round_robin(8, 4)
    assert not mesh.captures_on(CUDA[0]) and not mesh.per_card(CUDA[0])


def test_captures_on_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not _round_robin(4, 2).captures_on(CUDA[0])
    assert not mesh_module.peers_both_ways(CUDA[:2])


def test_captures_on_processes_over_several_cards(monkeypatch):
    """Processes that each hold several peer cards capture a graph a card
    on a "device" or "nccl" mesh, for a solve on the first shard's card; a
    "gloo" mesh runs the eager loop, as do cards of the process without
    peer access both ways and a mesh of the CPU and a card."""
    _peers(monkeypatch)
    group = object()
    for transport in ("device", "nccl"):
        mesh = Mesh(devices=(CUDA[0], CUDA[1]) * 2, group=group, n_processes=2, transport=transport)
        assert mesh.captures_on(CUDA[0]) and mesh.per_card(CUDA[0])
        assert not mesh.captures_on(CUDA[1]) and not mesh.per_card(CUDA[1])
    gloo = Mesh(devices=(CUDA[0], CUDA[1]), group=group, n_processes=2, transport="gloo")
    assert not gloo.captures_on(CUDA[0]) and not gloo.per_card(CUDA[0])
    mixed = Mesh(devices=(torch.device("cpu"), CUDA[0]))
    assert not mixed.captures_on(torch.device("cpu")) and not mixed.captures_on(CUDA[0])
    _peers(monkeypatch, refuse=((1, 0),))
    nccl = Mesh(devices=(CUDA[0], CUDA[1]), group=group, n_processes=2, transport="nccl")
    assert not nccl.captures_on(CUDA[0]) and not nccl.per_card(CUDA[0])


def test_card_transport_refusals():
    """The card transport spans 2..MAX_MEMBERS cards, at most MAX_SHARDS
    shards, and every card holds a shard; refused before any card is
    touched."""
    with pytest.raises(ValueError):
        mesh_reduce.CardBuffers(CUDA[:1], (0, 0))
    with pytest.raises(ValueError):
        mesh_reduce.CardBuffers(CUDA[:2], (0, 0))
    with pytest.raises(ValueError):
        mesh_reduce.CardBuffers(CUDA[:2], (0, 1) * (mesh_reduce.MAX_SHARDS // 2 + 1))


def test_card_mesh_lands_on_its_card():
    view = _round_robin(4, 2).on_card(1)
    with pytest.raises(ValueError, match="lands on its card"):
        view.psum([torch.ones(2), torch.ones(2)], device=CUDA[0])


def _count_body(x, own):
    """One iteration of a toy loop: the replicated x grows by 1 on every
    card, a card's own entry by its x; done at x = 3."""
    x = x + 1
    return (x, own + x), x >= 3, torch.zeros((), dtype=torch.int32), dict(x=x)


@pytest.mark.parametrize("host_loop", [False, True])
def test_card_loops_split_and_join_the_carry(monkeypatch, host_loop):
    """CardLoops hands each card its part of the whole carry (replicated
    entries to all, a shard's entries to its card's loop), steps every card's
    loop, and gives back the whole carry in its own order: replicated
    entries from the first card, each card's own from it."""
    monkeypatch.setattr(device_loop.StepLoop, "warm_up", lambda self: None)
    monkeypatch.setattr(device_loop.StepLoop, "capture", lambda self, name: None)
    owners = (None, 1, 0, None)  # x, card 1's entry, card 0's entry, λ

    def card_loop(c):
        def body(x, own, lam):
            (x, own), terminal, status, record = _count_body(x, own)
            return (x, own, lam), terminal, status, record

        carry = (torch.zeros(()), torch.zeros(()), torch.zeros(()))
        return device_loop.StepLoop(body, carry, 5, dict(x=torch.float32), 1)

    loops = device_loop.CardLoops([card_loop(0), card_loop(1)], owners, "toy")
    loops.start((0.0, 10.0, 20.0, -1.0))
    assert [t.tolist() for t in loops.loops[0].carry] == [0.0, 20.0, -1.0]
    assert [t.tolist() for t in loops.loops[1].carry] == [0.0, 10.0, -1.0]
    loops.solve(5, lambda t: t.tolist(), host_loop=host_loop)
    x, own1, own0, lam = (t.tolist() for t in loops.carry)
    # x 1, 2, 3 (terminal at 3): the own entries gain 1 + 2 + 3
    assert (x, own1, own0, lam) == (3.0, 16.0, 26.0, -1.0)
    assert bool(loops.done) and int(loops.it) == 2 and loops.trace["x"][:3].tolist() == [1.0, 2.0, 3.0]
    carry, done, status, record = loops.outputs()
    assert [t.tolist() for t in carry] == [3.0, 16.0, 26.0, -1.0] and bool(done) and float(record["x"]) == 3.0
    with pytest.raises(ValueError, match="owners say"):
        device_loop.CardLoops([card_loop(0), card_loop(1)], (None, 1, 0, 0, None), "toy")


class _TwoCardMesh:
    """Three shards on two cards, shards 0 and 2 on card 0, shard 1 on card
    1; the CPU stands in for both cards."""

    cards = (torch.device("cpu"),) * 2

    def per_card(self, device):
        return True

    def card_of(self):
        return (0, 1, 0)

    def card_transport(self):
        return "transport"

    def on_card(self, card, transport):
        return dict(card=card, shards=((0, 2), (1,))[card], transport=transport)


def test_card_loops_split_the_carry_by_shard(monkeypatch):
    """``device_loop.card_loops`` gives each card's view the replicated
    entries and its own shards' entries, in the carry's order, and makes
    the CardLoops with every entry's card; without a graph, or unsharded,
    it makes the one loop over the whole mesh with the whole carry."""
    monkeypatch.setattr(device_loop.StepLoop, "warm_up", lambda self: None)
    monkeypatch.setattr(device_loop.StepLoop, "capture", lambda self, name: None)
    made = []

    def make_loop(view, carry, capture):
        made.append((view, [float(t) for t in carry], capture))

        def body(*c):
            return c, torch.ones((), dtype=torch.bool), torch.zeros((), dtype=torch.int32), {}

        return device_loop.StepLoop(body, carry, 2, {}, 1)

    carry = tuple(torch.tensor(v) for v in (1.0, 10.0, 11.0, 12.0, -1.0))  # x, shards 0..2, λ
    mesh = _TwoCardMesh()
    loops = device_loop.card_loops(mesh, True, make_loop, carry, (None, 0, 1, 2, None), "toy")
    assert isinstance(loops, device_loop.CardLoops) and loops.owners == (None, 0, 1, 0, None)
    assert made == [(dict(card=0, shards=(0, 2), transport="transport"), [1.0, 10.0, 12.0, -1.0], False),
                    (dict(card=1, shards=(1,), transport="transport"), [1.0, 11.0, -1.0], False)]
    for graph, m in ((False, mesh), (True, None)):
        made.clear()
        one = device_loop.card_loops(m, graph, make_loop, carry, (None, 0, 1, 2, None), "toy")
        assert isinstance(one, device_loop.StepLoop)
        assert made == [(m, [1.0, 10.0, 11.0, 12.0, -1.0], graph)]


def test_update_hook_searches_its_own_cards_copy():
    """A registration block's update hook called for a shard on another
    device (a mesh over several cards) searches a copy of the target side
    made there at the first call, and ``load`` refills it; the matcher's
    own tensors stay where they were. The "meta" device stands in for a
    second card. A searcher of the caller's own cannot be copied: refused."""
    from moptimizer_0_tpu_torch.registration import _Matcher, _searcher, icp_block

    rng = np.random.default_rng(3)
    src, tgt, normals = (torch.as_tensor(rng.normal(size=(n, 3))) for n in (40, 60, 60))
    meta = torch.device("meta")
    for matcher, keys in ((icp_block(src, tgt, nn_backend="torch").update_fn, ("matched", "valid")),
                          (_Matcher("point2plane", tgt, normals, _searcher("torch", tgt, None), None),
                           ("matched", "valid", "normal"))):
        data = dict(src=src.to(meta), matched=src.to(meta), valid=torch.ones(40, dtype=torch.bool, device=meta))
        out = matcher(torch.zeros(6, device=meta), data)
        assert all(out[k].device == meta for k in keys) and out["matched"].shape == (40, 3)
        copy_tgt, copy_extra, search, _ = matcher.copies[meta]
        assert copy_tgt.device == meta and search.tgt_cloud is copy_tgt and matcher.tgt.device.type == "cpu"
        assert (copy_extra is None) == (matcher.extra is None)
        matcher(torch.zeros(6, device=meta), data)
        assert list(matcher.copies) == [meta]
        moved = tgt.clone() + 1.0
        matcher.load(moved, None if matcher.extra is None else normals, None)
        assert torch.equal(matcher.tgt, moved)
    custom = _Matcher("icp", tgt, None, lambda warped: (None, None), None)
    with pytest.raises(ValueError, match="cannot search"):
        custom(torch.zeros(6, device=meta), dict(src=src.to(meta)))


class _OneCardTransport:
    """A stand-in card transport whose card holds every shard: the slot-order
    plain reduction of the card's own flats."""

    def reserve(self, n_bytes):
        pass

    def reduce(self, flats, shards, card, op):
        return mesh_reduce.reduce_slots_plain([(shards, flats)], op)[0]


@pytest.mark.parametrize("op", ["sum", "max"])
def test_card_mesh_outputs_take_the_eager_layout(op):
    """A card's reduction hands back each tensor with the strides of the
    eager psum's result (a transposed partial stays transposed, as
    torch.add keeps it) and at a 256-byte boundary, like a fresh
    allocation: later reductions and cuBLAS choose their order and
    algorithm by both, so a contiguous copy, or a view at an odd offset,
    would change the next bits. The values equal Mesh.psum's."""
    rng = np.random.default_rng(11)
    mesh = Mesh(devices=(torch.device("cpu"),) * 3)
    view = mesh.on_card(0, _OneCardTransport())

    def part():
        return (torch.as_tensor(rng.normal(size=())),
                torch.as_tensor(rng.normal(size=(6, 37))).T,  # segment_sum's (S, q) result is a transpose
                torch.as_tensor(rng.normal(size=(5, 3, 3))),
                torch.as_tensor(rng.normal(size=7), dtype=torch.float32))

    parts = [part() for _ in range(3)]
    got = view.psum(parts) if op == "sum" else view.pmax(parts)
    want = make_mesh(3, device="cpu").psum(parts) if op == "sum" else make_mesh(3, device="cpu").pmax(parts)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.stride() == w.stride() and g.dtype == w.dtype
        assert torch.equal(g, w)
        assert (g.data_ptr() - g.untyped_storage().data_ptr()) % mesh_module.ALIGN_BYTES == 0
