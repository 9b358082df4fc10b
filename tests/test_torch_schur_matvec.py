"""The CG engine's matvec kernels (``kernels/schur_matvec.py``) and their plan.

On the CPU: ``matvec_plan``'s CSRs and tiles on small incidences (items
sorted stably by segment, offsets, tiles that cover every item once in
order, empty segments, the int32 bounds), and a float64 sum over the plan
against the engine's plain ``segment_sum`` path. Tests marked ``card`` need a
CUDA card and skip without one; on a machine with one, run them with
``python3 -m pytest --noconftest tests/test_torch_schur_matvec.py`` (the
suite's conftest imports JAX, which that machine does not have). They hold
each half to its plain version to float32 roundoff, two calls and a CUDA
graph's replay to the eager call bit for bit, and the launch count of a
solve to its PCG iterations and trials. This file imports no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from moptimizer_0_tpu_torch import ba
from moptimizer_0_tpu_torch.kernels import schur_matvec as smv
from moptimizer_0_tpu_torch.ops.segment_sum import segment_plan, segment_sum
from moptimizer_0_tpu_torch.parallel import make_mesh, multihost


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def venice_slice(C, L, seed, device="cpu"):
    """(cam_idx, pt_idx) in landmark order, shaped like the benchmark's
    Venice tracks: landmark l seen by a run of neighbouring cameras, 2 + a
    geometric draw long, with one 256-long track, a tenth of the landmarks
    seen once, a tenth not at all, and the first and last 3 cameras seeing
    nothing."""
    rng = np.random.default_rng(seed)
    k = 2 + rng.geometric(1 / 4, size=L) - 1
    k[rng.random(L) < 0.1] = 1
    k[rng.random(L) < 0.1] = 0
    k[L // 2] = 256
    k = np.minimum(k, C - 6)
    first = 3 + (rng.random(L) * (C - 6 - k + 1)).astype(np.int64)
    pt = np.repeat(np.arange(L), k)
    start = np.cumsum(k) - k
    cam = first[pt] + np.arange(pt.size) - start[pt]
    return torch.as_tensor(cam, device=device), torch.as_tensor(pt, device=device)


def random_incidence(C, L, O, seed, device="cpu"):
    """(cam_idx, pt_idx) drawn uniformly in no order, over ids that leave
    some cameras and landmarks without items."""
    g = torch.Generator().manual_seed(seed)
    cam = torch.randint(0, C - 2, (O,), generator=g) + 1  # cameras 0 and C − 1 see nothing
    pt = torch.randint(0, L, (O,), generator=g)
    return cam.to(device), pt.to(device)


PLAN_CASES = {
    "venice slice": lambda: (*venice_slice(40, 300, 1), 40, 300),
    "random, no order": lambda: (*random_incidence(9, 60, 700, 2), 9, 60),
    "camera-major (the SfM example's layout)": lambda: (
        torch.arange(7).repeat_interleave(30), torch.arange(30).repeat(7), 7, 30),
    "one camera, one landmark": lambda: (torch.zeros(5, dtype=torch.long), torch.zeros(5, dtype=torch.long), 1, 1),
    "no observation": lambda: (torch.zeros(0, dtype=torch.long), torch.zeros(0, dtype=torch.long), 4, 6),
    "tracks over 32 long": lambda: (torch.arange(100) % 3, torch.arange(100) // 50, 3, 2),
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_csrs_and_tiles(name):
    cam, pt, C, L = PLAN_CASES[name]()
    O = cam.numel()
    plan = smv.matvec_plan(cam, pt, C, L)
    assert (plan.C, plan.L, plan.n_items) == (C, L, O)
    for t in (plan.lm_ptr, plan.lm_rows, plan.lm_cam, plan.tile_ptr, plan.cam_rows, plan.cam_pt, plan.cam_tiles):
        assert t.dtype == torch.int32
    # items sorted stably by segment, with each item's other id
    assert torch.equal(plan.lm_rows.long(), torch.argsort(pt, stable=True))
    assert torch.equal(plan.cam_rows.long(), torch.argsort(cam, stable=True))
    assert torch.equal(plan.lm_cam.long(), cam[plan.lm_rows.long()])
    assert torch.equal(plan.cam_pt.long(), pt[plan.cam_rows.long()])
    # offsets: landmark l's items, empty landmarks included
    lm_counts = torch.bincount(pt, minlength=L)
    assert torch.equal(plan.lm_ptr.long(), torch.cat([torch.zeros(1, dtype=torch.long), lm_counts.cumsum(0)]))
    # tiles: every item once, in order, each tile within one camera, T items
    # but a camera's last; a camera with no item has no tile
    cam_counts = torch.bincount(cam, minlength=C)
    bounds = plan.tile_ptr.long()
    assert bounds.shape == (plan.n_tiles + 1,) and int(bounds[-1]) == O
    sizes = bounds[1:] - bounds[:-1]
    assert bool((sizes > 0).all()) and bool((sizes <= plan.tile).all())
    per_cam = plan.cam_tiles.long()[1:] - plan.cam_tiles.long()[:-1]
    assert torch.equal(per_cam, (cam_counts + plan.tile - 1) // plan.tile)
    assert int(plan.cam_tiles[0]) == 0 and int(plan.cam_tiles[-1]) == plan.n_tiles
    sorted_cam = cam[plan.cam_rows.long()]
    for c in range(C):
        j0, j1 = int(plan.cam_tiles[c]), int(plan.cam_tiles[c + 1])
        if j0 == j1:
            assert int(cam_counts[c]) == 0
            continue
        items = torch.arange(int(bounds[j0]), int(bounds[j1]))
        assert bool((sorted_cam[items] == c).all()) and items.numel() == int(cam_counts[c])
        assert bool((sizes[j0 : j1 - 1] == plan.tile).all())
    # lanes a landmark: the least power of two ≥ 2·O / L, at most 16
    assert 1 << plan.group_log2 == min(16, 1 << max(0, -(-2 * O // L) - 1).bit_length())


def _plan_sums(plan, W, u, s):
    """Both halves in float64 by the plan's CSRs (landmarks) and tiles
    (cameras, each tile summed, then its camera's tiles)."""
    rows_l, rows_c = plan.lm_rows.long(), plan.cam_rows.long()
    seg_l = torch.repeat_interleave(torch.arange(plan.L), torch.diff(plan.lm_ptr.long()))
    t = torch.zeros(plan.L, 3, dtype=W.dtype).index_add_(
        0, seg_l, torch.einsum("oim,oi->om", W[rows_l], u[plan.lm_cam.long()]))
    tile_of = torch.repeat_interleave(torch.arange(plan.n_tiles), torch.diff(plan.tile_ptr.long()))
    part = torch.zeros(plan.n_tiles, 6, dtype=W.dtype).index_add_(
        0, tile_of, torch.einsum("oim,om->oi", W[rows_c], s[plan.cam_pt.long()]))
    cam_of = torch.repeat_interleave(torch.arange(plan.C), torch.diff(plan.cam_tiles.long()))
    y = torch.zeros(plan.C, 6, dtype=W.dtype).index_add_(0, cam_of, part)
    return t, y


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_sums_match_segment_sums(name):
    """The plan's CSRs and tiles in float64 give the engine's plain halves
    (``ba._landmark_sum_plain``, ``_camera_sum_plain``) to roundoff."""
    cam, pt, C, L = PLAN_CASES[name]()
    O = cam.numel()
    g = torch.Generator().manual_seed(5)
    W = torch.randn(O, 6, 3, generator=g, dtype=torch.float64)
    u = torch.randn(C, 6, generator=g, dtype=torch.float64)
    s = torch.randn(L, 3, generator=g, dtype=torch.float64)
    plan = smv.matvec_plan(cam, pt, C, L)
    p = ba.BAProblem(camera_params=torch.zeros(C, 6), points=torch.zeros(L, 3), cam_idx=cam, pt_idx=pt,
                     pixels=torch.zeros(O, 2), intrinsics=torch.ones(4))
    ones = torch.ones_like(cam)
    plans = (segment_plan(cam, ones, C), segment_plan(pt, ones, L), plan)
    t, y = _plan_sums(plan, W, u, s)
    assert torch.allclose(t, ba._landmark_sum_plain(p, plans, W, u), rtol=1e-12, atol=1e-12)
    assert torch.allclose(y, ba._camera_sum_plain(p, plans, W, s), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_items, tile", [(0, 32), (1, 32), (1 << 17, 32), ((1 << 17) + 1, 64),
                                           (5_001_946, 2048), (1 << 31, 8192)])
def test_tile_size(n_items, tile):
    """32 lanes × the least power of two of items a lane that keeps the
    tiles at about TARGET_TILES, at most MAX_TILE."""
    assert smv.tile_size(n_items) == tile


@pytest.mark.parametrize("tile", [32, 64, 128])
def test_tiles_cut_each_camera_from_its_first_item(tile):
    counts = torch.tensor([0, 70, 1, 0, 128, 129, 0])
    n = int(((counts + tile - 1) // tile).sum())
    tile_ptr, cam_tiles = smv.tiles(counts, tile, n)
    first = torch.cat([torch.zeros(1, dtype=torch.long), counts.cumsum(0)])
    expect = [int(first[c]) + r * tile for c in range(7) for r in range(-(-int(counts[c]) // tile))]
    assert tile_ptr.tolist() == expect + [int(counts.sum())]
    assert torch.diff(cam_tiles).tolist() == [-(-int(k) // tile) for k in counts]


@pytest.mark.parametrize("cam, pt, C, L, match", [
    ([0, 3], [0, 1], 3, 2, "camera id"),
    ([0, -1], [0, 1], 3, 2, "camera id"),
    ([0, 1], [0, 2], 3, 2, "landmark id"),
    ([0, 1], [0, -5], 3, 2, "landmark id"),
    ([0, 1], [0], 3, 2, "2 camera ids but 1"),
    ([0], [0], 2**31 // 6 + 1, 1, "2\\*\\*31"),
    ([0], [0], 1, 2**31 // 3 + 1, "2\\*\\*31"),
    ([0], [0], 0, 1, "2\\*\\*31"),
])
def test_plan_refuses_ids_and_sizes_past_int32(cam, pt, C, L, match):
    with pytest.raises(ValueError, match=match):
        smv.matvec_plan(torch.tensor(cam), torch.tensor(pt), C, L)


def test_cuda_halves_refuse_cpu_tensors():
    cam, pt = torch.tensor([0, 1]), torch.tensor([0, 0])
    plan = smv.matvec_plan(cam, pt, 2, 1)
    W = torch.zeros(2, 6, 3)
    with pytest.raises(ValueError, match="CUDA"):
        smv.to_landmarks_cuda(plan, W, torch.zeros(2, 6))
    with pytest.raises(ValueError, match="CUDA"):
        smv.to_cameras_cuda(plan, W, torch.zeros(1, 3))


# ---- on the card -----------------------------------------------------------

def _bound_ratio(k, ref, scale, counts):
    """max |k − ref| / ((n + 6)·2⁻²⁴·Σ|terms|): at most 1 for float32 sums
    of n products, in any order, to first order."""
    bound = (counts.double()[:, None] + 6) * 2.0**-24 * scale
    return float(((k.double() - ref).abs() / bound.clamp_min(1e-300)).max())


CARD_CASES = {
    "venice slice": lambda: (*venice_slice(120, 3000, 7), 120, 3000),
    "random, no order": lambda: (*random_incidence(50, 4000, 60_000, 8), 50, 4000),
}


@pytest.mark.card
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_card_halves_match_plain(card, name, shards):
    """Each shard's halves against their plain versions to float32 roundoff,
    two calls bit-equal, on the rows of 1, 2 and 4 shards of the incidence."""
    cam, pt, C, L = CARD_CASES[name]()
    n = cam.numel() - cam.numel() % shards
    g = torch.Generator().manual_seed(11)
    W = torch.randn(n, 6, 3, generator=g)
    u = torch.randn(C, 6, generator=g).to(card)
    s = torch.randn(L, 3, generator=g).to(card)
    rows = n // shards
    for j in range(shards):
        sl = slice(j * rows, (j + 1) * rows)
        p = ba.BAProblem(camera_params=torch.zeros(C, 6, device=card), points=torch.zeros(L, 3, device=card),
                         cam_idx=cam[sl].to(card), pt_idx=pt[sl].to(card), pixels=torch.zeros(rows, 2, device=card),
                         intrinsics=torch.ones(4, device=card))
        plans = ba._plans(p)
        Wj = W[sl].to(card)
        W_cam = ba._shard_row(p, plans, Wj)[3]
        for kernel, W_in, plain, seg, vec, ids, size in (
            (smv.to_landmarks_cuda, Wj, ba._landmark_sum_plain, plans[1], u, p.cam_idx, L),
            (smv.to_cameras_cuda, W_cam, ba._camera_sum_plain, plans[0], s, p.pt_idx, C),
        ):
            k, again = kernel(plans[2], W_in, vec), kernel(plans[2], W_in, vec)
            spec = "oim,oi->om" if kernel is smv.to_landmarks_cuda else "oim,om->oi"
            ref = segment_sum(seg, torch.einsum(spec, Wj.double(), vec.double()[ids]))
            scale = segment_sum(seg, torch.einsum(spec, Wj.double().abs(), vec.double().abs()[ids]))
            counts = torch.bincount(p.pt_idx if size == L else p.cam_idx, minlength=size)
            assert torch.equal(k.view(torch.int32), again.view(torch.int32))
            assert _bound_ratio(k, ref, scale, counts) <= 1.0
            assert _bound_ratio(plain(p, plans, Wj, vec), ref, scale, counts) <= 1.0


@pytest.mark.card
def test_card_replay_equals_eager(card):
    """Both halves captured into a CUDA graph: each replay gives the eager
    call's bits, and the card counts the replayed launches."""
    cam, pt, C, L = CARD_CASES["venice slice"]()
    plan = smv.matvec_plan(cam.to(card), pt.to(card), C, L)
    g = torch.Generator().manual_seed(12)
    W = torch.randn(cam.numel(), 6, 3, generator=g).to(card)
    W_cam = W[plan.cam_rows.long()]
    u = torch.randn(C, 6, generator=g).to(card)
    s = torch.randn(L, 3, generator=g).to(card)
    smv.reset_launches()
    eager = (smv.to_landmarks_cuda(plan, W, u), smv.to_cameras_cuda(plan, W_cam, s))
    assert smv.LAUNCHES == 2
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        out = (smv.to_landmarks_cuda(plan, W, u), smv.to_cameras_cuda(plan, W_cam, s))
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert smv.LAUNCHES == 2 and smv.replayed() == 6


@pytest.mark.card
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_card_solve_counts_two_launches_a_pcg_iteration(card, shards):
    """A CG solve by its graph launches each half once a PCG iteration and
    once more a trial (the rhs, the back-substitution), on every shard; a
    second solve gives the same bits."""
    prob = ba.make_ba_problem(8_000, 40, 2_000, seed=3, device=card)
    if shards > 1:
        mesh = make_mesh(shards)
        prob = dataclasses.replace(prob, **{k: multihost.make_global_array(getattr(prob, k), mesh)
                                            for k in ("cam_idx", "pt_idx", "pixels")})
    cfg = ba.BAConfig(max_iterations=4)
    ba.solve_ba(prob, cfg)  # captures the layout
    smv.reset_launches()
    res = ba.solve_ba(prob, cfg)
    again = ba.solve_ba(prob, cfg)
    runs = int(res.trace["pcg_iterations"].sum()) + int(res.trace["trials"].sum())
    assert runs > 0 and smv.LAUNCHES == 0
    assert smv.replayed() == 2 * 2 * shards * runs
    for a, b in ((res.camera_params, again.camera_params), (res.points, again.points), (res.cost, again.cost)):
        assert torch.equal(a, b)
