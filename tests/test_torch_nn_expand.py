"""The plain expansion search of the port against the TPU kernel K6.

``_nn_expand_torch`` is held against ``_nn_pallas`` (K6) run in interpret
mode and against ``_nn_xla``, the expansion that the JAX package's fleet ICP
runs. Indices must be equal. d² is held to 8·2⁻²⁴·(‖q‖² + ‖p‖²): the
expansion cancels, so its roundoff scales with the squared norms, not with
d², and the three sum the cross term in different orders. A numpy version
that rounds each float32 operation in the port's order must match d² bit for
bit.

The CUDA kernel K6 runs on the card only (``chip_smoke.py`` holds it to the
plain version there). Its order of work — d² with one FMA for qn − 2·cross,
runs of targets that keep only their minimum, the first equal index of the
winning run, target splits merged in ascending order — is emulated here in
torch and held bit for bit against the plain version, on ties across split
boundaries, NaN query rows, three lanes and subnormal products.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu.ops.nn_search import _nn_pallas, _nn_xla
from moptimizer_0_tpu_torch.kernels import nn_expand as k_expand
from moptimizer_0_tpu_torch.ops.nn_search import _nn_expand_torch, _nn_torch, nearest_neighbors
from moptimizer_0_tpu_torch.registration import make_searcher

EPS32 = 2.0**-24


def _numpy_expand(q, p):
    q = q.astype(np.float32)
    p = p.astype(np.float32)
    qn = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
    pn = (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]) + p[:, 2] * p[:, 2]
    cross = (q[:, None, 0] * p[None, :, 0] + q[:, None, 1] * p[None, :, 1]) + q[:, None, 2] * p[None, :, 2]
    d2 = (qn[:, None] - np.float32(2.0) * cross) + pn[None, :]
    d2[np.isnan(d2)] = np.inf
    return d2.argmin(1), d2.min(1)


def _bound(q, p, idx):
    """8·2⁻²⁴·(‖q‖² + ‖p_idx‖²) per query."""
    q = q.astype(np.float64)
    p = p.astype(np.float64)
    return 8 * EPS32 * ((q * q).sum(-1) + (p[idx] * p[idx]).sum(-1))


def _check_against_jax(q, p):
    idx, d2 = _nn_expand_torch(torch.as_tensor(q), torch.as_tensor(p))
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    idx, d2 = idx.numpy(), d2.numpy()
    n_idx, n_d2 = _numpy_expand(q, p)
    np.testing.assert_array_equal(idx, n_idx)
    np.testing.assert_array_equal(d2, n_d2)
    bound = _bound(q, p, idx)
    for name, (j_idx, j_d2) in {
        "pallas": _nn_pallas(jnp.asarray(q), jnp.asarray(p), block_q=256, block_p=512, interpret=True),
        "xla": _nn_xla(jnp.asarray(q), jnp.asarray(p)),
    }.items():
        np.testing.assert_array_equal(idx, np.asarray(j_idx), err_msg=name)
        assert (np.abs(d2 - np.asarray(j_d2)) <= bound).all(), name
    return idx, d2


@pytest.mark.parametrize(
    "n_query,n_points",
    [
        (600, 1100),
        (33, 77),  # ragged against every tile
        (129, 2049),  # one past the CUDA kernel's 128-thread block and 2048-point tile
    ],
)
def test_nn_expand_torch_matches_pallas_and_xla(n_query, n_points):
    rng = np.random.default_rng(n_query + n_points)
    q = rng.uniform(0, 10, (n_query, 3)).astype(np.float32)
    p = rng.uniform(0, 10, (n_points, 3)).astype(np.float32)
    _check_against_jax(q, p)


def test_nn_expand_lanes_search_only_their_own_points():
    """B = 3 lanes of different clouds of one shape: each lane equals its
    own single search, and a lane offset error would pick another lane's
    indices or distances."""
    rng = np.random.default_rng(7)
    q = rng.uniform(0, 10, (3, 200, 3)).astype(np.float32)
    p = rng.uniform(0, 10, (3, 300, 3)).astype(np.float32)
    p[1] += 50.0  # lane 1's targets far from the others
    idx, d2 = _nn_expand_torch(torch.as_tensor(q), torch.as_tensor(p))
    assert idx.shape == d2.shape == (3, 200)
    for b in range(3):
        i1, d1 = _nn_expand_torch(torch.as_tensor(q[b]), torch.as_tensor(p[b]))
        torch.testing.assert_close(idx[b], i1, rtol=0, atol=0)
        torch.testing.assert_close(d2[b], d1, rtol=0, atol=0)
        j_idx, _ = _nn_xla(jnp.asarray(q[b]), jnp.asarray(p[b]))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(j_idx))
    assert float(d2[1].min()) > 1000.0  # lane 1 saw only its own, distant targets


def test_nn_expand_chunks_agree_with_one_block(monkeypatch):
    """The chunked plain version gives the same result as one block."""
    rng = np.random.default_rng(8)
    q = torch.as_tensor(rng.uniform(-5, 5, (2, 130, 3)), dtype=torch.float32)
    p = torch.as_tensor(rng.uniform(-5, 5, (2, 70, 3)), dtype=torch.float32)
    whole = _nn_expand_torch(q, p)
    monkeypatch.setattr("moptimizer_0_tpu_torch.ops.nn_search._CHUNK_ELEMS", 2 * 70 * 9)
    chunked = _nn_expand_torch(q, p)
    torch.testing.assert_close(whole, chunked, rtol=0, atol=0)


def test_nn_expand_ties_go_to_the_smallest_index():
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 10, (300, 3)).astype(np.float32)
    p = np.concatenate([base, base, base])  # every target three times
    q = np.concatenate([base[:50], rng.uniform(0, 10, (70, 3)).astype(np.float32)])
    idx, _ = _check_against_jax(q, p)
    assert (idx < len(base)).all()
    np.testing.assert_array_equal(idx[:50], np.arange(50))


def test_nn_expand_nan_query_and_the_routes():
    """A NaN query gives (0, +inf) in the port and in the Pallas kernel;
    ``_nn_xla`` gives (0, NaN). Both are invalid under either gate rule
    (d² < mcd², isfinite), so the fleet's correspondences agree."""
    rng = np.random.default_rng(4)
    q = rng.uniform(0, 10, (40, 3)).astype(np.float32)
    q[7] = np.nan
    q[11, 1] = np.nan
    p = rng.uniform(0, 10, (90, 3)).astype(np.float32)
    idx, d2 = _nn_expand_torch(torch.as_tensor(q), torch.as_tensor(p))
    n_idx, n_d2 = _numpy_expand(q, p)
    np.testing.assert_array_equal(idx.numpy(), n_idx)
    np.testing.assert_array_equal(d2.numpy(), n_d2)
    j_idx, j_d2 = _nn_pallas(jnp.asarray(q), jnp.asarray(p), block_q=256, block_p=512, interpret=True)
    x_idx, x_d2 = _nn_xla(jnp.asarray(q), jnp.asarray(p))
    for row in (7, 11):
        assert int(idx[row]) == int(j_idx[row]) == int(x_idx[row]) == 0
        assert float(d2[row]) == float(j_d2[row]) == np.inf
        assert np.isnan(float(x_d2[row]))
        for value in (float(d2[row]), float(x_d2[row])):
            assert not value < 1.0**2 and not np.isfinite(value)


def test_nn_expand_d2_is_not_clamped():
    """A query on a target far from the origin: the expansion's d² may be
    slightly negative, and stays so, as in the JAX package."""
    p = np.array([[100.0, 100.0, 100.0], [0.0, 0.0, 0.0]], np.float32)
    q = (p[:1] + np.float32(1e-3)).astype(np.float32)
    _, d2 = _nn_expand_torch(torch.as_tensor(q), torch.as_tensor(p))
    _, n_d2 = _numpy_expand(q, p)
    np.testing.assert_array_equal(d2.numpy(), n_d2)
    assert abs(float(d2[0]) - 3e-6) > 1e-4  # roundoff of ε·(‖q‖² + ‖p‖²), far above d²


def test_expansion_backend_routing():
    q = torch.rand(10, 3)
    p = torch.rand(20, 3)
    before = k_expand.LAUNCHES
    torch.testing.assert_close(nearest_neighbors(q, p, backend="xla"), _nn_expand_torch(q, p), rtol=0, atol=0)
    torch.testing.assert_close(nearest_neighbors(q, p), _nn_torch(q, p), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        nearest_neighbors(q, p, backend="pallas_mxu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        k_expand.nn_expand_cuda(q[None], p[None])
    searcher = make_searcher(p, "xla", None)
    torch.testing.assert_close(searcher(q), _nn_expand_torch(q, p), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        make_searcher(p, "pallas_mxu", None)(q)
    assert k_expand.LAUNCHES == before
    assert k_expand._launcher.cache_info().currsize == 0


# --- K6's order of work, emulated -------------------------------------------
#
# The CUDA kernel (csrc/nn_expand.cu) runs only on the card. Its order of
# work is emulated here in torch, on the CPU, and held bit for bit against
# the plain version: d² with qn − 2·cross as one FMA, runs of targets that
# keep only their minimum, a strict `<` between runs, the first equal index
# of the winning run, and target splits merged in ascending order.


def _sq(a):
    return (a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]) + a[..., 2] * a[..., 2]


def _k6_d2(q, p, fold=False):
    """(..., Q, M) d² in the kernel's arithmetic: fma(−2, cross, qn) + pn.
    The FMA's one rounding is taken in float64 and rounded once to float32,
    which is exact for a sum of two float32 values. ``fold`` instead scales
    the targets by −2 first and adds the rounded products to qn."""
    qn = _sq(q)[..., :, None]
    pn = _sq(p)[..., None, :]
    pp = -2.0 * p if fold else p
    px, py, pz = (pp[..., None, :, c] for c in range(3))
    cross = (q[..., 0:1] * px + q[..., 1:2] * py) + q[..., 2:3] * pz
    if fold:
        return (qn + cross) + pn
    return (qn.double() - 2.0 * cross.double()).float() + pn


def _k6_emulated(q, p, run=32, splits=1, fold=False):
    """(idx, d²) as the kernel finds them, over (..., Q, M)."""
    d2 = _k6_d2(q, p, fold)
    M = d2.shape[-1]
    split_len = -(-M // splits)
    inf = torch.full(d2.shape[:-1], torch.inf)
    best, idx = inf.clone(), torch.zeros(d2.shape[:-1], dtype=torch.int64)
    for lo in range(0, M, split_len):
        hi = min(M, lo + split_len)
        s_best, s_run = inf.clone(), torch.full(d2.shape[:-1], -1)
        for first in range(lo, hi, run):
            blk = d2[..., first : min(first + run, hi)]
            m = torch.where(torch.isnan(blk), torch.inf, blk).amin(-1)  # fminf skips NaN
            better = m < s_best
            s_best = torch.where(better, m, s_best)
            s_run = torch.where(better, first, s_run)
        # the first index of the winning run whose d² equals the best
        j = torch.arange(M)
        in_run = (j >= s_run[..., None]) & (j < torch.clamp(s_run[..., None] + run, max=hi))
        hit = in_run & (d2 == s_best[..., None])
        s_idx = torch.where(s_run >= 0, torch.argmax(hit.to(torch.int8), -1), 0)
        s_d2 = torch.where(s_run >= 0, torch.gather(d2, -1, s_idx[..., None])[..., 0], torch.inf)
        # merge: ascending splits, strict `<`
        take = s_d2 < best
        best = torch.where(take, s_d2, best)
        idx = torch.where(take, s_idx, idx)
    return idx.to(torch.int32), best


def _subnormal_products(rng, n):
    """Coordinates near 1e-20, whose products lie below float32's normal
    range; every third point has one ordinary coordinate."""
    a = rng.uniform(-1, 1, (n, 3)) * 1e-20
    a[::3, 0] = rng.uniform(-1, 1, len(a[::3]))
    return torch.as_tensor(a, dtype=torch.float32)


def _k6_case(name):
    rng = np.random.default_rng(len(name))
    if name == "ragged":
        return (torch.as_tensor(rng.uniform(-10, 10, (33, 3)), dtype=torch.float32),
                torch.as_tensor(rng.uniform(-10, 10, (77, 3)), dtype=torch.float32))
    if name == "ties":  # every target three times; a split boundary at each copy for 3 splits
        base = torch.as_tensor(rng.uniform(-10, 10, (96, 3)), dtype=torch.float32)
        return base[::3].contiguous(), torch.cat([base, base, base])
    if name == "nan rows":
        q = torch.as_tensor(rng.uniform(-10, 10, (40, 3)), dtype=torch.float32)
        q[7] = torch.nan
        q[11, 1] = torch.nan
        return q, torch.as_tensor(rng.uniform(-10, 10, (90, 3)), dtype=torch.float32)
    if name == "3 lanes":
        p = torch.as_tensor(rng.uniform(-10, 10, (3, 150, 3)), dtype=torch.float32)
        p[1] += 40.0
        return torch.as_tensor(rng.uniform(-10, 10, (3, 60, 3)), dtype=torch.float32), p
    if name == "subnormal products":
        return _subnormal_products(rng, 120), _subnormal_products(rng, 300)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["ragged", "ties", "nan rows", "3 lanes", "subnormal products"])
@pytest.mark.parametrize("run,splits", [(32, 1), (32, 3), (16, 7), (4, 2)])
def test_k6_order_of_work_is_bit_equal_to_the_plain_version(name, run, splits):
    q, p = _k6_case(name)
    want_idx, want_d2 = _nn_expand_torch(q, p)
    idx, d2 = _k6_emulated(q, p, run=run, splits=splits)
    torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
    assert torch.equal(d2.view(torch.int32), want_d2.view(torch.int32))
    if name == "ties":
        assert bool((idx < p.shape[0] // 3).all())  # the first copy wins, across every split
    if name == "nan rows":
        for row in (7, 11):
            assert int(idx[row]) == 0 and float(d2[row]) == np.inf


def test_k6_d2_is_the_plain_d2_bit_for_bit_and_the_fold_is_not():
    """fma(−2, cross, qn) rounds once where the plain version rounds
    2·cross (exact) and then the difference: equal, subnormal products
    included. Folding −2 into the targets rounds each product at twice the
    scale, and a subnormal product then rounds to another value: the kernel
    does not fold."""
    q, p = _k6_case("subnormal products")
    want = (_sq(q)[:, None] - 2.0 * ((q[:, None, 0] * p[None, :, 0] + q[:, None, 1] * p[None, :, 1])
                                     + q[:, None, 2] * p[None, :, 2])) + _sq(p)[None, :]
    assert torch.equal(_k6_d2(q, p).view(torch.int32), want.view(torch.int32))
    assert not torch.equal(_k6_d2(q, p, fold=True).view(torch.int32), want.view(torch.int32))
    # on ordinary coordinates the fold happens to agree
    q, p = _k6_case("ragged")
    assert torch.equal(_k6_d2(q, p, fold=True), _k6_d2(q, p))


@pytest.mark.parametrize(
    "n_blocks,n_points,n_sms,want",
    [
        (58 * 64, 29_310, 132, 1),  # the 64-lane fleet fills the card
        (58, 29_310, 132, 9),  # one fachada lane: 522 blocks, at most 4 on an SM
        (1, 77, 132, 1),  # too few targets to split
        (2, 4_097, 132, 16),  # at most one range per 256 targets
        (264, 10_000, 132, 1),  # two blocks an SM: no split
    ],
)
def test_k6_target_splits(n_blocks, n_points, n_sms, want):
    assert k_expand.n_splits(n_blocks, n_points, n_sms) == want


def test_k6_splits_balance_the_busiest_sm():
    """The chosen S never loads the busiest SM more than the other
    candidates from the least S that gives two blocks an SM to twice it."""
    for n_blocks in (1, 5, 58, 100, 263):
        s = k_expand.n_splits(n_blocks, 1 << 20, 132)
        least = -(-2 * 132 // n_blocks)
        assert least <= s <= 2 * least and n_blocks * s >= 2 * 132
        work = [-(-n_blocks * c // 132) / c for c in range(least, 2 * least + 1)]
        assert -(-n_blocks * s // 132) / s == min(work)


@pytest.mark.parametrize("shape", [(10, 3), (2, 10, 3)])
def test_k6_wrapper_refuses_cpu_tensors_before_building(shape):
    q = torch.rand(shape)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k_expand.nn_expand_cuda(q, q)
    assert k_expand._launcher.cache_info().currsize == 0
