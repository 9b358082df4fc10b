"""The plain nearest-neighbour search of the port against the TPU kernel K5.

``_nn_torch`` is held against ``_nn_pallas_vpu`` run in interpret mode and
against a numpy argmin. Indices must be equal. The numpy reference rounds
every operation in float32 like ``_nn_torch`` does, so d² is bit-equal to it;
against the interpreted kernel d² is held to rtol 1e-6, since XLA on the CPU
may contract the sum into fused multiply-adds.

The CUDA kernel K5 runs on the card only (``chip_smoke.py`` holds it to the
plain version there). Its order of work — runs of targets that keep only
their minimum, the first equal index of the winning run, target splits
merged in ascending order — is emulated here in torch and held bit for bit
against the plain version, on ties across split boundaries, NaN query and
target rows, overflow and subnormal differences.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu.ops.nn_search import _nn_pallas_vpu
from moptimizer_0_tpu_torch.kernels import build
from moptimizer_0_tpu_torch.kernels import nn_expand as k_expand
from moptimizer_0_tpu_torch.kernels import nn_search as k_nn
from moptimizer_0_tpu_torch.ops.nn_search import _nn_torch, nearest_neighbors
from moptimizer_0_tpu_torch.registration import GRID_AUTO_MIN_TARGETS, make_searcher
from test_torch_nn_expand import emulate_order_of_work


def _k5_constant(name):
    src = (build.CSRC_DIR / "nn_search.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# K5's queries a block (128 threads × kR queries a thread) and targets a run.
K5_QUERIES_PER_BLOCK = _k5_constant("kThreads") * _k5_constant("kR")
K5_RUN = _k5_constant("kRun")


def _numpy_nn(q, p):
    q = q.astype(np.float32)
    p = p.astype(np.float32)
    dx = q[:, None, 0] - p[None, :, 0]
    dy = q[:, None, 1] - p[None, :, 1]
    dz = q[:, None, 2] - p[None, :, 2]
    d2 = dx * dx + dy * dy + dz * dz
    d2[np.isnan(d2)] = np.inf
    return d2.argmin(1), d2.min(1)


def _check_all_three(q, p):
    idx, d2 = _nn_torch(torch.as_tensor(q), torch.as_tensor(p))
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    n_idx, n_d2 = _numpy_nn(q, p)
    np.testing.assert_array_equal(idx.numpy(), n_idx)
    np.testing.assert_array_equal(d2.numpy(), n_d2)
    j_idx, j_d2 = _nn_pallas_vpu(jnp.asarray(q), jnp.asarray(p), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(j_d2), rtol=1e-6)
    return idx.numpy(), d2.numpy()


@pytest.mark.parametrize(
    "n_query,n_points",
    [
        (600, 1100),
        (33, 77),
        (513, 4097),  # one past the Pallas kernel's 512×4096 tile
        (129, 2049),  # one past the CUDA kernel's 128-thread block and 2048-point tile
        (K5_QUERIES_PER_BLOCK + 1, K5_RUN + 1),  # one past K5's query block and its run
        (K5_QUERIES_PER_BLOCK - 1, 3 * K5_RUN - 1),  # one short of both
    ],
)
def test_nn_torch_matches_pallas_and_numpy(n_query, n_points):
    rng = np.random.default_rng(n_query + n_points)
    q = rng.uniform(0, 10, (n_query, 3)).astype(np.float32)
    p = rng.uniform(0, 10, (n_points, 3)).astype(np.float32)
    _check_all_three(q, p)


def test_nn_ties_go_to_the_smallest_index():
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 10, (300, 3)).astype(np.float32)
    p = np.concatenate([base, base, base])  # every target three times
    q = np.concatenate([base[:50], rng.uniform(0, 10, (70, 3)).astype(np.float32)])
    idx, d2 = _check_all_three(q, p)
    assert (idx < len(base)).all()
    np.testing.assert_array_equal(idx[:50], np.arange(50))
    np.testing.assert_array_equal(d2[:50], 0.0)


def test_nn_nan_query_row_gives_index_0_and_inf():
    rng = np.random.default_rng(4)
    q = rng.uniform(0, 10, (40, 3)).astype(np.float32)
    q[7] = np.nan
    q[11, 1] = np.nan
    p = rng.uniform(0, 10, (90, 3)).astype(np.float32)
    idx, d2 = _check_all_three(q, p)
    for row in (7, 11):
        assert idx[row] == 0 and d2[row] == np.inf


def test_nn_searches_in_float32_whatever_the_input_dtype():
    rng = np.random.default_rng(5)
    q = rng.uniform(0, 10, (50, 3))
    p = rng.uniform(0, 10, (80, 3))
    i64, d64 = nearest_neighbors(torch.as_tensor(q), torch.as_tensor(p))
    i32, d32 = nearest_neighbors(
        torch.as_tensor(q, dtype=torch.float32), torch.as_tensor(p, dtype=torch.float32)
    )
    assert d64.dtype == torch.float32
    torch.testing.assert_close(i64, i32, rtol=0, atol=0)
    torch.testing.assert_close(d64, d32, rtol=0, atol=0)


def test_nn_backend_routing_and_errors():
    q = torch.rand(10, 3)
    p = torch.rand(20, 3)
    auto = nearest_neighbors(q, p)  # CPU tensors: the plain version
    plain = _nn_torch(q, p)
    torch.testing.assert_close(auto, plain, rtol=0, atol=0)
    for name in ("cuda", "pallas"):  # "pallas" is the JAX package's name for K5
        with pytest.raises(ValueError, match="CUDA tensor"):
            nearest_neighbors(q, p, backend=name)
    # the expansion: K6 on CUDA tensors only, its plain version under "xla"
    with pytest.raises(ValueError, match="CUDA tensor"):
        nearest_neighbors(q, p, backend="pallas_mxu")
    xla = nearest_neighbors(q, p, backend="xla")
    torch.testing.assert_close(xla[0], plain[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown"):
        nearest_neighbors(q, p, backend="grid")
    with pytest.raises(ValueError, match="non-empty"):
        nearest_neighbors(q[:0], p)


def test_grid_searcher_routes_grid_and_gated_auto():
    """"grid", and "auto" with a gate on GRID_AUTO_MIN_TARGETS targets or
    more, search the hash grid, whose radius semantics give a far query
    (−1, +inf); ungated "auto", and gated "auto" on fewer targets, stay
    brute force and find the far nearest point."""
    p = torch.as_tensor(np.random.default_rng(9).uniform(0, 100, (GRID_AUTO_MIN_TARGETS, 3)), dtype=torch.float32)
    far = torch.tensor([[500.0, 500.0, 500.0]])
    for backend, targets in (("grid", p[:100]), ("auto", p)):
        idx, d2 = make_searcher(targets, backend, 1.0)(far)
        assert int(idx[0]) == -1 and float(d2[0]) == np.inf
    for targets, gate in ((p, None), (p[:-1], 1.0)):
        idx, d2 = make_searcher(targets, "auto", gate)(far)
        assert int(idx[0]) >= 0 and np.isfinite(float(d2[0]))


def test_pallas_names_k5_and_refuses_cpu_tensors_before_building():
    """``backend="pallas"`` is the JAX package's name for K5: on CPU tensors
    it raises as ``"cuda"`` does, through ``nearest_neighbors`` and through
    a searcher, without building or launching anything."""
    q = torch.rand(10, 3)
    p = torch.rand(20, 3)
    before = k_nn.LAUNCHES
    for name in ("pallas", "cuda"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            nearest_neighbors(q, p, backend=name)
        with pytest.raises(ValueError, match="CUDA tensor"):
            make_searcher(p, name, None)(q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k_nn.nn_cuda(q, p)
    assert k_nn.LAUNCHES == before
    assert k_nn._launcher.cache_info().currsize == 0


# --- K5's order of work, emulated -------------------------------------------
#
# The CUDA kernel (csrc/nn_search.cu) runs only on the card. Its order of
# work, the one K6 follows (``emulate_order_of_work``), is emulated here in
# torch, on the CPU, over direct-difference d² and held bit for bit against
# the plain version.


def _k5_emulated(q, p, run, splits):
    """(idx, d²) as the kernel finds them: d² = (qx−px)² + (qy−py)² +
    (qz−pz)², each operation rounded in float32, in the kernel's order."""
    dx = q[:, None, 0] - p[None, :, 0]
    dy = q[:, None, 1] - p[None, :, 1]
    dz = q[:, None, 2] - p[None, :, 2]
    return emulate_order_of_work((dx * dx + dy * dy) + dz * dz, run, splits)


def _uniform(rng, n):
    return torch.as_tensor(rng.uniform(-10, 10, (n, 3)), dtype=torch.float32)


def _k5_case(name):
    """(query, points, rows whose result must be (0, +inf), target rows that
    must never be chosen)."""
    rng = np.random.default_rng(len(name))
    if name == "ragged":
        return _uniform(rng, 33), _uniform(rng, 77), [], []
    if name == "ties":  # every target three times; a split boundary at each copy for 3 splits
        base = _uniform(rng, 96)
        return base[::3].contiguous(), torch.cat([base, base, base]), [], []
    if name == "nan query rows":  # a whole row, and one coordinate
        q = _uniform(rng, 40)
        q[7] = torch.nan
        q[11, 1] = torch.nan
        return q, _uniform(rng, 90), [7, 11], []
    if name == "nan target rows":  # queries on top of the NaN targets' neighbours
        p = _uniform(rng, 90)
        p[5] = torch.nan
        p[40, 2] = torch.nan
        q = torch.cat([p[[4, 6, 39, 41]], _uniform(rng, 30)])
        return q, p, [], [5, 40]
    if name == "overflow rows":  # d² overflows to +inf on every pair of these rows
        q, p = _uniform(rng, 40), _uniform(rng, 90)
        q[3] = 1e20
        q[9, 0] = 3e19
        p[4] = -1e20
        p[60, 2] = -2e20
        return q, p, [3, 9], [4, 60]
    if name == "subnormal differences":  # products below float32's normal range
        a = torch.as_tensor(rng.uniform(-1, 1, (150, 3)) * 1e-20, dtype=torch.float32)
        a[::3, 0] = torch.as_tensor(rng.uniform(-1, 1, len(a[::3])), dtype=torch.float32)
        a[1::5] *= 1e-19  # subnormal coordinates and differences; their squares are 0
        return a[:60].contiguous(), a[40:].contiguous(), [], []
    raise KeyError(name)


K5_CASES = ["ragged", "ties", "nan query rows", "nan target rows", "overflow rows", "subnormal differences"]


@pytest.mark.parametrize("name", K5_CASES)
@pytest.mark.parametrize("run,splits", [(32, 1), (32, 3), (16, 7), (4, 2)])
def test_k5_order_of_work_is_bit_equal_to_the_plain_version(name, run, splits):
    q, p, inf_rows, never = _k5_case(name)
    want_idx, want_d2 = _nn_torch(q, p)
    idx, d2 = _k5_emulated(q, p, run=run, splits=splits)
    torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
    assert torch.equal(d2.view(torch.int32), want_d2.view(torch.int32))
    if name == "ties":
        assert bool((idx < p.shape[0] // 3).all())  # the first copy wins, across every split
    for row in inf_rows:
        assert int(idx[row]) == 0 and float(d2[row]) == np.inf
    assert not any(bool((idx == row).any()) for row in never)
    if name == "subnormal differences":
        assert bool((d2 == 0).any()) and bool(((d2 > 0) & (d2 < 2.0**-126)).any())


@pytest.mark.parametrize(
    "n_query,n_points,want",
    [
        (29_310, 29_310, 18),  # one fachada scan: 29 blocks, 522 with the splits
        (86, 768, 3),  # ties cut exactly at the copies: 3 ranges of 256
        (234, 2_100, 8),  # ties cut anywhere: 8 ranges of 263
        (33, 77, 1),  # too few targets to split
        (264 * K5_QUERIES_PER_BLOCK, 10_000, 1),  # two blocks an SM: no split
    ],
)
def test_k5_target_splits(n_query, n_points, want):
    """The ranges K5's wrapper cuts the targets into on a 132-SM H100, at
    K5's own queries a block."""
    n_blocks = -(-n_query // K5_QUERIES_PER_BLOCK)
    assert k_expand.n_splits(n_blocks, n_points, 132) == want
