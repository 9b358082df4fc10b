"""The port's explicit Schur complement (``ops/schur.py``) against the JAX package.

K11 (``benchmarks/schur_pallas_ab.py::build_schur_pallas``) has no interpret
mode, so the oracle of the S build is the library function it stands in
for, ``moptimizer_0_tpu.ba_dense._build_schur``, which computes the same S
in float64 at "highest" precision. Both sides get the same U′, L⁻¹ and W:
numpy copies of one linearization by the port. Tolerances and why:

* S against the JAX package: 1e-12 of max|S|. The same float64 products,
  summed by a one-hot matmul there and by a scatter and a matmul here;
* the pair form — the sum over slot pairs that ``csrc/schur.cu`` gathers —
  written in numpy, and the plain gather over the kernel's plan
  (``_schur_corr_pairs_torch``), against the plain version and against the
  JAX package's S_corr: 1e-12 of max|S_corr|, for the same reason;
* the plan (``pair_plan``) against a plain enumeration of the slot pairs:
  exactly equal;
* the gauge rows and columns of fixed cameras: exactly identity.

The kernel itself runs on the card only; ``chip_smoke.py`` holds it to the
plain versions there, and two of its builds to each other bit for bit. Here
its wrapper must refuse CPU tensors before it builds anything, and
``"auto"`` must never reach it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moptimizer_0_tpu import ba_dense as jbd
from moptimizer_0_tpu_torch import ba
from moptimizer_0_tpu_torch import ba_dense as tbd
from moptimizer_0_tpu_torch.kernels import build
from moptimizer_0_tpu_torch.kernels import schur as k_schur
from moptimizer_0_tpu_torch.ops import schur

from test_torch_ba_dense import jax_grouped, jax_problem, port

_j_build_schur = jax.jit(
    functools.partial(jbd._build_schur, precision="highest"), static_argnames=("chunk",)
)


def _schur_inputs(tprob, tg, lam=1e-3):
    """(U′, L⁻¹, W_segs, fixed_mask) of one damped solve at the start."""
    U, V, W, _, _, _ = tbd._linearize_and_blocks(
        tprob.camera_params, tg.sort_points(tprob.points), tprob.intrinsics, tg, None
    )
    lam = torch.tensor(lam, dtype=torch.float64)
    U_d = ba._damp_blocks(U, lam)
    V_d = ba._damp_blocks(V, lam) + 1e-12 * torch.eye(3, dtype=torch.float64)
    Linv = tbd._tri_inv_lower(tbd._chol3x3(V_d))
    C = U.shape[0]
    fixed = (torch.arange(C) >= tprob.n_fixed_cameras).to(torch.float64)
    return U_d, Linv, W, fixed


@pytest.mark.parametrize(
    "name,segments,chunk",
    [
        ("duplicates", 1, 7),  # a camera that sees one landmark twice; panels of 7
        ("uneven", 1, 4),  # valence 1..6, two fixed cameras
        ("bench", "auto", 64),  # four segments
        ("unobserved", 2, 512),  # a zero-width last segment
    ],
)
def test_build_schur_matches_jax(name, segments, chunk):
    jprob = jax_problem(name)
    tprob = port(jprob)
    jg, tg = jax_grouped(name, segments), tbd.group_by_landmark(tprob, segments=segments)
    U_d, Linv, W, fixed = _schur_inputs(tprob, tg)
    S_t = tbd._build_schur(U_d, Linv, W, tg, fixed, chunk=chunk, backend="torch")
    S_j = np.asarray(
        _j_build_schur(
            jnp.asarray(U_d.numpy()), jnp.asarray(Linv.numpy()), [jnp.asarray(w.numpy()) for w in W],
            jg, jnp.asarray(fixed.numpy()), chunk=512,
        )
    )
    C = U_d.shape[0]
    assert S_t.shape == S_j.shape == (6 * C, 6 * C) and S_t.dtype == torch.float64
    S_t = S_t.numpy()
    np.testing.assert_allclose(S_t, S_j, rtol=0, atol=1e-12 * np.abs(S_j).max())
    np.testing.assert_array_equal(S_t, S_t.T)
    # "auto" on CPU tensors is the plain version, to the bit
    S_auto = tbd._build_schur(U_d, Linv, W, tg, fixed, chunk=chunk, backend="auto")
    np.testing.assert_array_equal(S_auto.numpy(), S_t)
    # fixed camera c owns rows and columns i·C + c: identity there
    n_fixed = tprob.n_fixed_cameras
    gauge = (np.arange(6)[:, None] * C + np.arange(n_fixed)[None, :]).reshape(-1)
    np.testing.assert_array_equal(S_t[gauge], np.eye(6 * C)[gauge])
    np.testing.assert_array_equal(S_t[:, gauge], np.eye(6 * C)[:, gauge])


def _pair_form(segments, C):
    """The sum of ``csrc/schur.cu`` written out in numpy: for every landmark
    and every ordered pair (k, k′) of its real slots, the 6×6 block
    Σ_m G[k,i,m]·G[k′,j,m] at rows i·C + cam_k, columns j·C + cam_k′."""
    S = np.zeros((6 * C, 6 * C))
    i6 = np.arange(6) * C
    for G, cam, mask in segments:
        G, cam, mask = G.numpy(), cam.numpy(), mask.numpy()
        for l in range(cam.shape[0]):
            real = [k for k in range(cam.shape[1]) if mask[l, k] != 0 and 0 <= cam[l, k] < C]
            for ka in real:
                for kb in real:
                    blk = mask[l, ka] * mask[l, kb] * (G[l, ka] @ G[l, kb].T)
                    S[np.ix_(i6 + cam[l, ka], i6 + cam[l, kb])] += blk
    return S


def _random_segment(rng, C, L, K, keep=0.6, dtype=torch.float64):
    G = torch.as_tensor(rng.normal(size=(L, K, 6, 3)), dtype=dtype)
    cam = torch.as_tensor(rng.integers(0, C, (L, K)), dtype=torch.int32)
    mask = torch.as_tensor(rng.random((L, K)) < keep, dtype=dtype)
    return G, cam, mask


@pytest.mark.parametrize(
    "C,shapes",
    [
        (5, [(37, 9)]),  # K > C: every landmark names some camera twice
        (7, [(23, 70)]),  # slot windows past the kernel's 32
        (4, [(11, 6), (13, 3), (5, 0)]),  # segments, the last of width 0
    ],
)
def test_pair_form_equals_plain_version(C, shapes):
    rng = np.random.default_rng(C)
    segments = [_random_segment(rng, C, L, K) for L, K in shapes]
    G, cam, mask = segments[0]
    mask[2] = 0  # a landmark with no real slot
    cam[4, 1] = -1  # camera ids outside [0, C) add nothing, as in the one-hot fold
    cam[5, 2] = C
    want = _pair_form(segments, C)
    for chunk in (4, 512):
        got = schur._schur_corr_torch(segments, C, chunk=chunk).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    auto = schur.schur_correction(segments, C, backend="auto", chunk=4).numpy()
    np.testing.assert_array_equal(auto, schur._schur_corr_torch(segments, C, chunk=4).numpy())


def test_fold_linv_is_w_times_linv_transposed():
    rng = np.random.default_rng(9)
    W = torch.as_tensor(rng.normal(size=(8, 5, 6, 3)))
    Linv = torch.as_tensor(rng.normal(size=(8, 3, 3)))
    want = np.einsum("lkim,ljm->lkij", W.numpy(), Linv.numpy())
    np.testing.assert_allclose(schur.fold_linv(W, Linv).numpy(), want, rtol=1e-14, atol=1e-14)


def _cpu_segments(dtype=torch.float32):
    return [_random_segment(np.random.default_rng(0), 3, 4, 5, dtype=dtype)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_schur_kernel_refuses_cpu_tensors_without_building(dtype):
    """No card here: the wrapper refuses before it builds or launches."""
    before = k_schur.LAUNCHES
    segs = _cpu_segments(dtype)
    plan = schur.pair_plan([(cam, mask) for _, cam, mask in segs], 3)
    G = segs[0][0].reshape(-1, 6, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k_schur.schur_corr_cuda(plan, G)
    with pytest.raises(ValueError, match="CUDA tensor"):
        schur.schur_correction(segs, 3, backend="cuda", plan=plan, G=G)
    with pytest.raises(ValueError, match="pair_plan and flat G"):
        schur.schur_correction(segs, 3, backend="cuda")
    with pytest.raises(ValueError, match="C <"):
        schur.pair_plan([(cam, mask) for _, cam, mask in segs], 0)
    with pytest.raises(ValueError, match="no segments"):
        schur.pair_plan([], 3)
    assert k_schur.LAUNCHES == before
    assert k_schur._launcher.cache_info().currsize == 0


def test_auto_schur_backend_on_cpu_never_reaches_the_kernel():
    before = k_schur.LAUNCHES
    tprob = port(jax_problem("uneven"))
    res = tbd.solve_ba_dense(tprob, tbd.DenseBAConfig(max_iterations=2), schur_backend="auto")
    assert int(res.trace["trials"].sum()) >= 2
    assert k_schur.LAUNCHES == before
    assert k_schur._launcher.cache_info().currsize == 0
    with pytest.raises(ValueError, match="unknown Schur backend"):
        tbd.solve_ba_dense(tprob, tbd.DenseBAConfig(max_iterations=1), schur_backend="pallas")


def test_schur_library_name_is_keyed_by_source_hash():
    path = build.library_path(k_schur.NAME, k_schur.SOURCES)
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libschur-") and path.suffix == ".so"
    assert (build.CSRC_DIR / "schur.cu").is_file()


# --- the kernel's plan and its plain gather ----------------------------------


def _plan_case(name):
    """(segments, C) of the plan cases, float64."""
    rng = np.random.default_rng(len(name))
    if name == "duplicates":  # K > C: every landmark names some camera twice
        C, shapes = 5, [(37, 9)]
    elif name == "wide":  # K > 32
        C, shapes = 7, [(23, 70)]
    elif name == "segments":  # the last segment has width 0
        C, shapes = 4, [(11, 6), (13, 3), (5, 0)]
    else:  # one camera: every pair lands in one block
        C, shapes = 1, [(6, 4)]
    segments = [_random_segment(rng, C, L, K) for L, K in shapes]
    _, cam, mask = segments[0]
    mask[2] = 0  # a landmark with no real slot
    cam[4, 1] = -1  # camera ids outside [0, C) add nothing
    cam[5, 2] = C
    return segments, C


def _enumerated_plan(segments, C):
    """The plan's entries by brute force: (cam_k, cam_k′, landmark, flat k,
    flat k′, weight) for every ordered pair of real slots of a landmark with
    cam_k ≤ cam_k′, sorted by camera pair and then in (landmark, k, k′) order."""
    rows, off, land = [], 0, 0
    for _, cam, mask in segments:
        cam, mask = cam.numpy(), mask.numpy()
        L, K = cam.shape
        for l in range(L):
            real = [k for k in range(K) if mask[l, k] != 0 and 0 <= cam[l, k] < C]
            for ka in real:
                for kb in real:
                    if cam[l, ka] <= cam[l, kb]:
                        rows.append((cam[l, ka], cam[l, kb], land + l, off + l * K + ka,
                                     off + l * K + kb, mask[l, ka] * mask[l, kb]))
        off += L * K
        land += L
    return sorted(rows, key=lambda r: r[:5])


@pytest.mark.parametrize("name", ["duplicates", "wide", "segments", "one camera"])
def test_pair_plan_invariants(name):
    segments, C = _plan_case(name)
    plan = schur.pair_plan([(cam, mask) for _, cam, mask in segments], C)
    want = _enumerated_plan(segments, C)
    # the entries, their order and their weights, exactly
    pairs = plan.pairs.numpy()
    np.testing.assert_array_equal(pairs, np.array([r[3:5] for r in want]).reshape(-1, 2))
    np.testing.assert_array_equal(plan.weight.numpy(), np.array([r[5] for r in want]))
    # the count: of the Σ_l K_l² ordered pairs of real slots, the pairs with
    # one camera both ways and one way of each other pair
    n_ordered = n_same = 0
    for _, cam, mask in segments:
        real = (mask != 0) & (cam >= 0) & (cam < C)
        n_ordered += int((real.sum(1) ** 2).sum())
        per_cam = torch.stack([(real & (cam == c)).sum(1) for c in range(C)], 1)
        n_same += int((per_cam**2).sum())
    assert pairs.shape[0] == (n_ordered + n_same) // 2
    # blocks: CSR over the sorted keys, c ≤ c′, every entry's cameras its block's
    ptr = plan.block_ptr.numpy()
    cams = plan.block_cam.numpy()
    assert ptr[0] == 0 and ptr[-1] == len(want) and (np.diff(ptr) > 0).all()
    keys = cams[:, 0] * C + cams[:, 1]
    assert (np.diff(keys) > 0).all() and (cams[:, 0] <= cams[:, 1]).all()
    for p in range(len(cams)):
        for r in want[ptr[p] : ptr[p + 1]]:
            assert (r[0], r[1]) == tuple(cams[p])
    # the schedule: every block once, the longest first
    order = plan.order.numpy()
    assert sorted(order.tolist()) == list(range(len(cams)))
    assert (np.diff(np.diff(ptr)[order]) <= 0).all()
    # the flat slot layout
    n_slots = sum(cam.numel() for _, cam, _ in segments)
    assert plan.n_slots == n_slots
    assert plan.nbytes == sum(t.numel() * t.element_size() for t in (
        plan.pairs, plan.weight, plan.block_ptr, plan.block_cam, plan.order))


def test_pair_plan_of_no_real_slot_is_empty():
    cam = torch.zeros((3, 4), dtype=torch.int32)
    plan = schur.pair_plan([(cam, torch.zeros((3, 4))), (cam[:0], torch.zeros((0, 4)))], 2)
    assert plan.pairs.shape == (0, 2) and plan.block_cam.shape == (0, 2)
    assert plan.block_ptr.tolist() == [0]
    G = torch.zeros((plan.n_slots, 6, 3), dtype=torch.float64)
    assert not schur._schur_corr_pairs_torch(plan, G).any()


@pytest.mark.parametrize("name", ["duplicates", "wide", "segments", "one camera"])
@pytest.mark.parametrize("chunk", [5, 1 << 16])
def test_pair_gather_equals_plain_version(name, chunk):
    segments, C = _plan_case(name)
    plan = schur.pair_plan([(cam, mask) for _, cam, mask in segments], C)
    G = torch.cat([G_s.reshape(-1, 6, 3) for G_s, _, _ in segments])
    got = schur._schur_corr_pairs_torch(plan, G, chunk=chunk).numpy()
    want = schur._schur_corr_torch(segments, C).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(got, _pair_form(segments, C), rtol=0, atol=1e-12 * np.abs(want).max())
    # blocks of two cameras are written once and mirrored: exact transposes
    cam_of = np.arange(6 * C) % C
    other = cam_of[:, None] != cam_of[None, :]
    np.testing.assert_array_equal(got[other], got.T[other])


@pytest.mark.parametrize(
    "name,segments",
    [("duplicates", 1), ("uneven", 1), ("bench", "auto"), ("unobserved", 2)],
)
def test_pair_gather_matches_jax_s_corr(name, segments):
    """The plain gather over the cached plan of the port's layout against
    the JAX package's S_corr: its _build_schur with U′ = 0 and no fixed
    camera is −S_corr."""
    jprob = jax_problem(name)
    tprob = port(jprob)
    jg, tg = jax_grouped(name, segments), tbd.group_by_landmark(tprob, segments=segments)
    U_d, Linv, W, _ = _schur_inputs(tprob, tg)
    C = U_d.shape[0]
    plan = tg.schur_plan(C)
    assert tg.schur_plan(C) is plan  # built once per layout
    G, segs = schur.fold_segments(W, Linv, tg.views)
    got = schur._schur_corr_pairs_torch(plan, G).numpy()
    S_j = -np.asarray(
        _j_build_schur(
            jnp.zeros((C, 6, 6)), jnp.asarray(Linv.numpy()), [jnp.asarray(w.numpy()) for w in W],
            jg, jnp.ones(C), chunk=512,
        )
    )
    tol = 1e-12 * np.abs(S_j).max()
    np.testing.assert_allclose(got, S_j, rtol=0, atol=tol)
    np.testing.assert_allclose(got, schur._schur_corr_torch(segs, C).numpy(), rtol=0, atol=tol)


def test_fold_segments_writes_one_flat_buffer():
    rng = np.random.default_rng(5)
    shapes = [(4, 3), (6, 2), (2, 0)]
    views, W_segs, s = [], [], 0
    for L, K in shapes:
        cam = torch.as_tensor(rng.integers(0, 3, (L, K)), dtype=torch.int32)
        views.append((slice(s, s + L), tbd.GroupedBA(pixels=torch.zeros((L, K, 2)), cam_ids=cam,
                                                     mask=torch.ones((L, K)))))
        W_segs.append(torch.as_tensor(rng.normal(size=(L, K, 6, 3))))
        s += L
    Linv = torch.as_tensor(rng.normal(size=(s, 3, 3)))
    G, segs = schur.fold_segments(W_segs, Linv, views)
    assert G.shape == (4 * 3 + 6 * 2, 6, 3)
    off = 0
    for (sl, view), W_s, (G_s, cam, mask) in zip(views, W_segs, segs):
        n = view.cam_ids.numel()
        assert G_s.data_ptr() == G[off:].data_ptr() or n == 0
        torch.testing.assert_close(G_s, schur.fold_linv(W_s, Linv[sl]), rtol=0, atol=0)
        assert cam is view.cam_ids and mask is view.mask
        off += n
