"""The port's explicit Schur complement (``ops/schur.py``) against the JAX package.

K11 (``benchmarks/schur_pallas_ab.py::build_schur_pallas``) has no interpret
mode, so the oracle of the S build is the library function it stands in
for, ``moptimizer_0_tpu.ba_dense._build_schur``, which computes the same S
in float64 at "highest" precision. Both sides get the same U′, L⁻¹ and W:
numpy copies of one linearization by the port. Tolerances and why:

* S against the JAX package: 1e-12 of max|S|. The same float64 products,
  summed by a one-hot matmul there and by a scatter and a matmul here;
* the pair form — what ``csrc/schur.cu`` computes, slot pair by slot pair —
  written in numpy, against the plain version: 1e-12 of max|S_corr|, for the
  same reason;
* the gauge rows and columns of fixed cameras: exactly identity.

The kernel itself runs on the card only; ``chip_smoke.py`` holds it to the
plain version there. Here its wrapper must refuse CPU tensors before it
builds anything, and ``"auto"`` must never reach it.
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
    with pytest.raises(ValueError, match="CUDA tensor"):
        k_schur.schur_corr_cuda(_cpu_segments(dtype), 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        schur.schur_correction(_cpu_segments(dtype), 3, backend="cuda")
    with pytest.raises(ValueError, match="C <"):
        k_schur.schur_corr_cuda(_cpu_segments(dtype), 0)
    with pytest.raises(ValueError, match="no segments"):
        k_schur.schur_corr_cuda([], 3)
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
