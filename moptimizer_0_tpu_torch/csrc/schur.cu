// Schur-complement correction of the dense bundle-adjustment step, for Hopper (sm_90a).
//
// Replaces benchmarks/schur_pallas_ab.py::_syrk_kernel (launcher
// build_schur_pallas), which computes the same S_corr as the library's
// moptimizer_0_tpu/ba_dense.py::_build_schur:
//
//   S_corr = Σ_l A2_lᵀ A2_l,   A2_l[m, i·C + c] = Σ_k G[l,k,i,m] · mask[l,k] · 1[cam[l,k] = c]
//
// a (6C)² float32 matrix in the permuted component-major order: camera c's
// component i is row/column i·C + c. G (L, K, 6, 3) is W·L⁻ᵀ, the
// camera–landmark blocks folded with the landmark's inverse Cholesky factor.
//
// Form. The TPU kernel makes A2 dense (3L × 6C, almost all zeros) so that the
// matrix unit can stream it: 2·(6C)²·3L flops, 432 GFLOP at C = 200 and
// L = 50,000. Written per landmark, the same sum touches only pairs of the
// landmark's real slots: for every ordered pair (k, k′) of slots with a
// nonzero mask,
//
//   S_corr[i·C + cam_k, j·C + cam_k′] += mask_k·mask_k′ · Σ_m G[l,k,i,m]·G[l,k′,j,m]
//
// for all 36 (i, j). k = k′ is included, and so are two slots of one landmark
// that name the same camera: the one-hot fold sums those too. With Poisson(10)
// valence that is Σ_l K_l² ≈ 5.5 M pairs × 36 entries at the headline shape.
// A slot whose camera id lies outside [0, C) contributes nothing, as it does
// to the one-hot fold (an all-zero one-hot row).
//
// Design. One warp per landmark (grid-stride over landmarks). The warp walks
// the landmark's slots in windows of 32: a ballot over the mask compacts the
// real slots of a window into a per-warp list in shared memory, so masked
// slots cost no work and any K (segments of any width, hub landmarks with
// thousands of slots) is handled. For each real slot k of the outer window,
// the lanes split the (k′, i, j) items of the inner window; each item is a
// 3-term dot product of two rows of G (read through L1, the landmark's G is
// K·72 bytes) and one float atomicAdd into S_corr. Products are taken from
// the float32 inputs and summed in float32: no bf16 rounding, whatever the
// JAX package's schur_precision says.
//
// Bound. Not flops (≈ 1.2 G) but the ≈ 200 M atomic adds into S_corr, which
// at C = 200 is 5.76 MB and stays in the 50 MB L2: the kernel is bound by the
// L2's atomic throughput. The dense form's 432 GFLOP is what it avoids.
//
// Order. The atomics land in an order that changes from run to run, so S_corr
// is not bitwise repeatable: two runs differ by float32 summation-order
// roundoff, a few ulps of the largest partial sums of an entry (relative
// differences near 1e-6 of max|S_corr| at the headline shape). Callers compare
// with a tolerance, never bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// Compacts the real slots among [k0, k0 + 32) into `slots` (in ascending
// order) and returns how many there are. Called by all 32 lanes together.
__device__ __forceinline__ int compact_window(const int* __restrict__ cam,
                                              const float* __restrict__ mask, int k0, int K,
                                              int C, int lane, int* slots) {
  const int k = k0 + lane;
  bool real = false;
  if (k < K) {
    const int c = cam[k];
    real = mask[k] != 0.f && c >= 0 && c < C;
  }
  const unsigned bits = __ballot_sync(kFull, real);
  if (real) slots[__popc(bits & ((1u << lane) - 1u))] = k;
  __syncwarp();
  return __popc(bits);
}

__global__ void __launch_bounds__(kThreads)
schur_pairs_kernel(const float* __restrict__ G, const int* __restrict__ cam_ids,
                   const float* __restrict__ mask, int L, int K, int C,
                   float* __restrict__ S) {
  __shared__ int s_slots[kWarps][2][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* slots_a = s_slots[warp][0];
  int* slots_b = s_slots[warp][1];
  const long long n6C = 6LL * C;

  for (long long l = static_cast<long long>(blockIdx.x) * kWarps + warp; l < L;
       l += static_cast<long long>(gridDim.x) * kWarps) {
    const float* Gl = G + l * K * 18;
    const int* cam = cam_ids + l * K;
    const float* m = mask + l * K;
    for (int ka0 = 0; ka0 < K; ka0 += 32) {
      const int na = compact_window(cam, m, ka0, K, C, lane, slots_a);
      if (na == 0) continue;
      for (int kb0 = 0; kb0 < K; kb0 += 32) {
        const int nb = compact_window(cam, m, kb0, K, C, lane, slots_b);
        for (int a = 0; a < na; ++a) {
          const int ka = slots_a[a];
          const float* ga = Gl + ka * 18;
          const float wa = m[ka];
          float* S_rows = S + static_cast<long long>(cam[ka]) * n6C;
          for (int t = lane; t < nb * 36; t += 32) {
            const int b = t / 36;
            const int ij = t - 36 * b;
            const int i = ij / 6;
            const int j = ij - 6 * i;
            const int kb = slots_b[b];
            const float* gi = ga + 3 * i;
            const float* gj = Gl + kb * 18 + 3 * j;
            const float v = (gi[0] * gj[0] + gi[1] * gj[1] + gi[2] * gj[2]) * (wa * m[kb]);
            atomicAdd(S_rows + static_cast<long long>(i) * C * n6C + j * C + cam[kb], v);
          }
        }
        __syncwarp();  // every lane is done with slots_b before the next window
      }
      __syncwarp();  // and with slots_a
    }
  }
}

}  // namespace

// G (L, K, 6, 3), cam_ids (L, K) int32 and mask (L, K): contiguous, on the
// device. S_corr (6C, 6C) float32, zeroed by the caller; the kernel adds into
// it, so several segments can share one S_corr. Launches on `stream` and
// returns the cudaGetLastError() of the launch (0 on success).
extern "C" int schur_corr_f32(const float* G, const int* cam_ids, const float* mask, int L,
                              int K, int C, float* S_corr, cudaStream_t stream) {
  if (L <= 0 || K <= 0) return 0;
  const long long want = (static_cast<long long>(L) + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  schur_pairs_kernel<<<blocks, kThreads, 0, stream>>>(G, cam_ids, mask, L, K, C, S_corr);
  return static_cast<int>(cudaGetLastError());
}
