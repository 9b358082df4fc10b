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
// landmark's real slots (mask ≠ 0, camera id in [0, C)): the 6×6 block at
// (cam_k, cam_k′) is
//
//   B[i, j] = Σ over landmarks and slot pairs (k, k′) with those cameras of
//             mask_k·mask_k′ · Σ_m G[l,k,i,m]·G[l,k′,j,m]
//
// k = k′ included, and two slots of one landmark that name the same camera
// too: the one-hot fold sums those. A slot whose camera id lies outside
// [0, C) adds nothing, as it adds an all-zero one-hot row there.
//
// Design: a gather over a plan, no atomics. The camera ids and masks do not
// change during a solve; only G does, trial by trial. So the slot pairs are
// sorted once per solve by camera pair (ops/schur.py::pair_plan, tensor
// operations): a CSR list of entries (flat slot k, flat slot k′, weight) for
// each non-empty block (c, c′) with c ≤ c′; B(c′, c) is B(c, c′)ᵀ and is
// written from it. Here one warp takes one block: lane t sums the entries
// t, t + 32, … of the block, each the 36 products of two rows of G (72 bytes
// each, read through L1; G is 36 MB at the headline shape and stays in the
// 50 MB L2), in 36 registers; a fixed butterfly of shuffles sums the 32
// lanes; the block is written once, and once more transposed when c < c′.
// Blocks are taken in the plan's order, the longest first (the diagonal
// blocks hold a camera's every observation). Every sum has a fixed order, so
// S_corr is the same bit for bit from run to run. All segments share one
// flat G and one plan, so an S build is one launch.
//
// Bound. ≈ 3.0 M entries at the headline shape (of the 5.5 M ordered slot
// pairs, those with cam_k ≤ cam_k′), 216 flops each: 0.65 GFLOP, 10 µs at
// 67 TFLOP/s; the bytes the function needs (G, the camera ids and the masks
// read once, S_corr written once) ≈ 53 MB, 16 µs at 3.35 TB/s. The plan's
// 36 MB are this design's own reads on top. What the kernel meets first is
// the latency of its L2 reads: each entry reads 144 bytes from two rows of G
// at places the plan decides.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// The 18 floats of flat slot `slot` of G (72 bytes: 8-byte aligned).
__device__ __forceinline__ void load_slot(const float* __restrict__ G, int slot, float (&g)[18]) {
  const float2* p = reinterpret_cast<const float2*>(G + 18LL * slot);
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const float2 v = __ldg(p + t);
    g[2 * t] = v.x;
    g[2 * t + 1] = v.y;
  }
}

__global__ void __launch_bounds__(kThreads)
schur_gather_kernel(const float* __restrict__ G, const int2* __restrict__ pairs,
                    const float* __restrict__ weight, const int* __restrict__ block_ptr,
                    const int2* __restrict__ block_cam, const int* __restrict__ order,
                    int n_blocks, int C, float* __restrict__ S) {
  const int lane = threadIdx.x & 31;
  const long long n6C = 6LL * C;
  for (long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       w < n_blocks; w += static_cast<long long>(gridDim.x) * kWarps) {
    const int blk = order[w];
    const int e1 = block_ptr[blk + 1];
    float acc[36];
#pragma unroll
    for (int t = 0; t < 36; ++t) acc[t] = 0.f;
    for (int e = block_ptr[blk] + lane; e < e1; e += 32) {
      const int2 ab = pairs[e];
      const float wt = weight[e];
      float a[18], b[18];
      load_slot(G, ab.x, a);
      load_slot(G, ab.y, b);
#pragma unroll
      for (int t = 0; t < 18; ++t) a[t] *= wt;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          float s = acc[6 * i + j];
          s = fmaf(a[3 * i + 0], b[3 * j + 0], s);
          s = fmaf(a[3 * i + 1], b[3 * j + 1], s);
          acc[6 * i + j] = fmaf(a[3 * i + 2], b[3 * j + 2], s);
        }
      }
    }
    // every lane ends with the same sums: x + y and y + x round alike
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int t = 0; t < 36; ++t) acc[t] += __shfl_xor_sync(kFull, acc[t], off);
    }
    const int2 cc = block_cam[blk];
#pragma unroll
    for (int t = 0; t < 36; ++t) {
      if (t % 32 != lane) continue;
      const int i = t / 6;
      const int j = t % 6;
      S[(i * static_cast<long long>(C) + cc.x) * n6C + j * C + cc.y] = acc[t];
      if (cc.x != cc.y) S[(j * static_cast<long long>(C) + cc.y) * n6C + i * C + cc.x] = acc[t];
    }
  }
}

}  // namespace

// G (n_slots, 6, 3) float32; the plan's pairs (E, 2) int32, weight (E,)
// float32, block_ptr (n_blocks + 1,) int32, block_cam (n_blocks, 2) int32 and
// order (n_blocks,) int32 (ops/schur.py::PairPlan): contiguous, on the
// device. S_corr (6C, 6C) float32, zeroed by the caller; the kernel writes
// every entry of each non-empty block once. Launches on `stream` and returns
// the cudaGetLastError() of the launch (0 on success).
extern "C" int schur_corr_f32(const float* G, const int* pairs, const float* weight,
                              const int* block_ptr, const int* block_cam, const int* order,
                              int n_blocks, int C, float* S_corr, cudaStream_t stream) {
  if (n_blocks <= 0) return 0;
  const long long want = (static_cast<long long>(n_blocks) + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  schur_gather_kernel<<<blocks, kThreads, 0, stream>>>(
      G, reinterpret_cast<const int2*>(pairs), weight, block_ptr,
      reinterpret_cast<const int2*>(block_cam), order, n_blocks, C, S_corr);
  return static_cast<int>(cudaGetLastError());
}
