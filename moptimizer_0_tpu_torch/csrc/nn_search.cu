// Exact brute-force nearest neighbour for Hopper (sm_90a).
//
// Replaces moptimizer_0_tpu/ops/nn_search.py::_nn_vpu_kernel (launcher
// _nn_pallas_vpu): for every query q, the index of and squared distance to its
// nearest target p, with d² = (qx−px)² + (qy−py)² + (qz−pz)² in float32 and
// the smallest index winning ties.
//
// Design. One thread per query, kThreads threads per block. The block streams
// the target cloud through shared memory in tiles of kTile points, stored there
// as SoA x/y/z in ascending index order. Every thread of the block reads the
// same target at the same time (a shared-memory broadcast, no bank conflict)
// and keeps its running (best_d2, best_idx) in registers, replacing it only on
// a strict `<`. Ascending order plus the strict compare makes the first index
// win ties, as the Pallas kernel's masked-iota min does; a later design that
// splits the targets across threads or blocks must merge preferring the
// smaller index on equal d². A NaN d² never compares `<`, so a NaN query ends
// as (0, +inf), as the Pallas running min does. The ragged last query block
// and the ragged last tile are masked by bounds; nothing is padded.
//
// d² is written with __fsub_rn/__fmul_rn/__fadd_rn. By default nvcc contracts
// dx*dx + dy*dy + dz*dz into FMAs, which round once where the plain PyTorch
// version (separate elementwise ops) rounds twice; near-ties would then pick
// other indices. With the intrinsics the two agree bit for bit.
//
// Bound: FP32 CUDA-core arithmetic, 8 flops plus one compare-select per pair
// (Q·M pairs), not bytes. At 29,310 points the target cloud is 352 KB, stays
// in L2, and each block reads it once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;  // 24 KB of shared memory per block

__global__ void __launch_bounds__(kThreads)
nn_bruteforce_kernel(const float* __restrict__ query, const float* __restrict__ points,
                     int n_query, int n_points, int* __restrict__ out_idx,
                     float* __restrict__ out_d2) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];

  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < n_query;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = query[3 * q + 0];
    qy = query[3 * q + 1];
    qz = query[3 * q + 2];
  }
  float best_d2 = __int_as_float(0x7f800000);  // +inf
  int best_idx = 0;

  for (int base = 0; base < n_points; base += kTile) {
    const int n = min(kTile, n_points - base);
    // coalesced load of the tile's 3·n floats, scattered into SoA
    const float* tile = points + 3 * static_cast<long long>(base);
    for (int f = threadIdx.x; f < 3 * n; f += kThreads) {
      const float v = tile[f];
      const int j = f / 3;
      const int c = f - 3 * j;
      if (c == 0) {
        sx[j] = v;
      } else if (c == 1) {
        sy[j] = v;
      } else {
        sz[j] = v;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float dx = __fsub_rn(qx, sx[j]);
      const float dy = __fsub_rn(qy, sy[j]);
      const float dz = __fsub_rn(qz, sz[j]);
      const float d2 =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (d2 < best_d2) {
        best_d2 = d2;
        best_idx = base + j;
      }
    }
    __syncthreads();
  }
  if (active) {
    out_idx[q] = best_idx;
    out_d2[q] = best_d2;
  }
}

}  // namespace

// query (n_query, 3) and points (n_points, 3): contiguous float32 on the device.
// out_idx (n_query,) int32 and out_d2 (n_query,) float32. Launches on `stream`
// and returns the cudaGetLastError() of the launch (0 on success).
extern "C" int nn_bruteforce_f32(const float* query, const float* points, int n_query,
                                 int n_points, int* out_idx, float* out_d2,
                                 cudaStream_t stream) {
  const int blocks = (n_query + kThreads - 1) / kThreads;
  nn_bruteforce_kernel<<<blocks, kThreads, 0, stream>>>(query, points, n_query, n_points,
                                                         out_idx, out_d2);
  return static_cast<int>(cudaGetLastError());
}
