// Lane-batched nearest neighbour by the distance expansion, for Hopper (sm_90a).
//
// Replaces moptimizer_0_tpu/ops/nn_search.py::_nn_kernel (nn_search.py:43,
// launcher _nn_pallas at :87): for every query q of lane b, the index of and
// squared distance to its nearest target p among lane b's targets, with
//
//   d² = (qn − 2·cross) + pn,   qn = (qx·qx + qy·qy) + qz·qz,
//   cross = (qx·px + qy·py) + qz·pz,   pn = (px·px + py·py) + pz·pz
//
// in float32, the smallest index winning ties. The TPU kernel takes the cross
// term as a HIGHEST-precision matrix product on the MXU; there is no float32
// path through Hopper's tensor cores (TF32 would mis-rank neighbours), so here
// it is CUDA-core arithmetic.
//
// Design. The pattern of nn_search.cu (K5). Grid (⌈Q/128⌉, B): one thread per
// query, one row of blocks per lane. The block streams its lane's targets
// through shared memory in tiles of kTile points, stored as float4
// (x, y, z, pn) in ascending index order, so that one 16-byte broadcast load
// serves a pair; pn is computed once per target at tile load, qn once per
// query in registers. The running (best_d2, best_idx) stays in registers and
// is replaced only on a strict `<`, so the first index wins ties, as the Pallas
// kernel's masked-iota min does, and a NaN d² never wins: a NaN query ends as
// (0, +inf). The ragged last query block and last tile are masked by bounds;
// nothing is padded. Lane offsets are 64-bit.
//
// Every operation is written with __fmul_rn/__fadd_rn/__fsub_rn in the order
// above. nvcc would otherwise contract products and sums into FMAs, which round
// once where the plain PyTorch version (ops/nn_search.py::_nn_expand_torch,
// separate elementwise ops) rounds twice; with the intrinsics the two agree bit
// for bit. d² is not clamped at 0: near a match the expansion can be slightly
// negative, as it is in the JAX package.
//
// Bound: FP32 CUDA-core arithmetic, 8 flops (and a compare-select) per pair:
// B·Q·M pairs. One fachada lane (29,310²) is 859 M pairs, 6.9 GFLOP, 0.10 ms
// at 67 TFLOP/s; the 64-lane fleet search is 55.0 G pairs, 440 GFLOP, 6.6 ms.
// The bytes do not matter: each lane's targets (352 KB at 29,310 points) are
// read once per block from L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;  // 32 KB of shared memory per block

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kThreads)
nn_expand_kernel(const float* __restrict__ query, const float* __restrict__ points,
                 int n_query, int n_points, int* __restrict__ out_idx,
                 float* __restrict__ out_d2) {
  __shared__ float4 tile[kTile];

  const long long lane = blockIdx.y;
  const float* q_lane = query + lane * 3LL * n_query;
  const float* p_lane = points + lane * 3LL * n_points;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < n_query;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q_lane[3LL * q + 0];
    qy = q_lane[3LL * q + 1];
    qz = q_lane[3LL * q + 2];
  }
  const float qn = sq_norm(qx, qy, qz);
  float best_d2 = __int_as_float(0x7f800000);  // +inf
  int best_idx = 0;

  for (int base = 0; base < n_points; base += kTile) {
    const int n = min(kTile, n_points - base);
    const float* src = p_lane + 3LL * base;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float px = src[3 * j + 0];
      const float py = src[3 * j + 1];
      const float pz = src[3 * j + 2];
      tile[j] = make_float4(px, py, pz, sq_norm(px, py, pz));
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float4 p = tile[j];
      const float cross =
          __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)), __fmul_rn(qz, p.z));
      const float d2 = __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, cross)), p.w);
      if (d2 < best_d2) {
        best_d2 = d2;
        best_idx = base + j;
      }
    }
    __syncthreads();
  }
  if (active) {
    out_idx[lane * n_query + q] = best_idx;
    out_d2[lane * n_query + q] = best_d2;
  }
}

}  // namespace

// query (n_lanes, n_query, 3) and points (n_lanes, n_points, 3): contiguous
// float32 on the device. out_idx (n_lanes, n_query) int32 and out_d2
// (n_lanes, n_query) float32. Launches on `stream` and returns the
// cudaGetLastError() of the launch (0 on success).
extern "C" int nn_expand_f32(const float* query, const float* points, int n_lanes, int n_query,
                             int n_points, int* out_idx, float* out_d2, cudaStream_t stream) {
  const dim3 grid((n_query + kThreads - 1) / kThreads, n_lanes);
  nn_expand_kernel<<<grid, kThreads, 0, stream>>>(query, points, n_query, n_points, out_idx,
                                                  out_d2);
  return static_cast<int>(cudaGetLastError());
}
