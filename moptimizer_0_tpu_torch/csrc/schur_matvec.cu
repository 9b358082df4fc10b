// The two halves of the CG engine's matrix-free Schur matvec, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's CG engine (moptimizer_0_tpu/ba.py,
// _schur_matvec) leaves both halves to XLA's gathers, products and segment
// sums, and so did the port (moptimizer_0_tpu_torch/ba.py, _to_landmarks and
// _to_cameras over ops/segment_sum.py), in some fifteen passes over the O
// observations a matvec. Here each half is one pass over its observations:
//
//   to landmarks:  t_l = Σ_{o∈l} W_oᵀ u[cam_o]   (L, 3)
//   to cameras:    y_c = Σ_{o∈c} W_o s[pt_o]     (C, 6)
//
// W (O, 6, 3) float32 holds the observations' camera–landmark blocks in
// observation order, as the linearization writes them, and W_cam the same
// rows in the plan's camera order (the linearization writes both); u (C, 6)
// and s (L, 3).
//
// Order. Both walk a CSR of the observations built once per layout
// (kernels/schur_matvec.py::matvec_plan): items sorted stably by landmark or
// by camera. No atomics: every sum has one order, fixed by the plan alone, so
// two calls, a CUDA-graph replay and its eager body, and every card agree bit
// for bit.
//
// To landmarks: a group of G lanes (G a power of two, from the plan: about
// twice the mean track length, at most 16) takes one landmark, so that most
// landmarks take one round; lane j sums items j, j + G, …
// of its landmark (each item 6 FMAs into each of 3 sums, over i = 0..5), then
// a butterfly of shuffles sums the G lanes. A warp walks runs of 32 / G
// landmarks across the grid. u (C, 6) sits in shared memory when it fits in
// 48 KB (C ≤ 2,048), else it is read through L1. Tracks of any length, and
// empty landmarks (t = 0), take the same path.
//
// To cameras: a camera holds thousands of items (2,813 on average at the
// Venice shape) and the count varies along a trajectory, so a camera's items
// are cut into tiles of T items (T from the plan, a multiple of 32) and one
// warp takes one tile: lane j sums items j, j + 32, … of its tile (each item
// 3 FMAs into each of 6 sums, over m = 0..2), a butterfly sums the 32 lanes,
// and the tile's partial (6 floats) is written. A second, small launch sums
// each camera's partials in tile order (0 for a camera with no item). It
// reads W_cam, whose rows come in the tiles' order: read through the CSR from
// W instead, where a camera's rows lie scattered (72 B each, three 32-byte
// sectors), the tiles took 1.85x as long at the Venice shape (PERF.md).
// Staging each warp's rows in shared memory by consecutive 8-byte loads
// before the sums made neither half faster there.
//
// Bound. A matvec reads W and W_cam (2 × 72 B × O = 720 MB at the Venice
// shape), the plan's int32 indices (3 × 4 B × O = 60 MB) and u and s, and
// writes t and y: ~0.79 GB, 0.24 ms at 3.35 TB/s. To landmarks reads W in
// plan order, which is observation order where the observations come in
// landmark order (the benchmark's generator, BAL files); to cameras reads
// W_cam in turn and s (12 MB) from L2. Each lane loads its W row as nine
// 8-byte loads.
//
// Counting. A captured launch adds one to *count (an int64 on the card) from
// one thread, so a replay counts the launches its IF nodes ran; count is null
// for an eager launch, which the binding counts on the host.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLandmarkThreads = 512;
constexpr int kTileThreads = 256;
constexpr int kCombineThreads = 256;
// u in shared memory up to this many bytes (the static limit a block has
// without opting in): C ≤ 2,048 cameras
constexpr int kSharedUBytes = 48 * 1024;

// The 18 floats of W's row `row` (72 bytes: 8-byte aligned).
__device__ __forceinline__ void load_row(const float* __restrict__ W, int row, float (&w)[18]) {
  const float2* p = reinterpret_cast<const float2*>(W + 18LL * row);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float2 v = __ldg(p + k);
    w[2 * k] = v.x;
    w[2 * k + 1] = v.y;
  }
}

template <bool kSharedU>
__global__ void __launch_bounds__(kLandmarkThreads)
to_landmarks_kernel(const float* __restrict__ W, const float* __restrict__ u, const int* __restrict__ lm_ptr,
                    const int* __restrict__ lm_rows, const int* __restrict__ lm_cam, int L, int C,
                    int group_log2, float* __restrict__ t, long long* count) {
  extern __shared__ float u_shared[];
  if (kSharedU) {
    for (int k = threadIdx.x; k < 6 * C; k += blockDim.x) u_shared[k] = u[k];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int G = 1 << group_log2;
  const int j = lane & (G - 1);
  const long long per_warp = 32 >> group_log2;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long stride = ((static_cast<long long>(gridDim.x) * blockDim.x) >> 5) * per_warp;
  // warp-uniform: every lane reaches the shuffles
  for (long long base = warp * per_warp; base < L; base += stride) {
    const long long l = base + (lane >> group_log2);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    if (l < L) {
      const int k1 = lm_ptr[l + 1];
      for (int k = lm_ptr[l] + j; k < k1; k += G) {
        float w[18];
        load_row(W, lm_rows[k], w);
        const int c6 = 6 * lm_cam[k];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float ui = kSharedU ? u_shared[c6 + i] : __ldg(u + c6 + i);
          a0 = fmaf(w[3 * i + 0], ui, a0);
          a1 = fmaf(w[3 * i + 1], ui, a1);
          a2 = fmaf(w[3 * i + 2], ui, a2);
        }
      }
    }
    // the group's lanes end with the same sums: x + y and y + x round alike
    for (int off = G >> 1; off > 0; off >>= 1) {
      a0 += __shfl_xor_sync(kFull, a0, off);
      a1 += __shfl_xor_sync(kFull, a1, off);
      a2 += __shfl_xor_sync(kFull, a2, off);
    }
    if (l < L && j == 0) {
      t[3 * l + 0] = a0;
      t[3 * l + 1] = a1;
      t[3 * l + 2] = a2;
    }
  }
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *count += 1;
}

__global__ void __launch_bounds__(kTileThreads)
camera_tiles_kernel(const float* __restrict__ W_cam, const float* __restrict__ s,
                    const int* __restrict__ tile_ptr, const int* __restrict__ cam_pt, int n_tiles,
                    float* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const long long tile = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (tile >= n_tiles) return;  // a whole warp
  float acc[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[i] = 0.f;
  const int k1 = tile_ptr[tile + 1];
  for (int k = tile_ptr[tile] + lane; k < k1; k += 32) {
    float w[18];
    load_row(W_cam, k, w);
    const float* sp = s + 3LL * cam_pt[k];
    const float s0 = __ldg(sp), s1 = __ldg(sp + 1), s2 = __ldg(sp + 2);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float a = fmaf(w[3 * i + 0], s0, acc[i]);
      a = fmaf(w[3 * i + 1], s1, a);
      acc[i] = fmaf(w[3 * i + 2], s2, a);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], off);
  }
  float v = acc[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) v = lane == i ? acc[i] : v;
  if (lane < 6) partial[6 * tile + lane] = v;
}

__global__ void __launch_bounds__(kCombineThreads)
camera_combine_kernel(const float* __restrict__ partial, const int* __restrict__ cam_tiles, int C,
                      float* __restrict__ y, long long* count) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;  // 6·c + i
  if (k < 6LL * C) {
    const long long c = k / 6;
    const int i = static_cast<int>(k % 6);
    float a = 0.f;
    const int t1 = cam_tiles[c + 1];
    for (int t = cam_tiles[c]; t < t1; ++t) a += partial[6LL * t + i];
    y[k] = a;
  }
  if (count != nullptr && k == 0) *count += 1;
}

int device_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <bool kSharedU>
int launch_to_landmarks(const float* W, const float* u, const int* lm_ptr, const int* lm_rows, const int* lm_cam,
                        int L, int C, int group_log2, float* t, long long* count, cudaStream_t stream) {
  const size_t smem = kSharedU ? 24 * static_cast<size_t>(C) : 0;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, to_landmarks_kernel<kSharedU>,
                                                                  kLandmarkThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = (kLandmarkThreads / 32) * static_cast<long long>(32 >> group_log2);
  const long long want = (static_cast<long long>(L) + per_block - 1) / per_block;
  const long long most = static_cast<long long>(device_sms()) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(want < most ? want : most);
  to_landmarks_kernel<kSharedU><<<blocks, kLandmarkThreads, smem, stream>>>(
      W, u, lm_ptr, lm_rows, lm_cam, L, C, group_log2, t, count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// t (L, 3) = Σ_{o∈l} W_oᵀ u[cam_o]: W (O, 6, 3) and u (C, 6) float32; the
// plan's lm_ptr (L + 1,), lm_rows (O,) and lm_cam (O,) int32; lanes per
// landmark 2^group_log2 (0..5). Every pointer on the device, contiguous; W
// 8-byte aligned. count: the card's replay counter under capture, else null.
// Launches on `stream`; returns the cudaGetLastError() of the launch.
extern "C" int smv_to_landmarks_f32(const float* W, const float* u, const int* lm_ptr, const int* lm_rows,
                                    const int* lm_cam, int L, int C, int group_log2, float* t, long long* count,
                                    cudaStream_t stream) {
  if (L <= 0 || group_log2 < 0 || group_log2 > 5) return static_cast<int>(cudaErrorInvalidValue);
  if (24LL * C <= kSharedUBytes)
    return launch_to_landmarks<true>(W, u, lm_ptr, lm_rows, lm_cam, L, C, group_log2, t, count, stream);
  return launch_to_landmarks<false>(W, u, lm_ptr, lm_rows, lm_cam, L, C, group_log2, t, count, stream);
}

// y (C, 6) = Σ_{o∈c} W_o s[pt_o]: W_cam (O, 6, 3), W's rows in the plan's
// camera order, and s (L, 3) float32; the plan's tile_ptr (n_tiles + 1,),
// cam_pt (O,) and cam_tiles (C + 1,) int32; partial (n_tiles, 6) float32
// scratch. Every pointer on the device, contiguous; W_cam 8-byte aligned. Two
// launches on `stream` (the tiles, none when n_tiles is 0, then the camera
// sums); count as above, added to by the second. Returns the
// cudaGetLastError() of the launches.
extern "C" int smv_to_cameras_f32(const float* W_cam, const float* s, const int* tile_ptr, const int* cam_pt,
                                  const int* cam_tiles, int n_tiles, int C, float* partial, float* y,
                                  long long* count, cudaStream_t stream) {
  if (C <= 0 || n_tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles > 0) {
    const long long per_block = kTileThreads / 32;
    const long long blocks = (static_cast<long long>(n_tiles) + per_block - 1) / per_block;
    camera_tiles_kernel<<<static_cast<unsigned>(blocks), kTileThreads, 0, stream>>>(W_cam, s, tile_ptr, cam_pt,
                                                                                   n_tiles, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (6LL * C + kCombineThreads - 1) / kCombineThreads;
  camera_combine_kernel<<<static_cast<unsigned>(blocks), kCombineThreads, 0, stream>>>(partial, cam_tiles, C, y,
                                                                                      count);
  return static_cast<int>(cudaGetLastError());
}
