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
// it is CUDA-core arithmetic, and the kernel is bound by instruction issue.
//
// Arithmetic. cross is three products and two sums, each rounded on its own
// (__fmul_rn/__fadd_rn: nvcc would otherwise contract them into FMAs, which
// the plain PyTorch version, ops/nn_search.py::_nn_expand_torch, does not).
// qn − 2·cross is one FMA, fma(−2, cross, qn): scaling by −2 is exact, so the
// single rounding of the FMA equals the plain version's rounded product and
// rounded difference, subnormals included (only a 2·cross beyond FLT_MAX
// would differ). Folding −2 into the targets instead (−2px, −2py, −2pz) would
// save the same operation but is not exact: a subnormal product rounds to
// another value at twice the scale. Then + pn. Seven float operations a pair,
// and the kernel agrees with the plain version bit for bit. d² is not clamped
// at 0: near a match the expansion can be slightly negative, as it is in the
// JAX package.
//
// Design. Grid (⌈Q/(128·kR)⌉, B, S): 128 threads, each with kR queries in
// registers (query r of thread t is t + 128·r of the block's queries), one
// row of blocks per lane, and S target splits. The block streams its split of
// the lane's targets through shared memory in tiles of kTile points stored as
// float4 (x, y, z, pn), so one 16-byte broadcast load serves kR pairs. Targets
// are taken in runs of kRun: over a run each query keeps only the minimum d²
// (fminf, one instruction a pair, which never takes a NaN); at the end of the
// run, if that minimum is strictly below the query's best, it becomes the best
// and the run's first index is kept (two selects, no branch). Only when the
// split is done is the best run scanned once more, from device memory, for
// the first index whose d² equals the best, and that d² is written. The rule
// is strict `<` across runs and the first equal within a run, so the first
// index wins ties, as the Pallas kernel's masked-iota min and torch.min do,
// and a NaN query ends as (0, +inf).
//
// Splits. One lane of 29,310 queries is 58 blocks, under half of the 132 SMs;
// the wrapper then splits the targets into S contiguous ranges, and each
// block writes its range's (index, d²) to a scratch row. A second kernel
// merges the S rows of each query in ascending order with strict `<`, so an
// equal d² keeps the lower range, which holds the lower index.
//
// Cost a pair: 7 float operations, one FMNMX, 1/kR of a shared load and
// 3/kRun of the run's compare and selects. Bound: 8 flops a pair at
// 67 TFLOP/s counts an FMA as two operations; with every product and sum
// rounded on its own, the float pipe needs 7 instructions a pair whatever the
// design. The bytes do not matter: each lane's targets (352 KB at 29,310
// points) are read once per block from L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kR = 4;  // queries a thread
constexpr int kQueriesPerBlock = kThreads * kR;
constexpr int kTile = 2048;  // 32 KB of shared memory per block
constexpr int kRun = 32;     // targets a run
static_assert(kTile % kRun == 0, "runs must not cross a tile");

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ float expand_d2(float qx, float qy, float qz, float qn, float4 p) {
  const float cross =
      __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)), __fmul_rn(qz, p.z));
  return __fadd_rn(__fmaf_rn(-2.f, cross, qn), p.w);
}

// A thread's kR queries, their best d² so far and the first index of the run
// that holds it (−1 while none has won).
struct Queries {
  float x[kR], y[kR], z[kR], n[kR], best[kR];
  int run[kR];
};

// The run t[0, n) of the tile, whose first target has index `first`. kN is
// kRun for a full run (unrolled) or 0 for the ragged last run of a split.
template <int kN>
__device__ __forceinline__ void scan_run(const float4* t, int n, int first, Queries& q) {
  float m[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) m[r] = pos_inf();
  if constexpr (kN > 0) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float4 p = t[j];
#pragma unroll
      for (int r = 0; r < kR; ++r) m[r] = fminf(m[r], expand_d2(q.x[r], q.y[r], q.z[r], q.n[r], p));
    }
  } else {
    for (int j = 0; j < n; ++j) {
      const float4 p = t[j];
#pragma unroll
      for (int r = 0; r < kR; ++r) m[r] = fminf(m[r], expand_d2(q.x[r], q.y[r], q.z[r], q.n[r], p));
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const bool better = m[r] < q.best[r];
    q.best[r] = better ? m[r] : q.best[r];
    q.run[r] = better ? first : q.run[r];
  }
}

// out_idx/out_d2 are (S, n_lanes, n_query): split s of lane b at row s·B + b.
__global__ void __launch_bounds__(kThreads)
nn_expand_kernel(const float* __restrict__ query, const float* __restrict__ points,
                 int n_query, int n_points, int split_len, int* __restrict__ out_idx,
                 float* __restrict__ out_d2) {
  __shared__ float4 tile[kTile];

  const long long lane = blockIdx.y;
  const float* q_lane = query + lane * 3LL * n_query;
  const float* p_lane = points + lane * 3LL * n_points;
  const int q0 = blockIdx.x * kQueriesPerBlock + threadIdx.x;
  const int lo = blockIdx.z * split_len;
  const int hi = min(n_points, lo + split_len);

  Queries q;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = q0 + r * kThreads;
    q.x[r] = q.y[r] = q.z[r] = 0.f;
    if (i < n_query) {
      q.x[r] = q_lane[3LL * i + 0];
      q.y[r] = q_lane[3LL * i + 1];
      q.z[r] = q_lane[3LL * i + 2];
    }
    q.n[r] = sq_norm(q.x[r], q.y[r], q.z[r]);
    q.best[r] = pos_inf();
    q.run[r] = -1;
  }

  for (int base = lo; base < hi; base += kTile) {
    const int n = min(kTile, hi - base);
    __syncthreads();  // every thread is done with the previous tile
    const float* src = p_lane + 3LL * base;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float px = src[3 * j + 0];
      const float py = src[3 * j + 1];
      const float pz = src[3 * j + 2];
      tile[j] = make_float4(px, py, pz, sq_norm(px, py, pz));
    }
    __syncthreads();
    int j = 0;
#pragma unroll 1
    for (; j + kRun <= n; j += kRun) scan_run<kRun>(tile + j, kRun, base + j, q);
    if (j < n) scan_run<0>(tile + j, n - j, base + j, q);
  }

  const long long row = (static_cast<long long>(blockIdx.z) * gridDim.y + lane) * n_query;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = q0 + r * kThreads;
    if (i >= n_query) continue;
    int idx = 0;
    float best = q.best[r];
    if (q.run[r] >= 0) {
      // the first target of the winning run whose d² equals the best
      const int end = min(q.run[r] + kRun, hi);
      for (int k = q.run[r]; k < end; ++k) {
        const float px = p_lane[3LL * k + 0];
        const float py = p_lane[3LL * k + 1];
        const float pz = p_lane[3LL * k + 2];
        const float d2 =
            expand_d2(q.x[r], q.y[r], q.z[r], q.n[r], make_float4(px, py, pz, sq_norm(px, py, pz)));
        if (d2 == best) {
          idx = k;
          best = d2;  // of the two zeros, the one this target gives
          break;
        }
      }
    }
    out_idx[row + i] = idx;
    out_d2[row + i] = best;
  }
}

// The S split rows of each of n results, in ascending order: strict `<`, so
// an equal d² keeps the lower split (the lower index); (0, +inf) if none wins.
__global__ void merge_splits_kernel(const int* __restrict__ part_idx,
                                    const float* __restrict__ part_d2, int n_splits,
                                    long long n, int* __restrict__ out_idx,
                                    float* __restrict__ out_d2) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float best = pos_inf();
    int idx = 0;
    for (int s = 0; s < n_splits; ++s) {
      const float d2 = part_d2[s * n + i];
      if (d2 < best) {
        best = d2;
        idx = part_idx[s * n + i];
      }
    }
    out_idx[i] = idx;
    out_d2[i] = best;
  }
}

}  // namespace

// Queries each block takes (the wrapper sizes its grid and splits with it).
extern "C" int nn_expand_queries_per_block() { return kQueriesPerBlock; }

// query (n_lanes, n_query, 3) and points (n_lanes, n_points, 3): contiguous
// float32 on the device. out_idx (n_lanes, n_query) int32 and out_d2
// (n_lanes, n_query) float32. With n_splits > 1 the targets are cut into
// n_splits ranges of ⌈n_points/n_splits⌉, searched into part_idx/part_d2
// (n_splits, n_lanes, n_query) and merged into out_*; with n_splits = 1 the
// part buffers are not used. Launches on `stream` and returns the
// cudaGetLastError() of the launches (0 on success).
extern "C" int nn_expand_f32(const float* query, const float* points, int n_lanes, int n_query,
                             int n_points, int n_splits, int* part_idx, float* part_d2,
                             int* out_idx, float* out_d2, cudaStream_t stream) {
  const int split_len = (n_points + n_splits - 1) / n_splits;
  const dim3 grid((n_query + kQueriesPerBlock - 1) / kQueriesPerBlock, n_lanes, n_splits);
  if (n_splits == 1) {
    nn_expand_kernel<<<grid, kThreads, 0, stream>>>(query, points, n_query, n_points, split_len,
                                                    out_idx, out_d2);
    return static_cast<int>(cudaGetLastError());
  }
  nn_expand_kernel<<<grid, kThreads, 0, stream>>>(query, points, n_query, n_points, split_len,
                                                  part_idx, part_d2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(n_lanes) * n_query;
  const long long want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  merge_splits_kernel<<<blocks, 256, 0, stream>>>(part_idx, part_d2, n_splits, n, out_idx, out_d2);
  return static_cast<int>(cudaGetLastError());
}
