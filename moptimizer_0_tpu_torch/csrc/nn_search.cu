// Exact brute-force nearest neighbour for Hopper (sm_90a).
//
// Replaces moptimizer_0_tpu/ops/nn_search.py::_nn_vpu_kernel (launcher
// _nn_pallas_vpu): for every query q, the index of and squared distance to its
// nearest target p, with d² = (qx−px)² + (qy−py)² + (qz−pz)² in float32 and
// the smallest index winning ties.
//
// Arithmetic. d² is written with __fsub_rn/__fmul_rn/__fadd_rn: three
// differences, three products, two sums, each rounded on its own, in the
// order of the plain PyTorch version (ops/nn_search.py::_nn_torch). By
// default nvcc contracts dx*dx + dy*dy + dz*dz into FMAs, which round once
// where the plain version rounds twice; near-ties would then pick other
// indices. With the intrinsics the two agree bit for bit.
//
// Design. Grid (⌈Q/(128·kR)⌉, S): 128 threads, each with kR queries in
// registers (query r of thread t is t + 128·r of the block's queries), and S
// target splits. The block streams its split of the targets through shared
// memory in tiles of kTile points stored as float4 (x, y, z, unused), so one
// 16-byte broadcast load serves kR pairs. Targets are taken in runs of kRun:
// over a run each query keeps only the minimum d² (fminf, one instruction a
// pair, which never takes a NaN); at the end of the run, if that minimum is
// strictly below the query's best, it becomes the best and the run's first
// index is kept (two selects, no branch). Only when the split is done is the
// best run scanned once more, from device memory, for the first index whose
// d² equals the best, and that d² is written. The rule is strict `<` across
// runs and the first equal within a run, so the first index wins ties, as the
// Pallas kernel's masked-iota min and torch.min do. A query with no winning
// run (a NaN query, NaN targets, d² overflowing to inf everywhere) ends as
// (0, +inf), as the plain version's NaN → inf mask and torch.min give.
//
// Splits. 29,310 queries are 29 blocks, under a quarter of the 132 SMs; the
// wrapper then splits the targets into S contiguous ranges
// (kernels/nn_expand.py::n_splits), and each block writes its range's
// (index, d²) to a scratch row. A second kernel merges the S rows of each
// query in ascending order with strict `<`, so an equal d² keeps the lower
// range, which holds the lower index.
//
// Cost a pair: 8 float operations, one FMNMX, 1/kR of a shared load and
// 3/kRun of the run's compare and selects. Bound: the 8 float operations a
// pair. Counted as flops at 67 TFLOP/s (which counts an FMA as two) they
// bound the kernel at half the time that issuing them as 8 instructions
// takes: bit-equality forbids every FMA, so the issue floor is twice the flop
// bound. The bytes do not matter: the targets (352 KB at 29,310 points) are
// read once per block from L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kR = 8;  // queries a thread
constexpr int kQueriesPerBlock = kThreads * kR;
constexpr int kTile = 2048;  // 32 KB of shared memory per block
constexpr int kRun = 16;     // targets a run
static_assert(kTile % kRun == 0, "runs must not cross a tile");

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float direct_d2(float qx, float qy, float qz, float px, float py,
                                           float pz) {
  const float dx = __fsub_rn(qx, px);
  const float dy = __fsub_rn(qy, py);
  const float dz = __fsub_rn(qz, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// A thread's kR queries, their best d² so far and the first index of the run
// that holds it (−1 while none has won).
struct Queries {
  float x[kR], y[kR], z[kR], best[kR];
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
      for (int r = 0; r < kR; ++r) m[r] = fminf(m[r], direct_d2(q.x[r], q.y[r], q.z[r], p.x, p.y, p.z));
    }
  } else {
    for (int j = 0; j < n; ++j) {
      const float4 p = t[j];
#pragma unroll
      for (int r = 0; r < kR; ++r) m[r] = fminf(m[r], direct_d2(q.x[r], q.y[r], q.z[r], p.x, p.y, p.z));
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const bool better = m[r] < q.best[r];
    q.best[r] = better ? m[r] : q.best[r];
    q.run[r] = better ? first : q.run[r];
  }
}

// out_idx/out_d2 are (S, n_query): split s at row s.
__global__ void __launch_bounds__(kThreads)
nn_bruteforce_kernel(const float* __restrict__ query, const float* __restrict__ points,
                     int n_query, int n_points, int split_len, int* __restrict__ out_idx,
                     float* __restrict__ out_d2) {
  __shared__ float4 tile[kTile];

  const int q0 = blockIdx.x * kQueriesPerBlock + threadIdx.x;
  const int lo = blockIdx.y * split_len;
  const int hi = min(n_points, lo + split_len);

  Queries q;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = q0 + r * kThreads;
    q.x[r] = q.y[r] = q.z[r] = 0.f;
    if (i < n_query) {
      q.x[r] = query[3LL * i + 0];
      q.y[r] = query[3LL * i + 1];
      q.z[r] = query[3LL * i + 2];
    }
    q.best[r] = pos_inf();
    q.run[r] = -1;
  }

  for (int base = lo; base < hi; base += kTile) {
    const int n = min(kTile, hi - base);
    __syncthreads();  // every thread is done with the previous tile
    const float* src = points + 3LL * base;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      tile[j] = make_float4(src[3 * j + 0], src[3 * j + 1], src[3 * j + 2], 0.f);
    }
    __syncthreads();
    int j = 0;
#pragma unroll 1
    for (; j + kRun <= n; j += kRun) scan_run<kRun>(tile + j, kRun, base + j, q);
    if (j < n) scan_run<0>(tile + j, n - j, base + j, q);
  }

  const long long row = static_cast<long long>(blockIdx.y) * n_query;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = q0 + r * kThreads;
    if (i >= n_query) continue;
    int idx = 0;
    const float best = q.best[r];
    if (q.run[r] >= 0) {
      // the first target of the winning run whose d² equals the best
      const int end = min(q.run[r] + kRun, hi);
      for (int k = q.run[r]; k < end; ++k) {
        const float d2 = direct_d2(q.x[r], q.y[r], q.z[r], points[3LL * k + 0],
                                   points[3LL * k + 1], points[3LL * k + 2]);
        if (d2 == best) {
          idx = k;
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
__global__ void nn_bruteforce_merge_kernel(const int* __restrict__ part_idx,
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
extern "C" int nn_bruteforce_queries_per_block() { return kQueriesPerBlock; }

// query (n_query, 3) and points (n_points, 3): contiguous float32 on the
// device. out_idx (n_query,) int32 and out_d2 (n_query,) float32. With
// n_splits > 1 the targets are cut into n_splits ranges of
// ⌈n_points/n_splits⌉, searched into part_idx/part_d2 (n_splits, n_query) and
// merged into out_*; with n_splits = 1 the part buffers are not used.
// Launches on `stream` and returns the cudaGetLastError() of the launches (0
// on success).
extern "C" int nn_bruteforce_f32(const float* query, const float* points, int n_query,
                                 int n_points, int n_splits, int* part_idx, float* part_d2,
                                 int* out_idx, float* out_d2, cudaStream_t stream) {
  const int split_len = (n_points + n_splits - 1) / n_splits;
  const dim3 grid((n_query + kQueriesPerBlock - 1) / kQueriesPerBlock, n_splits);
  if (n_splits == 1) {
    nn_bruteforce_kernel<<<grid, kThreads, 0, stream>>>(query, points, n_query, n_points,
                                                         split_len, out_idx, out_d2);
    return static_cast<int>(cudaGetLastError());
  }
  nn_bruteforce_kernel<<<grid, kThreads, 0, stream>>>(query, points, n_query, n_points, split_len,
                                                       part_idx, part_d2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (n_query + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  nn_bruteforce_merge_kernel<<<blocks, 256, 0, stream>>>(part_idx, part_d2, n_splits, n_query,
                                                          out_idx, out_d2);
  return static_cast<int>(cudaGetLastError());
}
