// The device all-reduce of a mesh's members: the processes of one host,
// through buffers that every process maps from every other by CUDA IPC, or
// the cards of one process, through buffers that the cards read from each
// other after cudaDeviceEnablePeerAccess. A graph helper, like
// graph_cond.cu, not a port of a TPU kernel: it stands where the JAX
// package's psum inside shard_map rides ICI (moptimizer_0_tpu/parallel/
// sharded.py:55-57, ba_dense.py's shard_map'd LM loop), so that a sharded
// step across processes or cards is one CUDA-graph replay on each.
//
// One buffer a member (cudaMalloc'd on its card):
//   [0, BLOCKS·128)        flags: block b's published epoch (u64), a line each
//   [EPOCH_OFF, +BLOCKS·8) epochs: block b's last finished epoch (this member only)
//   [ERROR_OFF, +8)        error: the first epoch a peer missed, 0 while none
//   [PING_OFF, +8)         the round-trip probe's flag (mr_pingpong)
//   [HEADER, +2·per·cap)   slots: [HEADER + ((e mod 2)·per + i)·cap, +cap)
//                          holds the member's i-th shard's partial at epoch e
// A member holds `per` shards at most: a process one (its rank's), a card
// those of the mesh's shards placed on it. Shard j lies in member
// member_of[j]'s buffer at position pos_of[j].
//
// A reduction runs BLOCKS blocks, one launch a member; block b owns the
// 4 KiB tiles t ≡ b (mod BLOCKS) of the data, whatever its size or type, in
// every reduction of the buffer. Block b, at its epoch e = epochs[b] + 1:
//   1. copies its tiles of this member's partials into their slots e mod 2;
//   2. publishes flags[b] = e with a system-scope release;
//   3. spins with system-scope acquire loads until every other member's
//      flags[b] ≥ e, for at most timeout_ns of %globaltimer; on timeout it
//      writes the error word and gives up (a later reduction of the buffer
//      skips its spin);
//   4. combines every shard's tiles, slots e mod 2, in shard order
//      ((s0 + s1) + s2 ...), the order Mesh.psum sums in, so every member
//      writes the same bits (NaN once the error word is set);
//   5. stores epochs[b] = e.
// The host reads nothing: the epoch lives on the device, so a graph's
// replays advance it. Slots e mod 2 are written only after every member
// passed barrier e − 1, i.e. after every member finished reading them at
// e − 2.
//
// Bound on this card: (P + 1)·n bytes for P shards (the partials read, P
// slots read, the output written; the copy-in's write is the slot's) over
// 3.35 TB/s, plus one barrier: 5.2 µs for S (5.76 MB) at P = 2. A simple
// kernel: scalar loads, one block an SM; the barrier's round trip is
// measured by chip_profile.py --path mesh_barrier.
//
// float32 and float64, the types the port's mesh reductions carry. Every
// function returns a cudaError_t (0 on success); mr_reduce returns -2 for
// data larger than a slot, -3 for a dtype, op, count or placement it does
// not take.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define MR_MAX_MEMBERS 8
#define MR_MAX_SHARDS 32
#define MR_BLOCKS 132
#define MR_THREADS 256
#define MR_TILE 4096
#define MR_FLAG_STRIDE 128
#define MR_EPOCH_OFF (MR_BLOCKS * MR_FLAG_STRIDE)
#define MR_ERROR_OFF (MR_EPOCH_OFF + MR_BLOCKS * 8)
#define MR_PING_OFF (MR_ERROR_OFF + 128)
#define MR_HEADER 32768

// One member's side of a reduction: base[m] is member m's buffer as this
// process maps it, in[i] the partial of this member's i-th shard;
// member_of[j] and pos_of[j] place shard j's slot.
struct Members {
    char* base[MR_MAX_MEMBERS];
    const void* in[MR_MAX_SHARDS];
    int member_of[MR_MAX_SHARDS];
    int pos_of[MR_MAX_SHARDS];
};

__device__ __forceinline__ unsigned long long globaltimer() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__device__ __forceinline__ void store_release_sys(unsigned long long* p, unsigned long long v) {
    asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ unsigned long long* flag_of(char* base, int b) {
    return reinterpret_cast<unsigned long long*>(base + (size_t)b * MR_FLAG_STRIDE);
}

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double quiet_nan<double>() { return __longlong_as_double(0x7ff8000000000000ll); }

// torch.add and torch.maximum (a NaN operand gives NaN)
template <typename T, int OP> __device__ __forceinline__ T combine(T a, T b) {
    if (OP == 0) return a + b;
    return (a != a || a > b) ? a : b;
}

template <typename T, int OP>
__global__ void __launch_bounds__(MR_THREADS)
reduce_kernel(Members m, T* __restrict__ out, long long n, int n_local, int n_shards, int n_members, int me,
              int per, unsigned long long cap, unsigned long long timeout_ns) {
    const int b = blockIdx.x;
    char* own = m.base[me];
    unsigned long long* epoch = reinterpret_cast<unsigned long long*>(own + MR_EPOCH_OFF) + b;
    unsigned long long* error = reinterpret_cast<unsigned long long*>(own + MR_ERROR_OFF);
    __shared__ unsigned long long s_epoch;
    __shared__ int s_ok;
    if (threadIdx.x == 0) {
        s_epoch = *epoch + 1;
        s_ok = *reinterpret_cast<volatile unsigned long long*>(error) == 0;
    }
    __syncthreads();
    const unsigned long long e = s_epoch;
    const size_t slots = MR_HEADER + (size_t)(e & 1ull) * (size_t)per * cap;
    constexpr long long per_tile = MR_TILE / sizeof(T);
    const long long n_tiles = (n + per_tile - 1) / per_tile;

    // 1. this member's partials into their slots
    for (int i = 0; i < n_local; ++i) {
        const T* src = static_cast<const T*>(m.in[i]);
        T* dst = reinterpret_cast<T*>(own + slots + (size_t)i * cap);
        for (long long t = b; t < n_tiles; t += gridDim.x) {
            const long long end = min(n, (t + 1) * per_tile);
            for (long long k = t * per_tile + threadIdx.x; k < end; k += MR_THREADS) dst[k] = src[k];
        }
    }
    __syncthreads();

    // 2. publish, 3. wait for every other member (bounded)
    if (threadIdx.x == 0) {
        __threadfence_system();
        store_release_sys(flag_of(own, b), e);
        if (s_ok) {
            const unsigned long long t0 = globaltimer();
            for (int r = 0; r < n_members && s_ok; ++r) {
                if (r == me) continue;
                const unsigned long long* f = flag_of(m.base[r], b);
                while (load_acquire_sys(f) < e) {
                    if (globaltimer() - t0 > timeout_ns ||
                        *reinterpret_cast<volatile unsigned long long*>(error) != 0) {
                        atomicMax(error, e);
                        s_ok = 0;
                        break;
                    }
                }
            }
            __threadfence_system();
        }
    }
    __syncthreads();

    // 4. every shard's slot, in shard order, read past L1
    const bool ok = s_ok;
    for (long long t = b; t < n_tiles; t += gridDim.x) {
        const long long end = min(n, (t + 1) * per_tile);
        for (long long k = t * per_tile + threadIdx.x; k < end; k += MR_THREADS) {
            if (!ok) {
                out[k] = quiet_nan<T>();
                continue;
            }
            T acc = __ldcg(reinterpret_cast<const T*>(m.base[m.member_of[0]] + slots + (size_t)m.pos_of[0] * cap) + k);
            for (int j = 1; j < n_shards; ++j)
                acc = combine<T, OP>(acc, __ldcg(reinterpret_cast<const T*>(
                                              m.base[m.member_of[j]] + slots + (size_t)m.pos_of[j] * cap) + k));
            out[k] = acc;
        }
    }

    // 5. advance
    if (threadIdx.x == 0) *epoch = e;
}

// Rank 0 raises its flag to k and waits for the peer's; the peer waits for
// rank 0's and answers: `iters` round trips in one launch, from base + 1.
__global__ void pingpong_kernel(char* own, char* peer, int rank, long long base, long long iters,
                                unsigned long long timeout_ns) {
    unsigned long long* mine = reinterpret_cast<unsigned long long*>(own + MR_PING_OFF);
    const unsigned long long* theirs = reinterpret_cast<const unsigned long long*>(peer + MR_PING_OFF);
    unsigned long long* error = reinterpret_cast<unsigned long long*>(own + MR_ERROR_OFF);
    const unsigned long long t0 = globaltimer();
    for (long long k = base + 1; k <= base + iters; ++k) {
        if (rank == 0) store_release_sys(mine, (unsigned long long)k);
        while (load_acquire_sys(theirs) < (unsigned long long)k) {
            if (globaltimer() - t0 > timeout_ns) {
                atomicMax(error, (unsigned long long)k);
                return;
            }
        }
        if (rank != 0) store_release_sys(mine, (unsigned long long)k);
    }
}

extern "C" int mr_header_bytes() { return MR_HEADER; }
extern "C" int mr_max_members() { return MR_MAX_MEMBERS; }
extern "C" int mr_max_shards() { return MR_MAX_SHARDS; }
extern "C" int mr_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// A zeroed buffer of `bytes` on `device`.
extern "C" int mr_alloc(int device, unsigned long long bytes, void** ptr) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    err = cudaMalloc(ptr, bytes);
    if (err != cudaSuccess) return err;
    err = cudaMemset(*ptr, 0, bytes);
    if (err != cudaSuccess) return err;
    return cudaDeviceSynchronize();
}

// The IPC handle of a buffer, for the other processes' mr_open.
extern "C" int mr_handle(void* ptr, void* handle) {
    cudaIpcMemHandle_t h;
    cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
    if (err != cudaSuccess) return err;
    memcpy(handle, &h, sizeof(h));
    return 0;
}

extern "C" int mr_open(int device, const void* handle, void** ptr) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaIpcMemHandle_t h;
    memcpy(&h, handle, sizeof(h));
    return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int mr_close(void* ptr) { return cudaIpcCloseMemHandle(ptr); }

extern "C" int mr_free(void* ptr) { return cudaFree(ptr); }

// Let `device` read `peer`'s memory when peer ≥ 0 (already enabled counts
// as done), and load the kernels on `device`, so that no capture loads a
// module.
extern "C" int mr_prepare(int device, int peer) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (peer >= 0) {
        err = cudaDeviceEnablePeerAccess(peer, 0);
        if (err == cudaErrorPeerAccessAlreadyEnabled) {
            cudaGetLastError();
            err = cudaSuccess;
        }
        if (err != cudaSuccess) return err;
    }
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, reduce_kernel<float, 0>)) != cudaSuccess) return err;
    if ((err = cudaFuncGetAttributes(&attr, reduce_kernel<float, 1>)) != cudaSuccess) return err;
    if ((err = cudaFuncGetAttributes(&attr, reduce_kernel<double, 0>)) != cudaSuccess) return err;
    return cudaFuncGetAttributes(&attr, reduce_kernel<double, 1>);
}

template <typename T>
static cudaError_t launch(int op, const Members& m, void* out, long long n, int n_local, int n_shards, int n_members,
                          int me, int per, unsigned long long cap, unsigned long long timeout_ns, cudaStream_t s) {
    if (op == 0)
        reduce_kernel<T, 0><<<MR_BLOCKS, MR_THREADS, 0, s>>>(m, static_cast<T*>(out), n, n_local, n_shards, n_members,
                                                             me, per, cap, timeout_ns);
    else
        reduce_kernel<T, 1><<<MR_BLOCKS, MR_THREADS, 0, s>>>(m, static_cast<T*>(out), n, n_local, n_shards, n_members,
                                                             me, per, cap, timeout_ns);
    return cudaGetLastError();
}

// Member `me`'s launch of one reduction, on `stream` of its card (the
// current device). dtype: 0 float32, 1 float64; op: 0 sum, 1 max.
// ins: this member's n_local partials, its shards ascending; bases: every
// member's buffer as mapped here; member_of, pos_of: each of the n_shards
// shards' member and position there, `per` positions a parity.
extern "C" int mr_reduce(const unsigned long long* ins, int n_local, void* out, long long n, int dtype, int op,
                         const unsigned long long* bases, int n_members, const int* member_of, const int* pos_of,
                         int n_shards, int me, int per, unsigned long long cap, unsigned long long timeout_ns,
                         void* stream) {
    static const int sizes[2] = {4, 8};
    if (dtype < 0 || dtype > 1 || op < 0 || op > 1 || n_members < 1 || n_members > MR_MAX_MEMBERS ||
        n_shards < 1 || n_shards > MR_MAX_SHARDS || n_local < 1 || n_local > per || me < 0 || me >= n_members)
        return -3;
    if ((unsigned long long)n * sizes[dtype] > cap) return -2;
    Members m = {};
    for (int r = 0; r < n_members; ++r) m.base[r] = reinterpret_cast<char*>(bases[r]);
    for (int i = 0; i < n_local; ++i) m.in[i] = reinterpret_cast<const void*>(ins[i]);
    for (int j = 0; j < n_shards; ++j) {
        if (member_of[j] < 0 || member_of[j] >= n_members || pos_of[j] < 0 || pos_of[j] >= per) return -3;
        m.member_of[j] = member_of[j];
        m.pos_of[j] = pos_of[j];
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(op, m, out, n, n_local, n_shards, n_members, me, per, cap, timeout_ns, s);
    return launch<double>(op, m, out, n, n_local, n_shards, n_members, me, per, cap, timeout_ns, s);
}

// The error word of a buffer, read after the stream's work before it.
extern "C" int mr_error(const void* own, unsigned long long* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemcpyAsync(out, static_cast<const char*>(own) + MR_ERROR_OFF, sizeof(*out),
                                      cudaMemcpyDeviceToHost, s);
    if (err != cudaSuccess) return err;
    return cudaStreamSynchronize(s);
}

extern "C" int mr_pingpong(void* own, void* peer, int rank, long long base, long long iters,
                           unsigned long long timeout_ns, void* stream) {
    pingpong_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<char*>(own), static_cast<char*>(peer),
                                                                   rank, base, iters, timeout_ns);
    return cudaGetLastError();
}
