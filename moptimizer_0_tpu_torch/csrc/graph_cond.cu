// IF nodes inside a CUDA graph being captured from a stream (CUDA >= 12.4).
//
// The counterpart of lax.cond / the test of a lax.while_loop inside a jitted
// step: the work captured between dl_begin_if and dl_end_if runs at replay
// only where a one-byte device flag (a torch.bool tensor) is non-zero when
// the graph reaches the node.
//
// dl_begin_if(parent, child, pred), called while `parent` is capturing
// (into the outer graph, or into the body of an enclosing IF):
//   1. creates a conditional handle in the graph `parent` captures into;
//   2. captures, on `parent`, a one-thread kernel that reads *pred and sets
//      the handle (so the flag is read at replay, after the work before it);
//   3. adds an IF node after that kernel and makes it the only dependency of
//      whatever `parent` captures next;
//   4. starts capturing `child` (a stream that is not capturing) into the
//      IF node's body graph.
// dl_end_if(child) ends that capture; the body graph belongs to the node.
// Both return a cudaError_t (0 on success), or -1 when `parent` is not
// capturing.
//
// dl_mark(which, stream, count) launches the marker `which` (an index of
// kernels/graph_cond.py's MARKS) on `stream`: an empty one-thread kernel
// named moptimizer_mark_<name>, so that a device trace shows on the
// device's clock where a captured step, linearization, PCG solve or PCG
// iteration ran. Captured, it is a node of the graph or of the IF body
// being captured. pcg_iteration adds one to *count unless count is null.
// Returns a cudaError_t, or -1 for an unknown marker.

#include <cuda_runtime.h>

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const unsigned char* pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

#define MARKER(name) \
    extern "C" __global__ void moptimizer_mark_##name() {}
MARKER(step_begin)
MARKER(step_end)
MARKER(ba_linearize_begin)
MARKER(ba_linearize_end)
MARKER(ba_pcg_begin)
MARKER(ba_pcg_end)
#undef MARKER

extern "C" __global__ void moptimizer_mark_pcg_iteration(int* count) {
    if (count != nullptr) *count += 1;
}

extern "C" int dl_begin_if(void* parent, void* child, const void* pred) {
    cudaStream_t ps = static_cast<cudaStream_t>(parent);
    cudaStream_t cs = static_cast<cudaStream_t>(child);
    cudaStreamCaptureStatus status;
    unsigned long long id;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t n_deps;
    cudaError_t err = cudaStreamGetCaptureInfo(ps, &status, &id, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return err;
    if (status != cudaStreamCaptureStatusActive) return -1;

    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return err;
    set_if_kernel<<<1, 1, 0, ps>>>(handle, static_cast<const unsigned char*>(pred));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    // the dependencies now end at the kernel just captured
    err = cudaStreamGetCaptureInfo(ps, &status, &id, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return err;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
    if (err != cudaSuccess) return err;
    err = cudaStreamUpdateCaptureDependencies(ps, &node, 1, cudaStreamSetCaptureDependencies);
    if (err != cudaSuccess) return err;
    return cudaStreamBeginCaptureToGraph(cs, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                         cudaStreamCaptureModeThreadLocal);
}

extern "C" int dl_end_if(void* child) {
    cudaGraph_t body;
    return cudaStreamEndCapture(static_cast<cudaStream_t>(child), &body);
}

extern "C" int dl_mark(int which, void* stream, int* count) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (which) {
        case 0: moptimizer_mark_step_begin<<<1, 1, 0, s>>>(); break;
        case 1: moptimizer_mark_step_end<<<1, 1, 0, s>>>(); break;
        case 2: moptimizer_mark_ba_linearize_begin<<<1, 1, 0, s>>>(); break;
        case 3: moptimizer_mark_ba_linearize_end<<<1, 1, 0, s>>>(); break;
        case 4: moptimizer_mark_ba_pcg_begin<<<1, 1, 0, s>>>(); break;
        case 5: moptimizer_mark_ba_pcg_end<<<1, 1, 0, s>>>(); break;
        case 6: moptimizer_mark_pcg_iteration<<<1, 1, 0, s>>>(count); break;
        default: return -1;
    }
    return cudaGetLastError();
}
