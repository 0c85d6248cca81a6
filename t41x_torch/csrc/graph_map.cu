// The device-op nodes of the CUDA graph a stream is capturing into, for
// the stage maps of `t41x_torch.utils.tracing`.
//
// No kernel: host code only, and no TPU twin (t41x's traces come from
// the XLA profiler, which names each fused op itself).  Inside a CUDA
// graph a kernel carries no trace of the Python stage that launched it,
// so the tracer counts the capture's device-op nodes (kernel, memcpy,
// memset) at each stage boundary and cuts the replays of the trace by
// those counts.  Reading the graph adds no node to it: no event, no
// marker kernel.  Cost: one pass over the graph's nodes a call, a few µs
// at the chain's ~100 nodes a block.

#include <cuda_runtime.h>

#include <unordered_map>
#include <vector>

namespace {

// 0 kernel, 1 memcpy, 2 memset, -1 a node that runs no device op
int kind_of(cudaGraphNode_t node) {
    cudaGraphNodeType t;
    if (cudaGraphNodeGetType(node, &t) != cudaSuccess) return -1;
    switch (t) {
        case cudaGraphNodeTypeKernel: return 0;
        case cudaGraphNodeTypeMemcpy: return 1;
        case cudaGraphNodeTypeMemset: return 2;
        default: return -1;
    }
}

cudaError_t edges(cudaGraph_t g, std::vector<cudaGraphNode_t>& from,
                  std::vector<cudaGraphNode_t>& to) {
    size_t m = 0;
#if CUDART_VERSION >= 13000
    cudaError_t e = cudaGraphGetEdges(g, nullptr, nullptr, nullptr, &m);
#else
    cudaError_t e = cudaGraphGetEdges(g, nullptr, nullptr, &m);
#endif
    if (e != cudaSuccess || m == 0) return e;
    from.resize(m);
    to.resize(m);
#if CUDART_VERSION >= 13000
    return cudaGraphGetEdges(g, from.data(), to.data(), nullptr, &m);
#else
    return cudaGraphGetEdges(g, from.data(), to.data(), &m);
#endif
}

}  // namespace

// out[0]: the stream's capture status (0 none, 1 active, 2 invalidated);
// out[1]: the device-op nodes its graph holds so far; out[2]: all its
// nodes.  With `kinds` (room for `cap`), also out[3]: 1 if the graph is
// one chain (one root, each node at most one dependency and one
// dependent), and then kinds[i] = the kind of the i-th device-op node
// along the chain, at most `cap` of them.  Returns a cudaError_t.
extern "C" int t41x_capture_nodes(long long* out, int* kinds, long long cap,
                                  cudaStream_t stream) {
    out[0] = out[1] = out[2] = out[3] = 0;
    cudaStreamCaptureStatus status;
    unsigned long long id = 0;
    cudaGraph_t graph = nullptr;
    cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, &id, &graph);
    if (e != cudaSuccess) return e;
    out[0] = status == cudaStreamCaptureStatusActive ? 1
             : status == cudaStreamCaptureStatusInvalidated ? 2 : 0;
    if (status != cudaStreamCaptureStatusActive) return cudaSuccess;

    size_t n = 0;
    if ((e = cudaGraphGetNodes(graph, nullptr, &n)) != cudaSuccess) return e;
    std::vector<cudaGraphNode_t> nodes(n);
    if (n && (e = cudaGraphGetNodes(graph, nodes.data(), &n)) != cudaSuccess)
        return e;
    long long ops = 0;
    for (size_t i = 0; i < n; ++i) ops += kind_of(nodes[i]) >= 0;
    out[1] = ops;
    out[2] = (long long)n;
    if (kinds == nullptr || n == 0) return cudaSuccess;

    size_t roots = 0;
    if ((e = cudaGraphGetRootNodes(graph, nullptr, &roots)) != cudaSuccess)
        return e;
    std::vector<cudaGraphNode_t> from, to;
    if ((e = edges(graph, from, to)) != cudaSuccess) return e;
    if (roots != 1 || from.size() != n - 1) return cudaSuccess;
    std::unordered_map<cudaGraphNode_t, cudaGraphNode_t> next;
    std::unordered_map<cudaGraphNode_t, int> into;
    for (size_t i = 0; i < from.size(); ++i) {
        if (!next.emplace(from[i], to[i]).second) return cudaSuccess;
        if (++into[to[i]] > 1) return cudaSuccess;
    }
    std::vector<cudaGraphNode_t> root(1);
    if ((e = cudaGraphGetRootNodes(graph, root.data(), &roots)) != cudaSuccess)
        return e;
    long long k = 0;
    size_t walked = 0;
    for (cudaGraphNode_t v = root[0];; ++walked) {
        const int kind = kind_of(v);
        if (kind >= 0 && k < cap) kinds[k++] = kind;
        auto it = next.find(v);
        if (it == next.end()) break;
        v = it->second;
    }
    out[3] = walked + 1 == n;
    return cudaSuccess;
}
