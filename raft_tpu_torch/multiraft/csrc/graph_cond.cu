// The conditional node of ClusterSim.run_compiled's CUDA graph.
//
// The reference gates the general round's election phase with lax.cond
// (raft_tpu/multiraft/sim.py, the `jax.lax.cond(jnp.any(req), ...)` of the
// plain step): a device-side branch.  A CUDA graph has the same thing, the
// conditional node (CUDA 12.3+), which PyTorch 2.11 does not expose.  So
// this file adds one to a graph that PyTorch is capturing: `graph_if_node`
// runs on the capturing stream, launches the one-thread kernel that sets
// the node's condition from a device bool, adds an IF node after the
// stream's current dependencies with the branch's graph (captured by
// PyTorch on its own) as the node's body, and makes the node the stream's
// only dependency, so the rest of the capture follows it.
//
// Bound: the kernel reads one byte; its cost is a launch (a few µs).  No
// TPU kernel corresponds to it: it is graph plumbing.
#include <cuda_runtime.h>

namespace {

__global__ void set_if_from_bool(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

// Returns 0, a cudaError_t, or -1 when `stream` is not capturing.
extern "C" int graph_if_node(void* stream, const void* pred, void* body) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_if_from_bool<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // The launch above is now the stream's dependency.
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t child;
  err = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0], nullptr, 0,
                                   static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) return err;
  return cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
}

// The number of top-level nodes of `graph` in *n.
extern "C" int graph_node_count(void* graph, unsigned long long* n) {
  size_t count = 0;
  cudaError_t err = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &count);
  *n = count;
  return err;
}
