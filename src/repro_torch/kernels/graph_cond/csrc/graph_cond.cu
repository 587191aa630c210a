// CUDA graph conditional IF nodes for a step captured by PyTorch
// (models/graphs.py, StepGraph(guard=)).
//
// Replaces no TPU kernel: the reference's serving ticks are lax.while_loops
// that stop on the device, which XLA lowers to a loop whose condition the
// device evaluates. A captured CUDA graph has a fixed list of launches, so
// the port captures each step's body inside an IF node whose condition a
// one-thread kernel sets from a device bool: a replay after the loop's end
// runs that kernel and skips the body. The installed PyTorch (2.11) has no
// Python binding for conditional nodes (CUDAGraph.begin_capture_to_if_node
// came later), so the runtime's graph API is called here, as PyTorch's own
// binding does. Bound by nothing: one thread reads one byte.
//
// Use, from Python: capture the body into a graph kept uninstantiated;
// capture the guard into the outer graph and, inside that capture, call
// graph_if_node on the guard's bool; after the capture, graph_if_fill puts
// a copy of the body's graph into the IF node; then instantiate the outer
// graph (CUDA 12.4 or later, Hopper).
#include <cuda_runtime.h>

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

// Inside a stream capture on `stream`: a conditional handle on the graph
// being captured, the kernel that sets it from *flag, and an IF node on it
// that the stream's later captured work depends on. *body receives the IF
// node's body graph (empty; graph_if_fill fills it).
extern "C" int graph_if_node(void* stream, const void* flag, void** body) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition_kernel<<<1, 1, 0, s>>>(handle,
                                       static_cast<const bool*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  *body = params.conditional.phGraph_out[0];
  return cudaStreamUpdateCaptureDependencies(
      s, &node, 1, cudaStreamSetCaptureDependencies);
}

// A copy of `child` (a captured graph) as the one node of an IF node's
// body graph.
extern "C" int graph_if_fill(void* body, void* child) {
  cudaGraphNode_t node;
  return cudaGraphAddChildGraphNode(&node, static_cast<cudaGraph_t>(body),
                                    nullptr, 0,
                                    static_cast<cudaGraph_t>(child));
}
