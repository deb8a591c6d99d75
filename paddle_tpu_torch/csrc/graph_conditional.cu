// Conditional nodes for a CUDA graph under stream capture: the port's
// counterpart of `lax.while_loop` / `lax.cond` on the whole-program route.
//
// Not the port of a TPU kernel: the JAX package lowers `while` and
// `conditional_block` into one XLA program (paddle_tpu/core/
// compiler_engine.py, `_trace_while` / `_trace_conditional_block`). Here a
// captured step holds them as conditional nodes, so a replay runs a loop
// whose trip count the data decides without the host reading a condition.
//
// The device kernel reads the scalar condition tensor (bool as the port's
// `less_than` / `logical_*` write it; any integer or float type taken as
// nonzero) and sets the node's handle with `cudaGraphSetConditional`. It
// runs once before a node (in the parent graph) and once at the end of each
// trip of a `while` body; it also adds one to the node's trip counter, a
// device int64 that the host reads only when launch counts are asked for.
// It moves a few bytes and is bound by its launch.
//
// The host functions, called with ctypes on torch's raw stream handles,
// follow PyTorch's CUDAGraph::begin_capture_to_if_node /
// end_capture_to_conditional_node, with the `while` kind beside the `if`:
//   begin: on the capturing stream, create a handle on the graph it
//          captures, launch the set kernel, add the conditional node after
//          the stream's dependencies, make the node the stream's only
//          dependency, and start capturing the side stream into the node's
//          body graph;
//   end:   end the side stream's capture.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// condition kinds (ops/cuda/graph_conditional.py: _KINDS)
enum CondKind : int {
  kByte = 0,   // bool, uint8, int8
  kHalf = 1,   // float16, bfloat16, int16: nonzero but for the sign bit
  kInt32 = 2,
  kInt64 = 3,
  kFloat32 = 4,
  kFloat64 = 5,
};

__device__ __forceinline__ unsigned int condition_value(const void* cond,
                                                        int kind) {
  switch (kind) {
    case kByte:
      return *static_cast<const unsigned char*>(cond) != 0;
    case kHalf:
      return (*static_cast<const unsigned short*>(cond) & 0x7fffu) != 0;
    case kInt32:
      return *static_cast<const int*>(cond) != 0;
    case kInt64:
      return *static_cast<const long long*>(cond) != 0;
    case kFloat32:
      return *static_cast<const float*>(cond) != 0.f;
    default:
      return *static_cast<const double*>(cond) != 0.0;
  }
}

// set: the node's handle to the condition (skipped when `set` is 0: the
// end of an `if` body only counts); trips: the node's body counter, or null
__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const void* cond, int kind, int set,
                                       unsigned long long* trips) {
  if (set) cudaGraphSetConditional(handle, condition_value(cond, kind));
  if (trips != nullptr) *trips += 1;
}

cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* ndeps) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph,
                                             deps, nullptr, ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph,
                                             deps, ndeps);
#endif
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;  // not capturing: nothing to add to
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launch the set kernel on `stream` (captured or not).
int paddle_graph_set_conditional(unsigned long long handle, const void* cond,
                                 int kind, int set, void* trips,
                                 void* stream) {
  set_conditional_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle), cond, kind, set,
      static_cast<unsigned long long*>(trips));
  return int(cudaGetLastError());
}

// Begin a conditional node (is_while: a `while`, else an `if`) in the graph
// that `stream` captures, its handle first set from `cond`; start capturing
// `side` into its body. Writes the handle to *handle_out.
int paddle_graph_begin_conditional(void* stream, void* side, int is_while,
                                   const void* cond, int kind,
                                   unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = capture_info(s, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return int(err);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return int(err);
  set_conditional_kernel<<<1, 1, 0, s>>>(handle, cond, kind, 1, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  err = capture_info(s, &graph, &deps, &ndeps);  // now after the kernel
  if (err != cudaSuccess) return int(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
#endif
  if (err != cudaSuccess) return int(err);
  cudaGraph_t body = params.conditional.phGraph_out[0];
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return int(err);
  err = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(side), body,
                                      nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return int(err);
  *handle_out = static_cast<unsigned long long>(handle);
  return 0;
}

// End the capture of a body begun on `side`.
int paddle_graph_end_conditional(void* side) {
  cudaGraph_t body = nullptr;
  return int(cudaStreamEndCapture(static_cast<cudaStream_t>(side), &body));
}

// A stream for bodies to be captured on (non-blocking), and its end.
int paddle_graph_stream_create(void** out) {
  cudaStream_t s;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err != cudaSuccess) return int(err);
  *out = s;
  return 0;
}

int paddle_graph_stream_destroy(void* stream) {
  return int(cudaStreamDestroy(static_cast<cudaStream_t>(stream)));
}

const char* paddle_graph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
