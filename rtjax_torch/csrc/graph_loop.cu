// A device-side loop inside a captured CUDA graph: a while conditional
// node (CUDA >= 12.4) whose body is captured from a second stream.
//
// Replaces: nothing of rtjax's Pallas kernels.  It is the counterpart of
// rtjax's ``jax.lax.while_loop`` with a device condition inside the jitted
// wavefront step (rtjax/render/trace.py:403-434, 473-496: repass's passes),
// which PyTorch's graph capture has no Python API for in the installed
// version.
//
// What it does: rtjax_loop_begin, on a stream under capture, launches the
// condition kernel (iteration count k = 0; condition = *pred and k < max),
// adds a while node after it to the capture's graph, makes the stream's
// later work depend on that node, and starts capturing the body stream
// into the node's body graph.  The caller then captures the body on the
// body stream; rtjax_loop_end launches the condition kernel again as the
// body's last node (k += 1, total += 1, condition = *pred and k < max)
// and ends the body's capture.  On a replay the body runs while the
// condition holds: at most ``max`` times, so a wrong predicate cannot
// hang the card.  ``total`` (int64) counts the body's runs over every
// replay; the caller reads it to count the body's kernel launches.
//
// What bounds it: one single-thread kernel an iteration and the node's
// own launch; nothing is moved but a few words.

#include <cuda_runtime.h>

namespace {

__global__ void set_loop(cudaGraphConditionalHandle handle,
                         const bool* __restrict__ pred, int* k,
                         long long* total, int max, int first) {
  const int n = first ? 0 : *k + 1;
  *k = n;
  if (!first) *total += 1;
  cudaGraphSetConditional(handle, (*pred && n < max) ? 1u : 0u);
}

}  // namespace

// ``stream`` is capturing; ``body_stream`` (rtjax_loop_stream's) is not.
// ``pred``: a device bool; ``k``: a device int (scratch); ``total``: a
// device int64.  On success the body stream captures into the while
// node's body and ``*handle_out`` holds the node's condition handle.
extern "C" int rtjax_loop_begin(void* stream, void* body_stream,
                                const void* pred, void* k, void* total,
                                int max, unsigned long long* handle_out) {
  int version = 0;
  cudaError_t e = cudaRuntimeGetVersion(&version);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (version < 12040) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStream_t b = static_cast<cudaStream_t>(body_stream);
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  e = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureUnmatched);
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  set_loop<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred),
                           static_cast<int*>(k),
                           static_cast<long long*>(total), max, 1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamBeginCaptureToGraph(b, params.conditional.phGraph_out[0],
                                    nullptr, nullptr, 0,
                                    cudaStreamCaptureModeRelaxed);
  if (e != cudaSuccess) return static_cast<int>(e);
  *handle_out = handle;
  return 0;
}

// The body's last node, then the end of its capture.
extern "C" int rtjax_loop_end(void* body_stream, unsigned long long handle,
                              const void* pred, void* k, void* total,
                              int max) {
  cudaStream_t b = static_cast<cudaStream_t>(body_stream);
  set_loop<<<1, 1, 0, b>>>(handle, static_cast<const bool*>(pred),
                           static_cast<int*>(k),
                           static_cast<long long*>(total), max, 0);
  cudaError_t e = cudaGetLastError();
  cudaGraph_t body = nullptr;
  const cudaError_t e2 = cudaStreamEndCapture(b, &body);
  return static_cast<int>(e != cudaSuccess ? e : e2);
}

// A stream of its own for the loop bodies' capture: created here, not
// drawn from PyTorch's round-robin stream pool, whose streams may be the
// very stream under capture.
extern "C" int rtjax_loop_stream(void** stream_out) {
  cudaStream_t s = nullptr;
  const cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *stream_out = s;
  return static_cast<int>(e);
}
