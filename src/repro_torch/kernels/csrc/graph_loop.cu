// CUDA while nodes for the port's splice loops, hand-written for Hopper
// (sm_90a).
//
// Replaces the loop test of the reference's three splice lax.while_loops:
// the `cond` of repro/core/phase1.py:322-336 (Phase 1), of
// repro/core/phase3.py:368-371 (the replicated Phase 3) and of
// repro/core/phase3.py:706 (the sharded one).  A round runs while its
// `changed` flag holds anywhere and fewer than `rounds` rounds ran.  XLA
// keeps such a loop inside one program on the TPU; here it is one
// conditional node of type cudaGraphCondTypeWhile inside the fused run's
// CUDA graph, whose condition loop_condition_kernel sets on the device, so
// a replay stops at convergence with no host read.
//
// C interface, called through ctypes on streams of PyTorch's runtime
// (streams, graphs and conditional handles belong to the CUDA context, not
// to a runtime, so they pass between PyTorch's shared cudart and the
// static one linked here):
//
//   gl_load()
//       loads the kernel's module now: with lazy loading its first launch
//       would otherwise load it in the middle of a capture.
//   gl_while_begin(stream, changed, n, ctr, rounds, &body, &handle)
//       on `stream`, which is being captured: creates a conditional handle
//       on the capture's graph, captures loop_condition_kernel for the
//       first test (ctr = 0; handle = any(changed[0:n]) && 0 < rounds),
//       adds a while node after it and makes that node the stream's only
//       capture dependency.  Returns the node's body graph and its handle.
//   gl_body_begin(child, body)
//       starts capturing stream `child` into the body graph, in
//       thread-local mode: what the caller now issues on `child` is one
//       round.
//   gl_body_end(child, handle, changed, n, ctr, rounds)
//       captures loop_condition_kernel as the body's last node (ctr += 1;
//       handle = any(changed) && ctr < rounds), then ends the body's
//       capture, also when that launch failed.
//
// So the node runs no round when the flag starts false or `rounds` is 0,
// and otherwise rounds until one clears the flag or `rounds` ran; `ctr`
// ends at the number of rounds run.  That is the trip rule of the eager
// loop in core/capture.py::converge and of the reference's `cond`; the
// kernel's plain twin is kernels/ref.py::loop_condition_ref.
//
// Bound: bytes.  One test reads n flag bytes and the counter and writes
// the counter: n + 8 bytes (16 for Phase 1's 8 partition rows, 9 for
// Phase 3's single flag), picoseconds at 3.35 TB/s.  What the test costs
// on the card is its launch inside the node, once a round, beside the
// node's own relaunch of the body; PERF.md gives both as one measured
// time a round.
//
// Design: one warp.  The flags are OR-ed by __any_sync over a strided
// read (n is the partition count or 1); lane 0 writes the counter and
// sets the condition.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void loop_condition_kernel(const unsigned char* __restrict__ changed,
                                      long long n, int* __restrict__ ctr,
                                      int rounds,
                                      cudaGraphConditionalHandle handle,
                                      int first) {
  int any = 0;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    any |= changed[i] != 0;
  }
  any = __any_sync(0xffffffffu, any);
  if (threadIdx.x == 0) {
    const int ran = first ? 0 : *ctr + 1;
    *ctr = ran;
    cudaGraphSetConditional(handle, any && ran < rounds ? 1u : 0u);
  }
}

// The graph that `s` is being captured into and its current capture
// dependencies; an error unless the capture is active.
cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, n_deps);
#endif
  if (err == cudaSuccess && status != cudaStreamCaptureStatusActive) {
    err = cudaErrorIllegalState;
  }
  return err;
}

void launch_condition(cudaStream_t s, const void* changed, long long n,
                      void* ctr, int rounds,
                      cudaGraphConditionalHandle handle, int first) {
  loop_condition_kernel<<<1, kThreads, 0, s>>>(
      static_cast<const unsigned char*>(changed), n, static_cast<int*>(ctr),
      rounds, handle, first);
}

}  // namespace

extern "C" const char* gl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int gl_load() {
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, loop_condition_kernel));
}

extern "C" int gl_while_begin(void* stream, const void* changed, long long n,
                              void* ctr, int rounds, void** body_out,
                              unsigned long long* handle_out) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capture_info(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle handle = 0;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_condition(s, changed, n, ctr, rounds, handle, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = capture_info(s, &graph, &deps, &n_deps);   // now the test kernel
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node = nullptr;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  *body_out = params.conditional.phGraph_out[0];
  *handle_out = handle;
  return 0;
}

extern "C" int gl_body_begin(void* child, void* body) {
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(child), static_cast<cudaGraph_t>(body),
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal));
}

extern "C" int gl_body_end(void* child, unsigned long long handle,
                           const void* changed, long long n, void* ctr,
                           int rounds) {
  const cudaStream_t s = static_cast<cudaStream_t>(child);
  launch_condition(s, changed, n, ctr, rounds, handle, 0);
  const cudaError_t launched = cudaGetLastError();
  cudaGraph_t body = nullptr;
  const cudaError_t ended = cudaStreamEndCapture(s, &body);
  return static_cast<int>(launched != cudaSuccess ? launched : ended);
}
