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
//   gl_census(graph, bodies, n_bodies, out, cap, need)
//       counts the nodes of a graph by type (kernel; memcpy by direction;
//       memset; host; conditional; event record and wait; empty; child
//       graph; memory alloc and free), the kernel nodes also by function
//       name, recursing into child graphs, then adds the nodes of the
//       `n_bodies` while bodies in `bodies` (those gl_while_begin returned
//       while the graph was captured; counted as "while_body", each
//       walked once, not through its conditional node, which the driver
//       does not lead back to).  Writes "key\tcount\n" lines
//       to `out` (`cap` bytes, NUL-terminated) and the bytes needed to
//       `need`; returns -1 if they do not fit.  It reads the graph
//       through the driver (entry points found by the runtime), so a
//       kernel launched by another runtime (PyTorch's, or another
//       library of the port's) is named too; a memcpy's direction is
//       its sides' memory types.  A query that fails is counted as
//       "error:<call>:<code>", never skipped in silence.
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
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstring>
#include <map>
#include <string>
#include <vector>

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

// The driver calls of the census, looked up through the runtime (the
// library links no libcuda); nullptr where the driver lacks one.
struct Driver {
  CUresult (*get_nodes)(CUgraph, CUgraphNode*, size_t*) = nullptr;
  CUresult (*node_type)(CUgraphNode, CUgraphNodeType*) = nullptr;
  CUresult (*kernel_params)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS_v2*) =
      nullptr;
  CUresult (*memcpy_params)(CUgraphNode, CUDA_MEMCPY3D*) = nullptr;
  CUresult (*child_graph)(CUgraphNode, CUgraph*) = nullptr;
  CUresult (*func_name)(const char**, CUfunction) = nullptr;
  CUresult (*kernel_name)(const char**, CUkernel) = nullptr;
  CUresult (*pointer_attr)(void*, CUpointer_attribute, CUdeviceptr) =
      nullptr;
};

template <typename T>
cudaError_t driver_entry(const char* symbol, T* fn) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      symbol, &p, 12030, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint(symbol, &p, cudaEnableDefault,
                                            &found);
#endif
  if (err == cudaSuccess && (found != cudaDriverEntryPointSuccess || !p)) {
    err = cudaErrorNotSupported;
  }
  *fn = err == cudaSuccess ? reinterpret_cast<T>(p) : nullptr;
  return err;
}

using Counts = std::map<std::string, long long>;

void note_error(Counts& counts, const char* api, int code) {
  ++counts[std::string("error:") + api + ":" + std::to_string(code)];
}

// A kernel node's function name (func, else kern); "?" when the driver
// names neither.
std::string kernel_name(const Driver& drv, CUgraphNode node,
                        Counts& counts) {
  const char* name = nullptr;
  CUDA_KERNEL_NODE_PARAMS_v2 kp;
  std::memset(&kp, 0, sizeof(kp));
  CUresult res = drv.kernel_params(node, &kp);
  if (res != CUDA_SUCCESS) {
    note_error(counts, "cuGraphKernelNodeGetParams", res);
    return "?";
  }
  if (kp.func != nullptr) {
    res = drv.func_name(&name, kp.func);
    if (res == CUDA_SUCCESS && name) return name;
    note_error(counts, "cuFuncGetName", res);
  }
  if (kp.kern != nullptr && drv.kernel_name != nullptr) {
    res = drv.kernel_name(&name, kp.kern);
    if (res == CUDA_SUCCESS && name) return name;
    note_error(counts, "cuKernelGetName", res);
  }
  return "?";
}

// 1 host, 2 device, 0 unknown: one side of a memcpy node.
int memory_space(const Driver& drv, CUmemorytype type, const void* host,
                 CUdeviceptr dev) {
  switch (type) {
    case CU_MEMORYTYPE_HOST: return 1;
    case CU_MEMORYTYPE_DEVICE: return 2;
    case CU_MEMORYTYPE_UNIFIED: {
      unsigned int kind = 0;
      const CUresult res = drv.pointer_attr(
          &kind, CU_POINTER_ATTRIBUTE_MEMORY_TYPE,
          dev ? dev : reinterpret_cast<CUdeviceptr>(host));
      if (res == CUDA_ERROR_INVALID_VALUE) return 1;   // pageable host
      if (res != CUDA_SUCCESS) return 0;
      return kind == CU_MEMORYTYPE_HOST ? 1 : 2;
    }
    default: return 0;
  }
}

const char* memcpy_key(const Driver& drv, CUgraphNode node, Counts& counts) {
  CUDA_MEMCPY3D p;
  std::memset(&p, 0, sizeof(p));
  const CUresult res = drv.memcpy_params(node, &p);
  if (res != CUDA_SUCCESS) {
    note_error(counts, "cuGraphMemcpyNodeGetParams", res);
    return "memcpy_unknown";
  }
  const int src = memory_space(drv, p.srcMemoryType, p.srcHost, p.srcDevice);
  const int dst = memory_space(drv, p.dstMemoryType, p.dstHost, p.dstDevice);
  if (src == 0 || dst == 0) return "memcpy_unknown";
  if (src == 1) return dst == 1 ? "memcpy_htoh" : "memcpy_htod";
  return dst == 1 ? "memcpy_dtoh" : "memcpy_dtod";
}

void census_graph(const Driver& drv, CUgraph graph, Counts& counts,
                  int depth) {
  size_t n = 0;
  CUresult res = depth > 8 ? CUDA_ERROR_INVALID_VALUE
                           : drv.get_nodes(graph, nullptr, &n);
  std::vector<CUgraphNode> nodes(n);
  if (res == CUDA_SUCCESS && n) res = drv.get_nodes(graph, nodes.data(), &n);
  if (res != CUDA_SUCCESS) {
    note_error(counts, "cuGraphGetNodes", res);
    return;
  }
  for (CUgraphNode node : nodes) {
    CUgraphNodeType type;
    res = drv.node_type(node, &type);
    if (res != CUDA_SUCCESS) {
      note_error(counts, "cuGraphNodeGetType", res);
      continue;
    }
    switch (type) {
      case CU_GRAPH_NODE_TYPE_KERNEL:
        ++counts["kernel"];
        ++counts["kernel:" + kernel_name(drv, node, counts)];
        break;
      case CU_GRAPH_NODE_TYPE_MEMCPY:
        ++counts["memcpy"];
        ++counts[memcpy_key(drv, node, counts)];
        break;
      case CU_GRAPH_NODE_TYPE_MEMSET: ++counts["memset"]; break;
      case CU_GRAPH_NODE_TYPE_HOST: ++counts["host"]; break;
      case CU_GRAPH_NODE_TYPE_EMPTY: ++counts["empty"]; break;
      case CU_GRAPH_NODE_TYPE_WAIT_EVENT: ++counts["event_wait"]; break;
      case CU_GRAPH_NODE_TYPE_EVENT_RECORD: ++counts["event_record"]; break;
      case CU_GRAPH_NODE_TYPE_MEM_ALLOC: ++counts["mem_alloc"]; break;
      case CU_GRAPH_NODE_TYPE_MEM_FREE: ++counts["mem_free"]; break;
      case CU_GRAPH_NODE_TYPE_GRAPH: {
        ++counts["child_graph"];
        CUgraph child = nullptr;
        res = drv.child_graph(node, &child);
        if (res != CUDA_SUCCESS) {
          note_error(counts, "cuGraphChildGraphNodeGetGraph", res);
        } else {
          census_graph(drv, child, counts, depth + 1);
        }
        break;
      }
      case CU_GRAPH_NODE_TYPE_CONDITIONAL: ++counts["conditional"]; break;
      default: ++counts["other"]; break;
    }
  }
}

}  // namespace

extern "C" int gl_census(void* graph, void* const* bodies,
                         long long n_bodies, char* out, long long cap,
                         long long* need) {
  Driver drv;
  cudaFree(nullptr);      // the primary context current on this thread
  cudaError_t err = driver_entry("cuGraphGetNodes", &drv.get_nodes);
  if (err == cudaSuccess) err = driver_entry("cuGraphNodeGetType",
                                             &drv.node_type);
  if (err == cudaSuccess) err = driver_entry("cuGraphKernelNodeGetParams",
                                             &drv.kernel_params);
  if (err == cudaSuccess) err = driver_entry("cuGraphMemcpyNodeGetParams",
                                             &drv.memcpy_params);
  if (err == cudaSuccess) err = driver_entry("cuGraphChildGraphNodeGetGraph",
                                             &drv.child_graph);
  if (err == cudaSuccess) err = driver_entry("cuFuncGetName", &drv.func_name);
  if (err == cudaSuccess) err = driver_entry("cuPointerGetAttribute",
                                             &drv.pointer_attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  driver_entry("cuKernelGetName", &drv.kernel_name);   // optional
  cudaGetLastError();
  Counts counts;
  census_graph(drv, static_cast<CUgraph>(graph), counts, 0);
  for (long long i = 0; i < n_bodies; ++i) {
    ++counts["while_body"];
    census_graph(drv, static_cast<CUgraph>(bodies[i]), counts, 1);
  }
  std::string text;
  for (const auto& kv : counts) {
    text += kv.first;
    text += '\t';
    text += std::to_string(kv.second);
    text += '\n';
  }
  *need = static_cast<long long>(text.size()) + 1;
  if (*need > cap) return -1;
  std::memcpy(out, text.c_str(), text.size() + 1);
  return 0;
}

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
