// Conditional nodes (IF and WHILE) inside a CUDA stream capture, for the
// one-launch solve (psulvsb_tpu_torch/solver/conditional.py).
//
// The counterpart of JAX's lax.cond and lax.while_loop on the device: a
// conditional node runs its body graph when (IF) or while (WHILE) its
// condition is non-zero. The condition is set on the device by a one-thread
// kernel that reads a bool flag in device memory, captured just before the
// node and, for a WHILE node, again at the end of its body. This is what
// PyTorch's CUDAGraph::begin_capture_to_if_node does in releases that have
// it: cudaStreamGetCaptureInfo, cudaGraphConditionalHandleCreate, the
// setting kernel, cudaGraphAddNode, cudaStreamUpdateCaptureDependencies and
// cudaStreamBeginCaptureToGraph on the body's stream.
//
// Plain C entry points for ctypes; each returns a cudaError_t (0 = success).

#include <cuda_runtime.h>

#if CUDART_VERSION < 12040
#error "conditional graph nodes need CUDA 12.4 or later"
#endif

#if CUDART_VERSION >= 13000
#define CAPTURE_INFO(s, st, g, d, n) cudaStreamGetCaptureInfo(s, st, nullptr, g, d, nullptr, n)
#define ADD_NODE(node, g, d, n, p) cudaGraphAddNode(node, g, d, nullptr, n, p)
#define SET_DEPENDENCIES(s, d, n) \
  cudaStreamUpdateCaptureDependencies(s, d, nullptr, n, cudaStreamSetCaptureDependencies)
#else
#define CAPTURE_INFO(s, st, g, d, n) cudaStreamGetCaptureInfo(s, st, nullptr, g, d, n)
#define ADD_NODE(node, g, d, n, p) cudaGraphAddNode(node, g, d, n, p)
#define SET_DEPENDENCIES(s, d, n) \
  cudaStreamUpdateCaptureDependencies(s, d, n, cudaStreamSetCaptureDependencies)
#endif

#define CHECK(call)                   \
  do {                                \
    cudaError_t err_ = (call);        \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

// Capture, on `stream`, the kernel that sets `handle`'s condition from the
// bool at `flag` when the graph runs.
extern "C" int graph_cond_set(unsigned long long handle, const void* flag, void* stream) {
  set_condition_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle), static_cast<const bool*>(flag));
  return static_cast<int>(cudaGetLastError());
}

// Add a conditional node (kind 0: IF, 1: WHILE) after the work captured so
// far on `parent`, with its condition set from `flag` just before it, make it
// the parent's only dependency, and begin capturing `body` into the node's
// body graph. Writes the condition's handle.
extern "C" int graph_cond_begin(void* parent, void* body, const void* flag, int kind,
                                unsigned long long* handle_out) {
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  CHECK(CAPTURE_INFO(ps, &status, &graph, &deps, &n_deps));
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorStreamCaptureImplicit);
  cudaGraphConditionalHandle handle;
  CHECK(cudaGraphConditionalHandleCreate(&handle, graph, 0, 0));
  CHECK(static_cast<cudaError_t>(graph_cond_set(handle, flag, parent)));
  CHECK(CAPTURE_INFO(ps, &status, &graph, &deps, &n_deps));

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = kind == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  CHECK(ADD_NODE(&node, graph, deps, n_deps, &params));
  CHECK(SET_DEPENDENCIES(ps, &node, 1));
  CHECK(cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body),
                                      params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                      cudaStreamCaptureModeRelaxed));
  *handle_out = static_cast<unsigned long long>(handle);
  return 0;
}

// End the capture of a body begun by graph_cond_begin; writes the number of
// nodes of the body graph (a conditional node inside it counts as one).
extern "C" int graph_cond_end(void* body, unsigned long long* nodes_out) {
  cudaGraph_t graph;
  CHECK(cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph));
  size_t n = 0;
  CHECK(cudaGraphGetNodes(graph, nullptr, &n));
  *nodes_out = n;
  return 0;
}

// The number of nodes in the graph that `stream` is capturing into.
extern "C" int graph_cond_capture_nodes(void* stream, unsigned long long* nodes_out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  CHECK(CAPTURE_INFO(static_cast<cudaStream_t>(stream), &status, &graph, &deps, &n_deps));
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorStreamCaptureImplicit);
  size_t n = 0;
  CHECK(cudaGraphGetNodes(graph, nullptr, &n));
  *nodes_out = n;
  return 0;
}

// The program's clock inside a graph (utils/timing.py): one thread reads
// %globaltimer, the card's nanosecond clock that every SM shares, and keeps
// it in a record of int64 words laid out as timing.SpanRecord describes:
//   [0, slots)            open: a span's start, written by its opening stamp;
//   [slots, 2 slots)      total: ns summed over the span's closings;
//   [2 slots, 3 slots)    count: closings;
//   3 slots + 0..3        solves (the ring's index), events logged, rounds, local batches;
//   3 slots + 4..         the counters of timing.STAMP_COUNTERS (thinned inits,
//                         uncertified scale peaks, refit counts);
//   then `cap` (start, end) pairs of slot 0 (the whole solve), one a solve,
//   then `log_cap` (slot * 2 + end, time) pairs, one a stamp.
// RECORD_HEAD is timing.RECORD_HEAD. A stamp past a ring's end is counted
// by its index and not kept. The closing stamp of slot 0 adds the solve's
// rounds and local batches, summed over its `pairs` pairs; a closing stamp
// given `values`, one a pair, adds to counter `counter` the pairs whose value
// is counted by `kind`: 0, an int64 above `fill`; 1, an int64 other than
// `other`'s; 2, a bool that is false. With cap = log_cap = 0 and end = 0 a
// stamp only writes the time to word `slot` (a log of stamps the host
// labels). A kernel node may sit inside IF and WHILE bodies, where a CUDA
// event may not.
#define RECORD_HEAD 7
#define RECORD_COUNTERS (RECORD_HEAD - 4)

__device__ bool counted(const void* values, const long long* other, long long fill, int kind,
                        int p) {
  if (kind == 2) return !static_cast<const bool*>(values)[p];
  long long v = static_cast<const long long*>(values)[p];
  return kind == 1 ? v != other[p] : v > fill;
}

__global__ void trace_stamp_kernel(long long* rec, int slot, int end, int slots, long long cap,
                                   long long log_cap, const long long* rounds,
                                   const long long* batches, const void* values,
                                   const long long* other, long long fill, int counter, int kind,
                                   int pairs) {
  long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (!end) {
    rec[slot] = now;
  } else {
    rec[slots + slot] += now - rec[slot];
    rec[2 * slots + slot] += 1;
  }
  long long* head = rec + 3 * slots;
  if (cap > 0 && slot == 0) {
    long long i = head[0];
    if (i < cap) head[RECORD_HEAD + 2 * i + end] = now;
    if (end) {
      head[0] = i + 1;
      long long r = 0, b = 0;
      for (int p = 0; p < pairs; ++p) {
        r += rounds[p];
        b += batches[p];
      }
      head[2] += r;
      head[3] += b;
    }
  }
  if (end && values != nullptr) {
    long long t = 0;
    for (int p = 0; p < pairs; ++p) t += counted(values, other, fill, kind, p) ? 1 : 0;
    head[4 + counter] += t;
  }
  if (log_cap > 0) {
    long long i = head[1];
    if (i < log_cap) {
      long long* event = head + RECORD_HEAD + 2 * cap + 2 * i;
      event[0] = 2 * slot + end;
      event[1] = now;
    }
    head[1] = i + 1;
  }
}

// Launch (or capture) one stamp on `stream`; see trace_stamp_kernel.
extern "C" int graph_cond_stamp(void* rec, int slot, int end, int slots, long long cap,
                                long long log_cap, const void* rounds, const void* batches,
                                const void* values, const void* other, long long fill,
                                int counter, int kind, int pairs, void* stream) {
  if (values != nullptr && (counter < 0 || counter >= RECORD_COUNTERS || kind < 0 || kind > 2 ||
                            (kind == 1 && other == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  trace_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(rec), slot, end, slots, cap, log_cap,
      static_cast<const long long*>(rounds), static_cast<const long long*>(batches), values,
      static_cast<const long long*>(other), fill, counter, kind, pairs);
  return static_cast<int>(cudaGetLastError());
}

// A stream of its own for a capture (PyTorch hands out its pooled streams
// round-robin, so two of those may be one stream).
extern "C" int graph_cond_stream_create(void** stream_out) {
  cudaStream_t stream;
  CHECK(cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking));
  *stream_out = stream;
  return 0;
}

extern "C" int graph_cond_stream_destroy(void* stream) {
  return static_cast<int>(cudaStreamDestroy(static_cast<cudaStream_t>(stream)));
}

extern "C" const char* graph_cond_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
