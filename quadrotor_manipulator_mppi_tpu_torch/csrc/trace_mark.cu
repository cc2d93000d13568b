// Stage marks of the tracer (utils/profiling.py) for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: it was added so that a step captured in a CUDA
// graph can say where its time goes.  A CUDA-graph replay runs no Python,
// so a host range around a part of the step (record_function) shows one
// range per replay; a mark is a node of the graph instead, and every replay
// stamps it.
//
// One thread reads %globaltimer (nanoseconds, one clock for the whole card)
// when the kernel starts, i.e. once the stream's previous op has finished,
// and writes it into a ring of (rows, marks) int64 stamps at the current
// row, column ID.  The row is a counter on the card: a mark whose column in
// the current row is already stamped starts the next row (zeroed first), so
// the first mark of each call (graph.begin in a graph) advances it, and the
// caller's solve index is not needed.  A stamp of 0 means "not stamped".
//
// What bounds it: nothing but its launch (~1-1.5 us as a graph node); it
// reads and writes a few bytes.  The kernel is templated on the mark id so
// that each mark shows up in a profiler trace under its own name.

#include <cuda_runtime.h>
#include <stdint.h>
#include <time.h>

#define TM_MAX_MARKS 32  // template instances; utils/profiling.MAX_MARKS

template <int ID>
__global__ void trace_mark(long long* ring, long long* row, int rows, int marks) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long r = *row;
  long long* slot = ring + (r % rows) * marks;
  if (slot[ID] != 0) {
    r += 1;
    *row = r;
    slot = ring + (r % rows) * marks;
    for (int i = 0; i < marks; ++i) slot[i] = 0;
  }
  slot[ID] = (long long)now;
}

template <int ID>
static int launch_id(int id, long long* ring, long long* row, int rows, int marks,
                     cudaStream_t stream) {
  if constexpr (ID == TM_MAX_MARKS) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (id != ID) return launch_id<ID + 1>(id, ring, row, rows, marks, stream);
    trace_mark<ID><<<1, 1, 0, stream>>>(ring, row, rows, marks);
    return (int)cudaGetLastError();
  }
}

extern "C" {

// One mark of id `id` (0 <= id < marks <= TM_MAX_MARKS) into the ring
// (rows, marks) at the row counter `row`.  Returns cudaGetLastError() after
// the launch.
int trace_mark_launch(void* ring, void* row, int rows, int marks, int id, void* stream) {
  if (rows <= 0 || marks <= 0 || marks > TM_MAX_MARKS || id < 0 || id >= marks)
    return (int)cudaErrorInvalidValue;
  return launch_id<0>(id, (long long*)ring, (long long*)row, rows, marks,
                      (cudaStream_t)stream);
}

// The clocks side by side: `pairs` marks of id 0 into `ring` (pairs, 1),
// each between two host stamps (CLOCK_MONOTONIC ns, Python's perf_counter)
// written to host[2i], host[2i + 1]: one just before its launch, one as
// soon as the stream has run it (polled, so no wake-up from a wait adds to
// the pair's width).  Returns the first CUDA error, or 0.
int trace_mark_pairs(void* ring, void* row, int pairs, void* stream, long long* host) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaStreamSynchronize(s);
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < pairs; ++i) {
    struct timespec a, b;
    clock_gettime(CLOCK_MONOTONIC, &a);
    trace_mark<0><<<1, 1, 0, s>>>((long long*)ring, (long long*)row, pairs, 1);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    while ((e = cudaStreamQuery(s)) == cudaErrorNotReady) {
    }
    if (e != cudaSuccess) return (int)e;
    clock_gettime(CLOCK_MONOTONIC, &b);
    host[2 * i] = a.tv_sec * 1000000000LL + a.tv_nsec;
    host[2 * i + 1] = b.tv_sec * 1000000000LL + b.tv_nsec;
  }
  return 0;
}

}  // extern "C"
