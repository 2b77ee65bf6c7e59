// Stage marks of the device step for Hopper (sm_90a).
//
// rvt_stage_mark_kernel<k> (rvt_stage_mark)
//   No TPU kernel stands behind it: the JAX package's step is one XLA
//   program whose stages the TPU profiler splits by HLO name. Here the
//   step is one replayed CUDA graph, and nothing in it told where one
//   stage ends. A mark is one thread that writes the card's global
//   nanosecond timer (%globaltimer) into stamps[k]. Launched on the
//   step's stream between two stages, it runs once the work queued
//   before it has finished and before the work queued after it starts,
//   so stamps[k + 1] - stamps[k] is stage k's device time. The same
//   timer dates the profiler's kernel records, so the marks line up with
//   a trace of the same replays.
//   Bound: one launch (a few microseconds in a graph); it moves 8 bytes.
//   The kernel is templated on the slot, so that each boundary has its
//   own name in a device trace (rvt_stage_mark_kernel<0> ... <3>).

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int STAGE_MARKS = 4;

template <int SLOT>
__global__ void rvt_stage_mark_kernel(long long* stamps) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  stamps[SLOT] = (long long)t;
}

extern "C" int rvt_stage_mark(void* stamps, int slot, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long* s = (long long*)stamps;
  switch (slot) {
    case 0: rvt_stage_mark_kernel<0><<<1, 1, 0, st>>>(s); break;
    case 1: rvt_stage_mark_kernel<1><<<1, 1, 0, st>>>(s); break;
    case 2: rvt_stage_mark_kernel<2><<<1, 1, 0, st>>>(s); break;
    case 3: rvt_stage_mark_kernel<3><<<1, 1, 0, st>>>(s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  static_assert(STAGE_MARKS == 4, "one case a slot");
  return (int)cudaGetLastError();
}
