// Greedy NMS keep mask for Hopper (sm_90a).
//
// K6 nms_keep_kernel (rvt_nms_keep)
//   No Pallas kernel stands behind it: the JAX package computes the keep
//   mask as a device while_loop (roadvision_tpu/ops/nms.py::nms_single,
//   :99), a Jacobi fixpoint that the port's plain version
//   (ops/nms.py::greedy_keep_plain) runs with one host read a round.
//   This kernel runs the sequential greedy instead, which has the same
//   fixpoint (the JAX module docstring, nms.py:10-14): candidates in
//   score order, each kept unless an earlier kept one overlaps it.
//   Bound: latency. The bytes are k·k + 2·k a problem (90.6 KB at
//   k = 300, 0.027 us at 3.35 TB/s); the sequential walk over k
//   candidates is the critical path. Design: one block per problem. All
//   warps first pack the (k, k) overlap bytes into a bit matrix in shared
//   memory (one __ballot_sync per 32 columns of a row, reads coalesced);
//   then one warp walks the candidates in order, each lane holding one
//   32-bit word of the "suppressed" set: a candidate is read from the
//   lane that holds its bit, and a kept candidate ORs its overlap row
//   into the set. The overlap test itself (iou > iou_thres) stays in
//   torch, so this kernel and the plain version read the same booleans.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;

__global__ void nms_keep_kernel(const uint8_t* __restrict__ over,
                                const uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ keep, int k,
                                int words) {
  extern __shared__ uint32_t bits[];                   // k x words
  uint8_t* val = (uint8_t*)(bits + (size_t)k * words); // k
  const int b = blockIdx.x;
  const uint8_t* ov = over + (size_t)b * k * k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = threadIdx.x; i < k; i += blockDim.x)
    val[i] = valid[(size_t)b * k + i];
  for (int i = warp; i < k; i += nwarps) {
    for (int w = 0; w < words; ++w) {
      const int j = w * 32 + lane;
      const bool o = j < k && ov[(size_t)i * k + j];
      const uint32_t word = __ballot_sync(0xffffffffu, o);
      if (lane == 0) bits[(size_t)i * words + w] = word;
    }
  }
  __syncthreads();

  if (warp == 0) {
    uint32_t removed = 0;             // lane w: candidates 32w .. 32w+31
    for (int i = 0; i < k; ++i) {
      const uint32_t word = __shfl_sync(0xffffffffu, removed, i >> 5);
      const bool kept = val[i] && !((word >> (i & 31)) & 1u);
      if (kept && lane < words) removed |= bits[(size_t)i * words + lane];
      if (lane == 0) keep[(size_t)b * k + i] = kept;
    }
  }
}

size_t keep_allowed[MAX_DEVICES];

}  // namespace

extern "C" int rvt_nms_keep(const void* over, const void* valid, void* keep,
                            int b, int k, void* stream) {
  if (b < 1 || k < 1 || k > 1024) return (int)cudaErrorInvalidValue;
  const int words = (k + 31) / 32;
  const size_t smem = sizeof(uint32_t) * (size_t)k * words + k;
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (keep_allowed[dev] < smem) {
      err = cudaFuncSetAttribute((const void*)nms_keep_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      keep_allowed[dev] = smem;
    }
  }
  nms_keep_kernel<<<b, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)over, (const uint8_t*)valid, (uint8_t*)keep, k, words);
  return (int)cudaGetLastError();
}
