// Greedy NMS keep mask for Hopper (sm_90a).
//
// K6 nms_keep (rvt_nms_keep_boxes, rvt_nms_keep)
//   No Pallas kernel stands behind it: the JAX package computes the keep
//   mask as a device while_loop (roadvision_tpu/ops/nms.py::nms_single,
//   :99), a Jacobi fixpoint that the port's plain version
//   (ops/nms.py::greedy_keep_plain) runs with one host read a round.
//   This kernel runs the sequential greedy instead, which has the same
//   fixpoint (the JAX module docstring, nms.py:10-14): candidates in
//   score order, each kept unless an earlier kept one overlaps it. Two
//   modes under one name:
//   * boxes mode (rvt_nms_keep_boxes), the YOLO detectors' nms_batch,
//     computes in the same launch what nms.py:80-99 computes: the class
//     offset cls * MAX_WH + box, the IoU in the order of
//     ops/nms.py::iou_matrix_xyxy (box_iou.cuh), "> iou_thres" and the
//     greedy keep, so greedy_keep_boxes_plain gives the same bits;
//   * matrix mode (rvt_nms_keep) takes the (k, k) overlap booleans of a
//     caller that tests overlap its own way (the rotated NMS of obb).
//   Bound: latency. A frame's boxes are 7.2 KB at k = 300 (2 ns at
//   3.35 TB/s); the walk over the candidates in order is the critical
//   path. Design, boxes mode: one block a frame holds the frame's boxes,
//   offset and their areas in shared memory; the warps compute the
//   overlap bits of the valid rows, a row from its own 32-bit word on
//   (an earlier column is decided before the row matters), one
//   __ballot_sync per 32 columns and a word with no valid column skipped;
//   no (k, k) matrix exists outside shared memory. Matrix mode: a pack
//   pass spreads the (row, word) units of every frame over the card, one
//   thread a unit, reading its 32 bytes with independent 16-byte loads
//   (no load waits on another); then a block a frame copies its packed
//   rows from L2 into shared memory. The walk, both modes: one warp, lane
//   w holding word w of the suppressed set; a word's remaining candidates
//   are its valid bits not yet suppressed, taken lowest first, each kept
//   one ORing its row into the set, so a suppressed or invalid candidate
//   costs nothing and only kept ones cost a step. Built with --fmad=false:
//   cls * 7680 + x and area + area - inter must not fuse.

#include <cuda_runtime.h>
#include <stdint.h>

#include "box_iou.cuh"

namespace {

constexpr int KEEP_THREADS = 1024;
constexpr int WALK_THREADS = 256;
constexpr int PACK_THREADS = 256;
constexpr int MAX_DEVICES = 64;
constexpr int MAX_K = 1024;            // one warp holds the suppressed set
constexpr float MAX_WH = 7680.0f;      // ops/nms.py::MAX_WH

// warp 0's walk: bits (k, words) overlap rows, valid the words of valid
// candidates → kept the words of kept ones. A row's words before its own
// word are never read into a live word of the set.
__device__ void keep_walk(const uint32_t* bits, const uint32_t* valid,
                          uint32_t* kept, int words, int lane) {
  uint32_t removed = 0;                // lane w: candidates 32w .. 32w+31
  for (int w = 0; w < words; ++w) {
    uint32_t cand = valid[w] & ~__shfl_sync(0xffffffffu, removed, w);
    uint32_t got = 0;
    while (cand) {
      const int b = __ffs(cand) - 1;
      const uint32_t* row = bits + (size_t)((w << 5) + b) * words;
      got |= 1u << b;
      if (lane > w && lane < words) removed |= row[lane];
      cand &= ~row[w] & ~(1u << b);
    }
    if (lane == 0) kept[w] = got;
  }
}

__device__ __forceinline__ void write_keep(const uint32_t* kept,
                                           uint8_t* keep, int k) {
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    keep[i] = (kept[i >> 5] >> (i & 31)) & 1u;
}

__global__ void __launch_bounds__(KEEP_THREADS)
nms_keep_boxes_kernel(const float* __restrict__ boxes,
                      const int32_t* __restrict__ cls,
                      const uint8_t* __restrict__ valid,
                      uint8_t* __restrict__ keep, int k, int words,
                      float thresh) {
  extern __shared__ __align__(16) uint32_t sm[];
  uint32_t* bits = sm;                                  // k x words
  uint32_t* vw = bits + (size_t)k * words;              // words
  uint32_t* kept = vw + words;                          // words
  float* bx = reinterpret_cast<float*>(kept + words);   // x1 y1 x2 y2 area
  const int f = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  boxes += (size_t)f * k * 4;
  cls += (size_t)f * k;
  valid += (size_t)f * k;

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float off = (float)cls[i] * MAX_WH;
    const float x1 = boxes[4 * i] + off, y1 = boxes[4 * i + 1] + off;
    const float x2 = boxes[4 * i + 2] + off, y2 = boxes[4 * i + 3] + off;
    bx[i] = x1;
    bx[k + i] = y1;
    bx[2 * k + i] = x2;
    bx[3 * k + i] = y2;
    bx[4 * k + i] = rvt::box_area(x1, y1, x2, y2);
  }
  for (int w = warp; w < words; w += nwarps) {
    const int j = (w << 5) + lane;
    const uint32_t b = __ballot_sync(0xffffffffu, j < k && valid[j]);
    if (lane == 0) vw[w] = b;
  }
  __syncthreads();

  for (int i = warp; i < k; i += nwarps) {
    if (!((vw[i >> 5] >> (i & 31)) & 1u)) continue;
    const float ax1 = bx[i], ay1 = bx[k + i], ax2 = bx[2 * k + i],
                ay2 = bx[3 * k + i], aa = bx[4 * k + i];
    for (int w = i >> 5; w < words; ++w) {
      uint32_t b = 0;
      if (vw[w]) {                             // the whole warp skips
        const int j = (w << 5) + lane;
        const bool o = j < k &&
            rvt::box_iou(ax1, ay1, ax2, ay2, aa, bx[j], bx[k + j],
                         bx[2 * k + j], bx[3 * k + j], bx[4 * k + j]) >
                thresh;
        b = __ballot_sync(0xffffffffu, o);
      }
      if (lane == 0) bits[(size_t)i * words + w] = b;
    }
  }
  __syncthreads();
  if (warp == 0) keep_walk(bits, vw, kept, words, lane);
  __syncthreads();
  write_keep(kept, keep + (size_t)f * k, k);
}

// four 0/1 bytes → four bits, the first byte lowest
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
  x = __vsetne4(x, 0u);
  return (x | (x >> 7) | (x >> 14) | (x >> 21)) & 15u;
}

// one thread a (row, word) unit of every frame's valid rows: the 32 bytes
// over[row, 32w .. 32w + 31] → one word, from 16-byte loads of the aligned
// window that holds them
__global__ void __launch_bounds__(PACK_THREADS)
nms_pack_kernel(const uint8_t* __restrict__ over,
                const uint8_t* __restrict__ valid,
                uint32_t* __restrict__ packed, int rows, int k, int words) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int r = (int)(u / words);
  if (r >= rows || !valid[r]) return;
  const int w = (int)(u - (long long)r * words);
  const int n = k - 32 * w < 32 ? k - 32 * w : 32;
  const uintptr_t s = reinterpret_cast<uintptr_t>(over + (size_t)r * k) +
                      32 * w;
  const uintptr_t a = s & ~(uintptr_t)15;
  uint64_t m = 0;                      // bit q: byte a + q
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const uintptr_t at = a + 16 * q;
    if (at < s + n) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(at));
      m |= (uint64_t)(nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 |
                      nibble(v.w) << 12)
           << (16 * q);
    }
  }
  uint32_t word = (uint32_t)(m >> (s - a));
  if (n < 32) word &= (1u << n) - 1u;
  packed[(size_t)r * words + w] = word;
}

__global__ void __launch_bounds__(WALK_THREADS)
nms_walk_kernel(const uint32_t* __restrict__ packed,
                const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, int k, int words) {
  extern __shared__ __align__(16) uint32_t sm[];
  uint32_t* bits = sm;                                  // k x words
  uint32_t* vw = bits + (size_t)k * words;              // words
  uint32_t* kept = vw + words;                          // words
  const int f = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t n = (size_t)k * words;
  packed += (size_t)f * n;
  valid += (size_t)f * k;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) bits[i] = packed[i];
  for (int w = warp; w < words; w += blockDim.x >> 5) {
    const int j = (w << 5) + lane;
    const uint32_t b = __ballot_sync(0xffffffffu, j < k && valid[j]);
    if (lane == 0) vw[w] = b;
  }
  __syncthreads();
  if (warp == 0) keep_walk(bits, vw, kept, words, lane);
  __syncthreads();
  write_keep(kept, keep + (size_t)f * k, k);
}

size_t keep_allowed[2][MAX_DEVICES];

int allow_smem(const void* fn, size_t* done, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (done[dev] >= bytes) return 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done[dev] = bytes;
  return (int)err;
}

}  // namespace

// boxes mode: boxes (b, k, 4) f32, cls (b, k) i32, valid (b, k) u8 →
// keep (b, k) u8
extern "C" int rvt_nms_keep_boxes(const void* boxes, const void* cls,
                                  const void* valid, void* keep, int b,
                                  int k, float thresh, void* stream) {
  if (b < 1 || k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  const int words = (k + 31) / 32;
  const size_t smem = 4 * ((size_t)k * words + 2 * words + 5 * (size_t)k);
  int err = allow_smem((const void*)nms_keep_boxes_kernel, keep_allowed[0],
                       smem);
  if (err) return err;
  nms_keep_boxes_kernel<<<b, KEEP_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)boxes, (const int32_t*)cls, (const uint8_t*)valid,
      (uint8_t*)keep, k, words, thresh);
  return (int)cudaGetLastError();
}

// matrix mode: over (b, k, k) u8, valid (b, k) u8 → keep (b, k) u8;
// ``packed`` (b, k, ceil(k / 32)) u32 is the wrapper's scratch
extern "C" int rvt_nms_keep(const void* over, const void* valid, void* keep,
                            void* packed, int b, int k, void* stream) {
  if (b < 1 || k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  const int words = (k + 31) / 32;
  const long long units = (long long)b * k * words;
  if (units > 0x7fffffffLL * PACK_THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * ((size_t)k * words + 2 * words);
  int err = allow_smem((const void*)nms_walk_kernel, keep_allowed[1], smem);
  if (err) return err;
  nms_pack_kernel<<<(unsigned)((units + PACK_THREADS - 1) / PACK_THREADS),
                    PACK_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)over, (const uint8_t*)valid, (uint32_t*)packed, b * k,
      k, words);
  err = (int)cudaGetLastError();
  if (err) return err;
  nms_walk_kernel<<<b, WALK_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)packed, (const uint8_t*)valid, (uint8_t*)keep, k,
      words);
  return (int)cudaGetLastError();
}
