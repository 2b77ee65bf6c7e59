// Track-to-detection association loops for Hopper (sm_90a).
//
// No Pallas kernel stands behind these two: the JAX package runs both
// loops as device while_loops (roadvision_tpu/track/sort_tpu.py:227
// greedy, :300 auction), which PyTorch cannot express without reading a
// flag back to the host every round. Each kernel runs the whole loop of
// one problem inside one thread block, so a launch costs no host read
// and serves every problem that is ready (a leading problem axis P: the
// streams of a fleet, or one frame of one stream).
//
// K4 assoc_greedy_kernel (rvt_assoc_greedy, rvt_assoc_greedy_boxes)
//   Mutual-maximum rounds over a (T, D) score matrix until no pair is
//   mutual (sort_tpu.py:186-230), in two modes under one name:
//   * matrix mode (rvt_assoc_greedy) takes the scores, as
//     track/sort.py::greedy_associate_plain does (the hooked trackers'
//     IoU or fused costs) and gives det -> track;
//   * boxes mode (rvt_assoc_greedy_boxes) takes the predicted Kalman
//     means (T, 7) and the detections (D, 4) and computes in the same
//     launch what sort_tpu.py:498-508 computes: x_to_bbox, the IoU
//     matrix, the rounds and the inverse map track -> det, in the
//     arithmetic of track/sort.py::x_to_bbox / iou_matrix (box_iou.cuh),
//     so greedy_associate_boxes_plain gives the same bits.
//   Bound: latency. A 100 x 100 problem is 40 KB of scores (12 ns at
//   3.35 TB/s) and a few compares a cell a round; what costs is the chain
//   of rounds, each a scan, a barrier, a decision and a barrier.
//   Design: the masks become two bitsets in shared memory ("done" rows
//   and columns: dead, or taken in a round); a masked cell is never scanned
//   and the matrix is never rewritten. A dead row or column is left out
//   of the scans: the plain version's -1 there can never make a pair (a
//   pair needs a score above -0.5), nor change a maximum above -0.5, the
//   only maxima a pair is made of. One warp scans one row (or column):
//   the lanes take 32 columns (rows) of one bitset word at a time, a word
//   with no live bit is skipped by the whole warp, and a shuffle reduction
//   on (value, index) keeps the lower index on ties and counts NaN as the
//   maximum. After the first round only the rows and columns whose maximum
//   was taken are scanned again: the others keep their maximum, since the
//   live set only shrinks. Two barriers a round: the decision needs every
//   scan, the next scan every decision. The cells: where the (T, D | 1)
//   matrix fits in shared memory beside the rest (227 KB) it is cached
//   there (matrix mode: read once with 16-byte loads when rows are
//   16-byte aligned; boxes mode: the live cells computed once), the odd
//   row stride keeping a column scan free of bank conflicts; where it
//   does not (T = D = 300), matrix mode reads the scores in place through
//   L1 / L2 and boxes mode computes each cell again from the boxes, which
//   sit in shared memory, so no (T, D) matrix is ever written.
//
// K5 assoc_auction_kernel (rvt_assoc_auction)
//   Computes track/sort.py::auction_associate_plain: the parallel
//   epsilon-auction over D bidders and T + D columns (T tracks, D dummy
//   columns at -1) until no valid detection is unassigned or max_iters
//   rounds. Bound: latency, like K4. Design: one thread per bidder scans
//   its values (read from the IoU matrix, whose columns are the bidders:
//   neighbouring threads read neighbouring words) for the best and the
//   second best; one thread per column picks the highest bid (first index
//   on ties); prices and assignments stay in shared memory. Built with
//   --fmad=false; the arithmetic is the plain version's, in its order
//   ((v1 - v2) + eps, prices + bid), so the prices are bit-equal.


#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "box_iou.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GREEDY_THREADS = 1024;
constexpr int MAX_DEVICES = 64;
constexpr size_t SMEM_MAX = 232448;    // 227 KB a block
constexpr float NEG = -1e9f;           // an ineligible auction edge

// v at index i replaces the running maximum (bv at bi), scanning indices
// in increasing order: strictly greater wins, so the first index of the
// maximum stays; the first NaN wins and stays (NaN is the maximum).
__device__ __forceinline__ bool takes_over(float v, float bv) {
  return !isnan(bv) && (isnan(v) || v > bv);
}

// (v, i) ranks above (bv, bi) in any order of indices: NaN above every
// number, then the larger value, then the lower index
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  if (isnan(bv)) return isnan(v) && i < bi;
  return isnan(v) || v > bv || (v == bv && i < bi);
}

// the warp's first-index maximum, in every lane; (-inf, INT_MAX) is "none"
__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, bv, o);
    const int i = __shfl_xor_sync(0xffffffffu, bi, o);
    if (beats(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
}

__device__ __forceinline__ bool bit(const uint32_t* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

// K4. kBoxes: cells are IoUs of x_to_bbox(mean) against ``boxes``, else
// ``scores``; kCache: the cells are cached in shared memory (T x (D | 1)).
template <bool kBoxes, bool kCache>
__global__ void __launch_bounds__(GREEDY_THREADS)
assoc_greedy_kernel(const float* __restrict__ scores,
                    const float* __restrict__ mean,
                    const float* __restrict__ boxes,
                    const uint8_t* __restrict__ alive,
                    const uint8_t* __restrict__ dvalid,
                    int32_t* __restrict__ det2trk,
                    int32_t* __restrict__ trk2det, int T, int D,
                    float thresh) {
  extern __shared__ __align__(16) uint32_t greedy_smem[];
  const int ld = D | 1;
  const int tw = (T + 31) >> 5, dw = (D + 31) >> 5;
  float* cache = reinterpret_cast<float*>(greedy_smem);        // T x ld
  float* tb = cache + (kCache ? (size_t)T * ld : 0);   // x1 y1 x2 y2 area
  float* db = tb + (kBoxes ? 5 * T : 0);               // the same, D each
  float* rval = db + (kBoxes ? 5 * D : 0);             // T
  int* rbest = reinterpret_cast<int*>(rval + T);       // T
  int* t2d = rbest + T;                                // T
  int* cbest = t2d + T;                                // D
  int* d2t = cbest + D;                                // D
  uint32_t* rowdone = reinterpret_cast<uint32_t*>(d2t + D);   // tw
  uint32_t* coldone = rowdone + tw;                            // dw

  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  alive += (size_t)p * T;
  dvalid += (size_t)p * D;

  // the masks as "done" bitsets; the bits past T and D are done too
  for (int w = warp; w < tw + dw; w += nwarps) {
    const bool row = w < tw;
    const int i = ((row ? w : w - tw) << 5) + lane;
    const bool live = row ? (i < T && alive[i]) : (i < D && dvalid[i]);
    const uint32_t b = __ballot_sync(0xffffffffu, live);
    if (lane == 0) (row ? rowdone[w] : coldone[w - tw]) = ~b;
  }
  for (int t = tid; t < T; t += blockDim.x) {
    rbest[t] = -1;
    t2d[t] = -1;
  }
  for (int d = tid; d < D; d += blockDim.x) {
    cbest[d] = -1;
    d2t[d] = -1;
  }
  if constexpr (kBoxes) {
    // x_to_bbox: w = sqrt(clamp(s * r, 1e-6)), h = s / clamp(w, 1e-6)
    for (int t = tid; t < T; t += blockDim.x) {
      const float* m = mean + ((size_t)p * T + t) * 7;
      const float cx = m[0], cy = m[1], s = m[2], r = m[3];
      const float w = sqrtf(rvt::clamp_min(s * r, 1e-6f));
      const float h = s / rvt::clamp_min(w, 1e-6f);
      const float x1 = cx - 0.5f * w, y1 = cy - 0.5f * h;
      const float x2 = cx + 0.5f * w, y2 = cy + 0.5f * h;
      tb[t] = x1;
      tb[T + t] = y1;
      tb[2 * T + t] = x2;
      tb[3 * T + t] = y2;
      tb[4 * T + t] = rvt::box_area(x1, y1, x2, y2);
    }
    for (int d = tid; d < D; d += blockDim.x) {
      const float* b = boxes + ((size_t)p * D + d) * 4;
      db[d] = b[0];
      db[D + d] = b[1];
      db[2 * D + d] = b[2];
      db[3 * D + d] = b[3];
      db[4 * D + d] = rvt::box_area(b[0], b[1], b[2], b[3]);
    }
  }
  __syncthreads();

  const float* s = kBoxes ? nullptr : scores + (size_t)p * T * D;
  auto compute = [&](int t, int d) -> float {
    if constexpr (kBoxes)
      return rvt::box_iou(tb[t], tb[T + t], tb[2 * T + t], tb[3 * T + t],
                          tb[4 * T + t], db[d], db[D + d], db[2 * D + d],
                          db[3 * D + d], db[4 * D + d]);
    else
      return __ldg(s + (size_t)t * D + d);
  };
  if constexpr (kCache) {
    // the live rows once (boxes: their live cells only)
    const bool vec = !kBoxes && (D & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(s) & 15) == 0;
    for (int t = warp; t < T; t += nwarps) {
      if (bit(rowdone, t)) continue;
      float* dst = cache + (size_t)t * ld;
      if constexpr (kBoxes) {
        for (int w = 0; w < dw; ++w) {
          const uint32_t act = ~coldone[w];
          const int d = (w << 5) + lane;
          if ((act >> lane) & 1u) dst[d] = compute(t, d);
        }
      } else if (vec) {
        const float4* src = reinterpret_cast<const float4*>(s + (size_t)t * D);
        for (int q = lane; q < (D >> 2); q += 32) {
          const float4 v = __ldg(src + q);
          dst[4 * q] = v.x;
          dst[4 * q + 1] = v.y;
          dst[4 * q + 2] = v.z;
          dst[4 * q + 3] = v.w;
        }
      } else {
        for (int d = lane; d < D; d += 32) dst[d] = compute(t, d);
      }
    }
    __syncthreads();
  }
  auto cell = [&](int t, int d) -> float {
    return kCache ? cache[(size_t)t * ld + d] : compute(t, d);
  };

  const int rounds = (T < D ? T : D) + 1;
  for (int r = 0; r < rounds; ++r) {
    // the first-index maxima of the live rows and columns not yet known
    // or whose maximum was taken in the last round
    for (int task = warp; task < T + D; task += nwarps) {
      const bool row = task < T;
      const int i = row ? task : task - T;
      if (bit(row ? rowdone : coldone, i)) continue;
      if (r > 0) {
        const int b = row ? rbest[i] : cbest[i];
        if (b < 0 || !bit(row ? coldone : rowdone, b)) continue;
      }
      const uint32_t* other = row ? coldone : rowdone;
      const int words = row ? dw : tw;
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int w = 0; w < words; ++w) {
        const uint32_t act = ~other[w];
        if (!act) continue;                    // the whole warp skips
        const int j = (w << 5) + lane;
        if ((act >> lane) & 1u) {
          const float v = row ? cell(i, j) : cell(j, i);
          if (beats(v, j, bv, bi)) {
            bv = v;
            bi = j;
          }
        }
      }
      warp_argmax(bv, bi);
      if (lane == 0) {
        if (row) {
          rval[i] = bv;
          rbest[i] = bi == INT_MAX ? -1 : bi;
        } else {
          cbest[i] = bi == INT_MAX ? -1 : bi;
        }
      }
    }
    __syncthreads();
    // a row takes its column where each is the other's maximum; a
    // column's mutual row is unique (it is the column's argmax)
    int any = 0;
    for (int t = tid; t < T; t += blockDim.x) {
      if (bit(rowdone, t)) continue;
      const int d = rbest[t];
      if (d < 0) continue;
      const float v = rval[t];
      if (cbest[d] == t && v >= thresh && v > -0.5f) {
        atomicOr(&rowdone[t >> 5], 1u << (t & 31));
        atomicOr(&coldone[d >> 5], 1u << (d & 31));
        d2t[d] = t;
        t2d[t] = d;
        any = 1;
      }
    }
    if (!__syncthreads_or(any)) break;
  }
  for (int d = tid; d < D; d += blockDim.x)
    det2trk[(size_t)p * D + d] = d2t[d];
  if (trk2det != nullptr)
    for (int t = tid; t < T; t += blockDim.x)
      trk2det[(size_t)p * T + t] = t2d[t];
}

__global__ void assoc_auction_kernel(const float* __restrict__ iou,
                                     const uint8_t* __restrict__ alive,
                                     const uint8_t* __restrict__ dvalid,
                                     int32_t* __restrict__ out, int T, int D,
                                     float thresh, float eps, int max_iters) {
  extern __shared__ float smem[];
  const int C = T + D;
  float* prices = smem;                                // C
  float* incr = prices + C;                            // D
  int* winner = (int*)(incr + D);                      // C
  int* best = winner + C;                              // D
  int* assigned = best + D;                            // D
  uint8_t* has_bid = (uint8_t*)(assigned + D);         // C
  uint8_t* bidding = has_bid + C;                      // D
  uint8_t* al = bidding + D;                           // T
  uint8_t* dv = al + T;                                // D

  const int p = blockIdx.x;
  const float* s = iou + (size_t)p * T * D;            // (T, D): s[c*D + d]
  const int tid = threadIdx.x;
  for (int c = tid; c < C; c += blockDim.x) prices[c] = 0.0f;
  for (int t = tid; t < T; t += blockDim.x) al[t] = alive[(size_t)p * T + t];
  for (int d = tid; d < D; d += blockDim.x) {
    dv[d] = dvalid[(size_t)p * D + d];
    assigned[d] = -1;
  }
  __syncthreads();

  int open = 0;
  for (int d = tid; d < D; d += blockDim.x) open |= dv[d] && assigned[d] < 0;
  open = __syncthreads_or(open);
  for (int it = 0; it < max_iters && open; ++it) {
    // each bidder: best column, its value, the best of the rest
    for (int d = tid; d < D; d += blockDim.x) {
      float v1 = 0.0f;
      int bc = 0;
      for (int c = 0; c < C; ++c) {
        const float w = c < T ? ((al[c] && dv[d]) ? s[(size_t)c * D + d] : NEG)
                              : -1.0f;
        const float v = w - prices[c];
        if (c == 0 || takes_over(v, v1)) { v1 = v; bc = c; }
      }
      float v2 = 0.0f;
      for (int c = 0; c < C; ++c) {
        float v;
        if (c == bc) {
          v = NEG;
        } else {
          const float w = c < T
              ? ((al[c] && dv[d]) ? s[(size_t)c * D + d] : NEG) : -1.0f;
          v = w - prices[c];
        }
        if (c == 0 || takes_over(v, v2)) v2 = v;
      }
      best[d] = bc;
      bidding[d] = assigned[d] < 0 && dv[d];
      incr[d] = (v1 - v2) + eps;
    }
    __syncthreads();
    // each column: the highest bid, first bidder on ties
    for (int c = tid; c < C; c += blockDim.x) {
      float tb = 0.0f;
      int wi = 0;
      for (int d = 0; d < D; ++d) {
        const float b = (bidding[d] && best[d] == c) ? incr[d] : -INFINITY;
        if (d == 0 || takes_over(b, tb)) { tb = b; wi = d; }
      }
      const bool hb = tb > -INFINITY;
      winner[c] = wi;
      has_bid[c] = hb;
      if (hb) prices[c] = prices[c] + tb;
    }
    __syncthreads();
    int still = 0;
    for (int d = tid; d < D; d += blockDim.x) {
      int a = assigned[d];
      const int own = a < 0 ? 0 : (a > C - 1 ? C - 1 : a);
      if (a >= 0 && has_bid[own] && winner[own] != d) a = -1;
      const int bc = best[d];
      if (bidding[d] && has_bid[bc] && winner[bc] == d) a = bc;
      assigned[d] = a;
      still |= dv[d] && a < 0;
    }
    open = __syncthreads_or(still);
  }
  for (int d = tid; d < D; d += blockDim.x) {
    const int a = assigned[d];
    const int trk = a < 0 ? 0 : (a > T - 1 ? T - 1 : a);
    const bool good = a >= 0 && a < T && s[(size_t)trk * D + d] >= thresh &&
                      al[trk] && dv[d];
    out[(size_t)p * D + d] = good ? trk : -1;
  }
}

// K4's dynamic shared memory: everything but the cache, and the cache
size_t greedy_fixed(int T, int D, bool boxes) {
  return 4 * ((boxes ? 5 * ((size_t)T + D) : 0) + 3 * (size_t)T +
              2 * (size_t)D + (T + 31) / 32 + (D + 31) / 32);
}

size_t greedy_cache(int T, int D) { return 4 * (size_t)T * (D | 1); }

size_t auction_smem(int T, int D) {
  const size_t C = (size_t)T + D;
  return sizeof(float) * (C + D) + sizeof(int) * (C + 2 * (size_t)D) +
         C + 2 * (size_t)D + T;
}

// the largest dynamic shared memory already allowed on each device, per
// kernel: K4's four instances, then K5
size_t allowed[5][MAX_DEVICES];

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

template <bool kBoxes, bool kCache>
int launch_greedy(const void* scores, const void* mean, const void* boxes,
                  const void* alive, const void* dvalid, void* det2trk,
                  void* trk2det, int p, int t, int d, float thresh,
                  size_t smem, cudaStream_t stream) {
  const void* fn = (const void*)assoc_greedy_kernel<kBoxes, kCache>;
  const int err = allow_smem(fn, allowed[2 * kBoxes + kCache], smem);
  if (err) return err;
  assoc_greedy_kernel<kBoxes, kCache>
      <<<p, GREEDY_THREADS, smem, stream>>>(
          (const float*)scores, (const float*)mean, (const float*)boxes,
          (const uint8_t*)alive, (const uint8_t*)dvalid, (int32_t*)det2trk,
          (int32_t*)trk2det, t, d, thresh);
  return (int)cudaGetLastError();
}

template <bool kBoxes>
int greedy(const void* scores, const void* mean, const void* boxes,
           const void* alive, const void* dvalid, void* det2trk,
           void* trk2det, int p, int t, int d, float thresh, void* stream) {
  if (p < 1 || t < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const size_t fixed = greedy_fixed(t, d, kBoxes);
  if (fixed > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const size_t cached = fixed + greedy_cache(t, d);
  if (cached <= SMEM_MAX)
    return launch_greedy<kBoxes, true>(scores, mean, boxes, alive, dvalid,
                                       det2trk, trk2det, p, t, d, thresh,
                                       cached, (cudaStream_t)stream);
  return launch_greedy<kBoxes, false>(scores, mean, boxes, alive, dvalid,
                                      det2trk, trk2det, p, t, d, thresh,
                                      fixed, (cudaStream_t)stream);
}

}  // namespace

// matrix mode: scores (p, t, d) f32 -> det2trk (p, d) i32
extern "C" int rvt_assoc_greedy(const void* scores, const void* alive,
                                const void* dvalid, void* det2trk, int p,
                                int t, int d, float thresh, void* stream) {
  return greedy<false>(scores, nullptr, nullptr, alive, dvalid, det2trk,
                       nullptr, p, t, d, thresh, stream);
}

// boxes mode: mean (p, t, 7) and boxes (p, d, 4) f32 -> det2trk (p, d) and
// trk2det (p, t) i32
extern "C" int rvt_assoc_greedy_boxes(const void* mean, const void* boxes,
                                      const void* alive, const void* dvalid,
                                      void* det2trk, void* trk2det, int p,
                                      int t, int d, float thresh,
                                      void* stream) {
  return greedy<true>(nullptr, mean, boxes, alive, dvalid, det2trk, trk2det,
                      p, t, d, thresh, stream);
}

extern "C" int rvt_assoc_auction(const void* iou, const void* alive,
                                 const void* dvalid, void* out, int p, int t,
                                 int d, float thresh, float eps,
                                 int max_iters, void* stream) {
  if (p < 1 || t < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = auction_smem(t, d);
  int err = allow_smem((const void*)assoc_auction_kernel, allowed[4], smem);
  if (err) return err;
  assoc_auction_kernel<<<p, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)iou, (const uint8_t*)alive, (const uint8_t*)dvalid,
      (int32_t*)out, t, d, thresh, eps, max_iters);
  return (int)cudaGetLastError();
}
