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
// K4 assoc_greedy_kernel (rvt_assoc_greedy)
//   Computes track/sort.py::greedy_associate_plain: mutual-maximum rounds
//   over the (T, D) score matrix until no pair is mutual. Bound: latency,
//   not bytes or operations: 40 KB a problem at T = D = 100 (0.012 us at
//   3.35 TB/s) and ~3·T·D compares a round, against a chain of rounds
//   each needing two barriers. Design: the masked matrix lives in shared
//   memory with a row stride of D + 1 floats, so that a thread scanning a
//   row and a thread scanning a column both touch distinct banks; one
//   thread per row finds its row's first-index maximum while one thread
//   per column finds its column's, then one thread per row decides its
//   mutual pair and the block retires the taken rows and columns. A
//   matrix too large for one block's shared memory (T·(D + 1)·4 bytes
//   over 227 KB, T = D ≳ 238) lives in a global work buffer of the same
//   layout instead, one slice a problem, read through L1/L2: the same
//   rounds, the same comparisons, only another address space. NaN
//   counts as the maximum (its first index wins), as torch.argmax and
//   jnp.argmax count it, and the row maximum is then NaN, which no
//   threshold accepts.
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
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;
constexpr float NEG = -1e9f;           // an ineligible auction edge

// v at index i replaces the running maximum (bv at bi), scanning indices
// in increasing order: strictly greater wins, so the first index of the
// maximum stays; the first NaN wins and stays (NaN is the maximum).
__device__ __forceinline__ bool takes_over(float v, float bv) {
  return !isnan(bv) && (isnan(v) || v > bv);
}

// kGlobal: the (T, D + 1) matrix in ``work`` (one slice a problem), else
// at the start of shared memory
template <bool kGlobal>
__global__ void assoc_greedy_kernel(const float* __restrict__ scores,
                                    const uint8_t* __restrict__ alive,
                                    const uint8_t* __restrict__ dvalid,
                                    int32_t* __restrict__ out,
                                    float* __restrict__ work, int T, int D,
                                    float thresh) {
  extern __shared__ float smem[];
  const int stride = D + 1;
  const size_t cells = (size_t)T * stride;
  float* mat = kGlobal ? work + blockIdx.x * cells : smem;   // T x (D + 1)
  float* rval = kGlobal ? smem : smem + cells;         // T
  int* rbest = (int*)(rval + T);                       // T
  int* cbest = rbest + T;                              // D
  int* det2trk = cbest + D;                            // D
  uint8_t* rowclr = (uint8_t*)(det2trk + D);           // T
  uint8_t* colclr = rowclr + T;                        // D

  const int p = blockIdx.x;
  const float* s = scores + (size_t)p * T * D;
  const uint8_t* al = alive + (size_t)p * T;
  const uint8_t* dv = dvalid + (size_t)p * D;
  const int tid = threadIdx.x;

  for (int i = tid; i < T * D; i += blockDim.x) {
    const int t = i / D, d = i - t * D;
    mat[t * stride + d] = (al[t] && dv[d]) ? s[i] : -1.0f;
  }
  for (int d = tid; d < D; d += blockDim.x) det2trk[d] = -1;
  __syncthreads();

  const int rounds = (T < D ? T : D) + 1;
  for (int r = 0; r < rounds; ++r) {
    // rows and columns: the first-index maximum of each
    for (int i = tid; i < T + D; i += blockDim.x) {
      if (i < T) {
        const float* row = mat + i * stride;
        float bv = row[0];
        int bi = 0;
        for (int d = 1; d < D; ++d) {
          const float v = row[d];
          if (takes_over(v, bv)) { bv = v; bi = d; }
        }
        rval[i] = bv;
        rbest[i] = bi;
      } else {
        const int d = i - T;
        float bv = mat[d];
        int bi = 0;
        for (int t = 1; t < T; ++t) {
          const float v = mat[t * stride + d];
          if (takes_over(v, bv)) { bv = v; bi = t; }
        }
        cbest[d] = bi;
        colclr[d] = 0;
      }
    }
    __syncthreads();
    // a row takes its column where each is the other's maximum; a
    // column's mutual row is unique (it is the column's argmax)
    int any = 0;
    for (int t = tid; t < T; t += blockDim.x) {
      const int d = rbest[t];
      const float v = rval[t];
      const bool mutual = cbest[d] == t && v >= thresh && v > -0.5f;
      rowclr[t] = mutual;
      if (mutual) {
        colclr[d] = 1;
        if (det2trk[d] < 0) det2trk[d] = t;
        any = 1;
      }
    }
    if (!__syncthreads_or(any)) break;
    for (int i = tid; i < T * D; i += blockDim.x) {
      const int t = i / D, d = i - t * D;
      if (rowclr[t] || colclr[d]) mat[t * stride + d] = -1.0f;
    }
    __syncthreads();
  }
  for (int d = tid; d < D; d += blockDim.x)
    out[(size_t)p * D + d] = det2trk[d];
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

size_t greedy_smem(int T, int D, bool global) {
  return (global ? 0 : sizeof(float) * (size_t)T * (D + 1)) +
         sizeof(float) * T + sizeof(int) * (T + 2 * (size_t)D) + T + D;
}

size_t auction_smem(int T, int D) {
  const size_t C = (size_t)T + D;
  return sizeof(float) * (C + D) + sizeof(int) * (C + 2 * (size_t)D) +
         C + 2 * (size_t)D + T;
}

// the largest dynamic shared memory already allowed on each device
size_t greedy_allowed[MAX_DEVICES];
size_t greedy_global_allowed[MAX_DEVICES];
size_t auction_allowed[MAX_DEVICES];

int allow_smem(const void* fn, size_t* allowed, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (allowed[dev] >= bytes) return 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return (int)err;
}

}  // namespace

// ``work``: null, or (p, t, d + 1) floats for a matrix that shared memory
// cannot hold
extern "C" int rvt_assoc_greedy(const void* scores, const void* alive,
                                const void* dvalid, void* out, void* work,
                                int p, int t, int d, float thresh,
                                void* stream) {
  if (p < 1 || t < 1 || d < 1 || p > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const bool global = work != nullptr;
  const size_t smem = greedy_smem(t, d, global);
  const void* fn = global ? (const void*)assoc_greedy_kernel<true>
                          : (const void*)assoc_greedy_kernel<false>;
  int err = allow_smem(fn, global ? greedy_global_allowed : greedy_allowed,
                       smem);
  if (err) return err;
  if (global)
    assoc_greedy_kernel<true><<<p, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)scores, (const uint8_t*)alive, (const uint8_t*)dvalid,
        (int32_t*)out, (float*)work, t, d, thresh);
  else
    assoc_greedy_kernel<false><<<p, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)scores, (const uint8_t*)alive, (const uint8_t*)dvalid,
        (int32_t*)out, nullptr, t, d, thresh);
  return (int)cudaGetLastError();
}

extern "C" int rvt_assoc_auction(const void* iou, const void* alive,
                                 const void* dvalid, void* out, int p, int t,
                                 int d, float thresh, float eps,
                                 int max_iters, void* stream) {
  if (p < 1 || t < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = auction_smem(t, d);
  int err = allow_smem((const void*)assoc_auction_kernel, auction_allowed,
                       smem);
  if (err) return err;
  assoc_auction_kernel<<<p, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)iou, (const uint8_t*)alive, (const uint8_t*)dvalid,
      (int32_t*)out, t, d, thresh, eps, max_iters);
  return (int)cudaGetLastError();
}
