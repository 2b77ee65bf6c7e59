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
// K5 assoc_auction_kernel (rvt_assoc_auction, rvt_assoc_auction_boxes,
//   rvt_auction_match)
//   The parallel epsilon-auction (Bertsekas): every unassigned valid
//   bidder bids (best - second best) + eps for its best column, each
//   column goes to its highest bid (the first bidder on ties), until no
//   valid bidder is unassigned or max_iters rounds. Three modes under one
//   name:
//   * matrix mode (rvt_assoc_auction) computes track/sort.py::
//     auction_associate_plain (sort_tpu.py:233-311): D detections bid
//     over T track columns (scores (T, D)) and D dummy columns at -1;
//     det -> track, -1 on a dummy, a dead track or below the threshold;
//   * boxes mode (rvt_assoc_auction_boxes) computes before it, in the
//     same launch, x_to_bbox and the IoU as K4's boxes mode does, and
//     after it the inverse map track -> det
//     (auction_associate_boxes_plain, the composition of sort_tpu.py:
//     498-508);
//   * matcher mode (rvt_auction_match) computes models/rtdetr_train.py::
//     hungarian_match_plain (the JAX matcher, rtdetr_train.py:82): M gts
//     bid over NQ queries at values -cost, no dummy columns; gt -> query
//     (int64), -1 for a masked gt.
//   Bound: latency, as K4. A 100 x 100 problem is 40 KB of scores and a
//   few compares a cell a round; what costs is the chain of rounds.
//   Design: a round is three phases and three barriers (two in the
//   matcher mode, which has no phase A):
//   * A: the columns whose value does not depend on the bidder (the D
//     dummies at -1 - price, dead tracks at -1e9 - price) are reduced
//     once for the whole block to their top two (value, index);
//   * B: a warp per bidder that bids (unassigned and valid, from a list
//     kept in shared memory: nobody else scans) scans the columns whose
//     value depends on it (the live tracks, through a compacted list;
//     every query) 32 at a time, keeps a top two in registers, reduces
//     it across the warp with shuffles and merges the shared top two into
//     it, in the order of `beats` with the real indices, so that ties
//     across the two sets break as in the plain version. The plain
//     version's second best is the maximum after the best cell is *set
//     to* -1e9, so v2 = max(-1e9, runner-up). The bid goes to its column
//     as one 64-bit atomicMax in shared memory: the order-preserving bits
//     of the bid above (+-0 one key, every NaN the top key), ~bidder below
//     (so the first bidder wins a tie); a column whose top key is NaN or
//     -inf has no bid, as the plain version's `top > -inf` says;
//   * C: each bidder reads its column's key; the winner takes the column,
//     puts the owner it evicts on the next round's list and adds the bid
//     to the price; a loser goes on that list itself.
//   Prices, keys (two buffers: one is cleared while the other is read),
//   owners and lists stay in shared memory. The cells are cached there
//   where they fit beside them, a bidder's row contiguous (the tracker
//   modes transpose the live tracks' columns into (D, live) with an odd
//   row stride); otherwise they are read in place through L1 / L2
//   (matrix, matcher) or computed again from the boxes held in shared
//   memory (boxes). Where not even the state fits (some 2,000 tracks and
//   detections), it lives in a workspace in device memory that the
//   wrapper allocates. Built with --fmad=false; the arithmetic is the
//   plain version's, in its order (w - price, (v1 - v2) + eps, price +
//   bid), so the prices are bit-equal round by round.


#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "box_iou.cuh"

namespace {

constexpr int GREEDY_THREADS = 1024;
constexpr int AUCTION_THREADS = 1024;
constexpr int MAX_DEVICES = 64;
constexpr size_t SMEM_MAX = 232448;    // 227 KB a block
constexpr float NEG = -1e9f;           // an ineligible auction edge

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

// x_to_bbox of the means (T, 7) and the detections (D, 4) of one
// problem, each box as x1, y1, x2, y2, area in structure-of-arrays form
// (tb: 5 T, db: 5 D); x_to_bbox: w = sqrt(clamp(s * r, 1e-6)),
// h = s / clamp(w, 1e-6)
__device__ void load_boxes(const float* __restrict__ mean,
                           const float* __restrict__ boxes, int T, int D,
                           float* tb, float* db) {
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const float* m = mean + (size_t)t * 7;
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
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float* b = boxes + (size_t)d * 4;
    db[d] = b[0];
    db[D + d] = b[1];
    db[2 * D + d] = b[2];
    db[3 * D + d] = b[3];
    db[4 * D + d] = rvt::box_area(b[0], b[1], b[2], b[3]);
  }
}

// the IoU of track t against detection d from load_boxes' arrays
__device__ __forceinline__ float cell_iou(const float* tb, const float* db,
                                          int T, int D, int t, int d) {
  return rvt::box_iou(tb[t], tb[T + t], tb[2 * T + t], tb[3 * T + t],
                      tb[4 * T + t], db[d], db[D + d], db[2 * D + d],
                      db[3 * D + d], db[4 * D + d]);
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
  if constexpr (kBoxes)
    load_boxes(mean + (size_t)p * T * 7, boxes + (size_t)p * D * 4, T, D,
               tb, db);
  __syncthreads();

  const float* s = kBoxes ? nullptr : scores + (size_t)p * T * D;
  auto compute = [&](int t, int d) -> float {
    if constexpr (kBoxes)
      return cell_iou(tb, db, T, D, t, d);
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

// ---------------------------------------------------------------------
// K5

enum AuctionMode { kMatrix = 0, kBoxesMode = 1, kMatcher = 2 };

// the top two of a set of columns: the first in the order of `beats`
// (v1 at i1) and the NaN-propagating maximum of the others' values (v2,
// -inf for none); (-inf, INT_MAX, -inf) is the empty set
struct Top2 {
  float v1;
  int i1;
  float v2;
};

__device__ __forceinline__ Top2 top2_none() {
  return {-INFINITY, INT_MAX, -INFINITY};
}

// the top two of the union of two disjoint sets
__device__ __forceinline__ Top2 top2_merge(const Top2& a, const Top2& b) {
  if (beats(b.v1, b.i1, a.v1, a.i1))
    return {b.v1, b.i1, rvt::nan_max(a.v1, b.v2)};
  return {a.v1, a.i1, rvt::nan_max(a.v2, b.v1)};
}

// add column i of value v to the set
__device__ __forceinline__ void top2_add(Top2& t, float v, int i) {
  if (beats(v, i, t.v1, t.i1)) {
    t.v2 = t.v1;
    t.v1 = v;
    t.i1 = i;
  } else {
    t.v2 = rvt::nan_max(t.v2, v);
  }
}

// the warp's union, in every lane
__device__ __forceinline__ Top2 warp_top2(Top2 t) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    Top2 u;
    u.v1 = __shfl_xor_sync(0xffffffffu, t.v1, o);
    u.i1 = __shfl_xor_sync(0xffffffffu, t.i1, o);
    u.v2 = __shfl_xor_sync(0xffffffffu, t.v2, o);
    t = top2_merge(t, u);
  }
  return t;
}

// a bid's 32 order-preserving bits: -0 as +0, every NaN above +inf
__device__ __forceinline__ uint32_t bid_bits(float f) {
  if (isnan(f)) return 0xffffffffu;
  uint32_t u = __float_as_uint(f);
  if ((u << 1) == 0) u = 0;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float bid_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

constexpr uint32_t NEG_INF_BITS = 0x007fffffu;      // bid_bits(-inf)

// a column's top key (0: nobody bid) is a bid: above -inf and not NaN
__device__ __forceinline__ bool key_has_bid(unsigned long long key) {
  const uint32_t hi = (uint32_t)(key >> 32);
  return hi > NEG_INF_BITS && hi != 0xffffffffu;
}

// K5's state, per problem, in shared memory or in the workspace. R
// bidders (detections, gts); T bidder-dependent columns (tracks,
// queries); C columns in all (T + R dummies in the tracker modes)
struct AuctionState {
  unsigned long long* keys;    // 2 x C, the top bid of each column
  float* prices;               // C
  int* owner;                  // C, -1: free
  int* best;                   // R, the column a bidder bid for
  int* list;                   // 2 x R, the bidders of a round, the next
  int* cnt;                    // the two lists' sizes, live, dead tracks
  Top2* part;                  // 32, phase A's warps
  int* cols;                   // T: live tracks first, dead from the end
  uint8_t* al;                 // T, alive
  float* tb;                   // 5 T, the predicted boxes (boxes mode)
  float* db;                   // 5 R, the detections (boxes mode)
  float* cache;                // R x ld cells, where cached
};

// lay the state out from ``base`` (nullptr: only the size); the bytes
__host__ __device__ inline size_t auction_layout(int mode, int T, int R,
                                                 char* base,
                                                 AuctionState* s) {
  const bool tracker = mode != kMatcher;
  const size_t C = tracker ? (size_t)T + R : (size_t)T;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* at = base + off;
    off += (bytes + 15) & ~(size_t)15;
    return at;
  };
  s->keys = (unsigned long long*)take(2 * sizeof(unsigned long long) * C);
  s->prices = (float*)take(sizeof(float) * C);
  s->owner = (int*)take(sizeof(int) * C);
  s->best = (int*)take(sizeof(int) * (size_t)R);
  s->list = (int*)take(2 * sizeof(int) * (size_t)R);
  s->cnt = (int*)take(4 * sizeof(int));
  s->part = (Top2*)take(32 * sizeof(Top2));
  s->cols = (int*)take(tracker ? sizeof(int) * (size_t)T : 0);
  s->al = (uint8_t*)take(tracker ? (size_t)T : 0);
  s->tb = (float*)take(mode == kBoxesMode ? 5 * sizeof(float) * T : 0);
  s->db = (float*)take(mode == kBoxesMode ? 5 * sizeof(float) * R : 0);
  s->cache = (float*)(base + off);
  return off;
}

// the cache's row stride: a bidder's cells are a row; odd in the tracker
// modes, whose fill writes a column
__host__ __device__ inline int auction_ld(int mode, int T) {
  return mode == kMatcher ? T : (T | 1);
}

// K5. kMode: matrix (cells = scores (T, R)), boxes (mean (T, 7), boxes
// (R, 4)) or matcher (cells = cost (R, T)); kCache: the cells in shared
// memory; kGlobal: the state in ``workspace`` (ws_stride bytes a problem)
template <int kMode, bool kCache, bool kGlobal>
__global__ void __launch_bounds__(AUCTION_THREADS)
assoc_auction_kernel(const float* __restrict__ cells,
                     const float* __restrict__ mean,
                     const float* __restrict__ boxes,
                     const uint8_t* __restrict__ alive,
                     const uint8_t* __restrict__ valid,
                     void* __restrict__ out, int32_t* __restrict__ trk2det,
                     char* __restrict__ workspace, size_t ws_stride, int T,
                     int R, float thresh, float eps, int max_iters) {
  extern __shared__ __align__(16) char auction_smem[];
  constexpr bool kTracker = kMode != kMatcher;
  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int C = kTracker ? T + R : T;
  const int ld = auction_ld(kMode, T);
  AuctionState st;
  auction_layout(kMode, T, R,
                 kGlobal ? workspace + (size_t)p * ws_stride : auction_smem,
                 &st);
  valid += (size_t)p * R;
  const float* s = kMode == kBoxesMode ? nullptr : cells + (size_t)p * T * R;

  for (int c = tid; c < C; c += nthreads) {
    st.prices[c] = 0.0f;
    st.owner[c] = -1;
    st.keys[c] = 0;
    st.keys[C + c] = 0;
  }
  if (tid < 4) st.cnt[tid] = 0;
  if constexpr (kTracker)
    for (int t = tid; t < T; t += nthreads) st.al[t] = alive[(size_t)p * T + t];
  if constexpr (kMode == kBoxesMode)
    load_boxes(mean + (size_t)p * T * 7, boxes + (size_t)p * R * 4, T, R,
               st.tb, st.db);
  __syncthreads();
  // the first round's bidders: every valid one; the live tracks and the
  // dead (any order: ties break by index, never by position)
  for (int d = tid; d < R; d += nthreads)
    if (valid[d]) st.list[atomicAdd(&st.cnt[0], 1)] = d;
  if constexpr (kTracker)
    for (int t = tid; t < T; t += nthreads) {
      if (st.al[t])
        st.cols[atomicAdd(&st.cnt[2], 1)] = t;
      else
        st.cols[T - 1 - atomicAdd(&st.cnt[3], 1)] = t;
    }
  __syncthreads();
  const int nlive = kTracker ? st.cnt[2] : T;
  const int ndead = kTracker ? T - nlive : 0;

  // the cell of the k-th bidder-dependent column (column c) for bidder d
  auto cell = [&](int k, int c, int d) -> float {
    if constexpr (kCache)
      return st.cache[(size_t)d * ld + k];
    else if constexpr (kMode == kBoxesMode)
      return cell_iou(st.tb, st.db, T, R, c, d);
    else if constexpr (kMode == kMatrix)
      return __ldg(s + (size_t)c * R + d);
    else
      return __ldg(s + (size_t)d * T + k);
  };
  if constexpr (kCache) {
    if constexpr (kTracker) {
      // the live columns, transposed: threads on neighbouring detections
      // read neighbouring scores and write an odd stride apart
      const int n = nlive * R;
      for (int i = tid; i < n; i += nthreads) {
        const int k = i / R, d = i - k * R;
        const int c = st.cols[k];
        st.cache[(size_t)d * ld + k] =
            kMode == kBoxesMode ? cell_iou(st.tb, st.db, T, R, c, d)
                                : __ldg(s + (size_t)c * R + d);
      }
    } else {
      for (int i = tid; i < R * T; i += nthreads) st.cache[i] = __ldg(s + i);
    }
    __syncthreads();
  }

  int cur = 0;
  int n = st.cnt[0];
  for (int r = 0; r < max_iters && n > 0; ++r) {
    const int nxt = cur ^ 1;
    unsigned long long* keys = st.keys + (size_t)cur * C;
    const int* list = st.list + (size_t)cur * R;
    Top2 shared = top2_none();
    if constexpr (kTracker) {
      // A: the dead tracks' and the dummies' values, once for the block
      Top2 t = top2_none();
      for (int j = tid; j < ndead + R; j += nthreads) {
        const int c = j < ndead ? st.cols[T - 1 - j] : T + (j - ndead);
        top2_add(t, (j < ndead ? NEG : -1.0f) - st.prices[c], c);
      }
      t = warp_top2(t);
      if (lane == 0) st.part[warp] = t;
      __syncthreads();
      shared = warp_top2(lane < nwarps ? st.part[lane] : top2_none());
    }
    // B: a warp per bidder, then its bid as one atomic
    if (tid == 0) st.cnt[nxt] = 0;
    for (int j = warp; j < n; j += nwarps) {
      const int d = list[j];
      Top2 t = top2_none();
#pragma unroll 4
      for (int k = lane; k < nlive; k += 32) {
        const int c = kTracker ? st.cols[k] : k;
        const float w = kMode == kMatcher ? -cell(k, c, d) : cell(k, c, d);
        top2_add(t, w - st.prices[c], c);
      }
      t = warp_top2(t);
      if constexpr (kTracker) t = top2_merge(t, shared);
      if (lane == 0) {
        // the runner-up beside the best cell set to -1e9
        const float v2 = isnan(t.v2) ? t.v2 : fmaxf(NEG, t.v2);
        const float incr = (t.v1 - v2) + eps;
        st.best[d] = t.i1;
        atomicMax(keys + t.i1, ((unsigned long long)bid_bits(incr) << 32) |
                                   (uint32_t)~(uint32_t)d);
      }
    }
    __syncthreads();
    // C: each bidder against its column's top key; the other key buffer
    // is cleared for the next round
    unsigned long long* other = st.keys + (size_t)nxt * C;
    for (int c = tid; c < C; c += nthreads) other[c] = 0;
    int* next = st.list + (size_t)nxt * R;
    for (int j = tid; j < n; j += nthreads) {
      const int d = list[j];
      const int c = st.best[d];
      const unsigned long long key = keys[c];
      if (key_has_bid(key) && ~(uint32_t)key == (uint32_t)d) {
        const int evicted = st.owner[c];
        if (evicted >= 0) next[atomicAdd(&st.cnt[nxt], 1)] = evicted;
        st.owner[c] = d;
        st.prices[c] = st.prices[c] + bid_value((uint32_t)(key >> 32));
      } else {
        next[atomicAdd(&st.cnt[nxt], 1)] = d;
      }
    }
    __syncthreads();
    n = st.cnt[nxt];
    cur = nxt;
  }

  // the owners to the outputs (best[] holds bidder -> column): the
  // tracker modes keep an alive track at or above the threshold
  for (int d = tid; d < R; d += nthreads) st.best[d] = -1;
  __syncthreads();
  for (int c = tid; c < T; c += nthreads) {
    const int d = st.owner[c];
    if constexpr (kTracker) {
      int t2d = -1;
      if (d >= 0 && st.al[c]) {
        const float w = kMode == kBoxesMode
                            ? cell_iou(st.tb, st.db, T, R, c, d)
                            : __ldg(s + (size_t)c * R + d);
        if (w >= thresh) {
          st.best[d] = c;
          t2d = d;
        }
      }
      if (kMode == kBoxesMode) trk2det[(size_t)p * T + c] = t2d;
    } else if (d >= 0) {
      st.best[d] = c;
    }
  }
  __syncthreads();
  for (int d = tid; d < R; d += nthreads) {
    if constexpr (kMode == kMatcher)
      ((int64_t*)out)[(size_t)p * R + d] = st.best[d];
    else
      ((int32_t*)out)[(size_t)p * R + d] = st.best[d];
  }
}

// K4's dynamic shared memory: everything but the cache, and the cache
size_t greedy_fixed(int T, int D, bool boxes) {
  return 4 * ((boxes ? 5 * ((size_t)T + D) : 0) + 3 * (size_t)T +
              2 * (size_t)D + (T + 31) / 32 + (D + 31) / 32);
}

size_t greedy_cache(int T, int D) { return 4 * (size_t)T * (D | 1); }

// the largest dynamic shared memory already allowed on each device, per
// kernel: K4's four instances, then K5's three a mode
size_t allowed[13][MAX_DEVICES];

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

template <int kMode, bool kCache, bool kGlobal>
int launch_auction(const void* cells, const void* mean, const void* boxes,
                   const void* alive, const void* valid, void* out,
                   void* trk2det, void* workspace, size_t ws_stride, int p,
                   int t, int r, float thresh, float eps, int max_iters,
                   size_t smem, cudaStream_t stream) {
  const void* fn = (const void*)assoc_auction_kernel<kMode, kCache, kGlobal>;
  const int err = allow_smem(fn, allowed[4 + 3 * kMode + (kGlobal ? 2 : kCache)],
                             smem);
  if (err) return err;
  // a warp per bidder, at least four warps for phase A and the fills
  const int warps = r < 4 ? 4 : (r > 32 ? 32 : r);
  assoc_auction_kernel<kMode, kCache, kGlobal>
      <<<p, 32 * warps, smem, stream>>>(
          (const float*)cells, (const float*)mean, (const float*)boxes,
          (const uint8_t*)alive, (const uint8_t*)valid, out,
          (int32_t*)trk2det, (char*)workspace, ws_stride, t, r, thresh, eps,
          max_iters);
  return (int)cudaGetLastError();
}

// the bytes of device memory a problem's state needs outside shared
// memory: 0 where it fits in a block's
size_t auction_workspace(int mode, int t, int r) {
  AuctionState st;
  const size_t state = auction_layout(mode, t, r, nullptr, &st);
  return state > SMEM_MAX ? state : 0;
}

template <int kMode>
int auction(const void* cells, const void* mean, const void* boxes,
            const void* alive, const void* valid, void* out, void* trk2det,
            void* workspace, int p, int t, int r, float thresh, float eps,
            int max_iters, void* stream) {
  if (p < 1 || t < 1 || r < 1) return (int)cudaErrorInvalidValue;
  AuctionState st;
  const size_t state = auction_layout(kMode, t, r, nullptr, &st);
  const cudaStream_t cs = (cudaStream_t)stream;
  if (state > SMEM_MAX) {
    if (workspace == nullptr) return (int)cudaErrorInvalidValue;
    return launch_auction<kMode, false, true>(
        cells, mean, boxes, alive, valid, out, trk2det, workspace, state, p,
        t, r, thresh, eps, max_iters, 0, cs);
  }
  const size_t cached =
      state + sizeof(float) * (size_t)r * auction_ld(kMode, t);
  if (cached <= SMEM_MAX)
    return launch_auction<kMode, true, false>(
        cells, mean, boxes, alive, valid, out, trk2det, nullptr, 0, p, t, r,
        thresh, eps, max_iters, cached, cs);
  return launch_auction<kMode, false, false>(
      cells, mean, boxes, alive, valid, out, trk2det, nullptr, 0, p, t, r,
      thresh, eps, max_iters, state, cs);
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

// K5's device-memory workspace a problem needs (bytes; 0: none): mode 0
// matrix, 1 boxes (t tracks, r detections), 2 matcher (t queries, r gts)
extern "C" long long rvt_auction_workspace(int mode, int t, int r) {
  return (long long)auction_workspace(mode, t, r);
}

// matrix mode: scores (p, t, d) f32 -> det2trk (p, d) i32; ``workspace``
// holds rvt_auction_workspace(0, t, d) bytes a problem, or is null where
// that is 0
extern "C" int rvt_assoc_auction(const void* iou, const void* alive,
                                 const void* dvalid, void* out,
                                 void* workspace, int p, int t, int d,
                                 float thresh, float eps, int max_iters,
                                 void* stream) {
  return auction<kMatrix>(iou, nullptr, nullptr, alive, dvalid, out, nullptr,
                          workspace, p, t, d, thresh, eps, max_iters, stream);
}

// boxes mode: mean (p, t, 7) and boxes (p, d, 4) f32 -> det2trk (p, d) and
// trk2det (p, t) i32
extern "C" int rvt_assoc_auction_boxes(const void* mean, const void* boxes,
                                       const void* alive, const void* dvalid,
                                       void* det2trk, void* trk2det,
                                       void* workspace, int p, int t, int d,
                                       float thresh, float eps,
                                       int max_iters, void* stream) {
  return auction<kBoxesMode>(nullptr, mean, boxes, alive, dvalid, det2trk,
                             trk2det, workspace, p, t, d, thresh, eps,
                             max_iters, stream);
}

// matcher mode: cost (p, m, nq) f32, gt_mask (p, m) u8 -> query per gt
// (p, m) i64, -1 for a masked gt
extern "C" int rvt_auction_match(const void* cost, const void* gt_mask,
                                 void* out, void* workspace, int p, int m,
                                 int nq, float eps, int max_iters,
                                 void* stream) {
  return auction<kMatcher>(cost, nullptr, nullptr, nullptr, gt_mask, out,
                           nullptr, workspace, p, nq, m, 0.0f, eps,
                           max_iters, stream);
}
