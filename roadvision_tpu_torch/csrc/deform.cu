// Multi-scale deformable-attention sampling for Hopper (sm_90a).
//
// K7 deform_sample (rvt_deform_sample)
//   No Pallas kernel stands behind it: the JAX package's _deform_attn
//   (roadvision_tpu/models/rtdetr.py:422-507) leaves everything between
//   the attention-weight and offset linears and the output linear to XLA,
//   which fuses it inside the jitted step. The port's plain version
//   (ops/deform.py::deform_sample_plain) runs the same arithmetic as some
//   two hundred small torch operations a decoder layer: the softmax, the
//   sampling locations, per level the corner maths, 12 gathers (3 with
//   paired gathers) and the weighted sums. This kernel computes, from
//   off (B, NQ, NH, NL, NDP, 2), the attention logits (B, NQ, NH,
//   NL * NDP), the reference boxes (B, NQ, 4, sigmoid cxcywh) and the
//   level-concatenated values (B, sum Hl * Wl, NH, 32), the sampled
//   output (B, NQ, NH, 32) in f32, with the plain version's arithmetic in
//   its order:
//   * the softmax over the NL * NDP logits of a (query, head) as torch's
//     warp softmax computes it on the card: lane j holds logit j (the
//     lanes past them -inf), a butterfly maximum and sum over the next
//     power of two of lanes, exp(x - max) / sum;
//   * loc = ctr + off * (1 / NDP) * wh * 0.5 (torch divides by a scalar
//     as a product with its reciprocal), x = loc_x * Wl - 0.5,
//     x0 = floor(x), fx = x - x0 (and y);
//   * the corners (0,0), (1,0), (0,1), (1,1) with weights (1-fx)(1-fy),
//     fx(1-fy), (1-fx)fy, fx fy, times 1 or 0 for in-bounds, so that a
//     NaN weight stays NaN; the row index clamped into the map, and a NaN
//     location reads the level's row 0 (torch's nan_to_num before its
//     int cast) with its NaN weight, so the output is NaN as in JAX;
//   * per point the corner sum from 0 in corner order, per level the
//     attention-weighted point sum as torch's reduction kernel takes it
//     on the card (four accumulators, ((a0 + a1) + a2) + a3: the points
//     in order for NDP <= 4), then the sum over levels from 0, every
//     product and sum rounded on its own (built with --fmad=false).
//   Values are read in f32 or bf16; with bf16_vals an f32 value is
//   rounded to bf16 (nearest even) in registers before its product, as
//   the plain version's .to(bfloat16) does, so no bf16 copy of the value
//   tensor is made.
//   Bound: bytes. One launch reads the logits, offsets and boxes once
//   and the value rows its corners touch (at 640 x 8 with 300 queries
//   some 900,000 row reads of 128 bytes, many of them the same rows), and
//   writes 2.5 MB; its arithmetic is ~100 scalar operations a channel and
//   point. What holds a gather like this back on Hopper is latency: a
//   warp that waits on one corner row after another is idle for a round
//   trip a point. Design: one warp a (batch, query, head); lanes
//   0..NL*NDP-1 compute point j's softmax weight, location, corner
//   fractions, in-map masks and rows, as the plain version does; lane
//   group g (lanes 8g..8g+7, 4 channels a lane) then takes the points
//   j = g, g + 4, ... (PPL = ceil(NL*NDP / 4) of them, a template
//   argument, so the loops unroll), receives each one's fractions, masks,
//   rows and weight by shuffles and issues all of its corner loads (16
//   bytes a lane in f32, 8 in bf16) before its first product: 4 * PPL
//   loads in flight a lane. Each group forms its points' corner sums from
//   0 in corner order, times the point's weight, into a [point][channel]
//   tile in shared memory (4 * PPL x 32 f32 a warp); then lane = channel
//   sums the tile in the plain order (per level the points, then the
//   levels) and the warp stores its 128-byte output row. Every input of
//   the warp (logits, offsets, box) is requested at once too, and a
//   value is converted only where it is used: a conversion placed after
//   its load makes the warp wait there before its next load. Blocks of 4
//   warps (1, 2 and 8 measured as well: 8 was slower, 1 and 2 no faster).
//
// K8 deform_sample_bwd (rvt_deform_sample_backward)
//   K7's function differentiated: what jax.value_and_grad takes through
//   _deform_attn (roadvision_tpu/models/rtdetr.py:422-507) inside the
//   RT-DETR train step (roadvision_tpu/models/rtdetr_train.py:263), with
//   f32 values (the train path pins bf16_vals=False). No Pallas kernel
//   stands behind it: XLA derives and fuses the backward. The port's
//   plain version (ops/deform.py::deform_sample_backward_plain) is
//   autograd through the plain forward: twelve gathers a layer whose
//   backward scatter-adds into the value gradient. From the output
//   gradient g (B, NQ, NH, 32) and K7's four inputs it writes the
//   gradients of the offsets, the logits, the boxes and the values. Per
//   (batch, query, head) it recomputes K7's softmax weights a_p, the
//   locations, x = loc_x * Wl - 0.5, x0 = floor(x), fx = x - x0 (and y),
//   the corner weights w_c, their in-bounds masks m_c and their rows
//   (a NaN location reads row 0 with a NaN weight, as in K7), and then:
//   * values: a_p * m_c w_c * g added into row r_c of every corner whose
//     product is not 0 (f32 atomics into a zero-filled tensor; a NaN
//     product is added, so the value gradient is NaN where the plain
//     backward's is);
//   * per point S_p = sum_c m_c w_c (v_c . g), Dx_p = sum_c m_c
//     dw_c/dfx (v_c . g) and Dy_p likewise, each dot product v_c . g
//     summed over the channels as the design below says (floor has a zero
//     derivative, fx = x - x0 a unit one; an out-of-map corner has the
//     constant mask 0, which keeps a NaN location's NaN as the plain
//     backward's 0 * NaN does);
//   * logits: the softmax backward a_p (S_p - sum_q a_q S_q);
//   * offsets: a_p Dx_p * Wl * 0.5 * wh_x * (1 / NDP), and y;
//   * boxes: dx/dctr_x = Wl and dx/dwh_x = off_x * (1 / NDP) * 0.5 * Wl,
//     summed over levels and points (a butterfly over the next power of
//     two of lanes past NL * NDP), then over heads
//     by four atomics a warp into a zero-filled (B, NQ, 4).
//   The atomics make the sums' order vary from run to run: the value and
//   box gradients agree with the plain backward within a tolerance, not
//   bit for bit.
//   Bound: bytes. One launch reads the output gradient, offsets, logits
//   and boxes once and the value rows its corners touch, writes the
//   offset, logit and box gradients once and the value gradient, which
//   the wrapper zero-fills (at RT-DETR-L's 640 x 4 training shape a
//   34.4 MB tensor, most of the bytes); its arithmetic is ~30 scalar
//   operations a channel and point. Design: K7's lane layout and up-front
//   loads, with the output gradient read as 16 bytes a lane too. Each
//   lane forms the dot product of each of its corner rows with the output
//   gradient over its 4 channels (((c0 + c1) + c2) + c3), its lane group
//   sums them by 3 xor shuffles (not a 5-step butterfly over the warp),
//   and shuffles hand point j's four sums to lane j, which forms S, Dx and
//   Dy with its own corner weights for the softmax backward and the
//   offset and box chain. The value gradient takes one
//   red.global.add.v4.f32 a lane and corner (atomicAdd on a float4,
//   compute capability 9.x): 4 x fewer atomic instructions than a scalar
//   one a channel. A lane skips its vector atomic only where all four of
//   its products are exactly 0, never on the corner weight alone: a NaN
//   output gradient times a 0 weight is NaN, and the plain backward adds
//   it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 32;           // channels a head
constexpr int MAX_LEVELS = 4;
constexpr int WARPS = 4;         // warps a block
constexpr int GROUPS = 4;        // lane groups of 8 lanes, 4 channels a lane
constexpr int MAX_PPL = 8;       // points a lane group: 32 points / GROUPS
constexpr unsigned FULL = 0xffffffffu;

struct Levels {
  int h[MAX_LEVELS], w[MAX_LEVELS], start[MAX_LEVELS];
};

// a[l] for a level l known only at run time, from registers (an indexed
// load would put the array in local memory)
__device__ __forceinline__ int level_at(const int (&a)[MAX_LEVELS], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// a lane's 4 channels of a value row as loaded: 16 bytes of f32 (MODE 0:
// f32 values; 1: f32 values rounded to bf16) or 8 bytes of bf16 (MODE 2)
template <int MODE>
struct Raw {
  using T = float4;
};
template <>
struct Raw<2> {
  using T = uint2;
};

template <int MODE>
__device__ __forceinline__ typename Raw<MODE>::T load_row(const char* p) {
  if constexpr (MODE == 2)
    return __ldg(reinterpret_cast<const uint2*>(p));
  else
    return __ldg(reinterpret_cast<const float4*>(p));
}

// the 4 channels as f32, converted where they are used, so that no
// conversion waits on its load before the warp's other loads are issued:
// bf16 widened exactly; MODE 1 rounds each f32 to bf16 (nearest even, as
// the plain version's .to(bfloat16)), two channels a conversion
template <int MODE>
__device__ __forceinline__ float4 widen(const typename Raw<MODE>::T& r) {
  if constexpr (MODE == 2) {
    return make_float4(__uint_as_float(r.x << 16),
                       __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16),
                       __uint_as_float(r.y & 0xffff0000u));
  } else if constexpr (MODE == 1) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(r.x, r.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(r.z, r.w);
    return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                       __high2float(hi));
  } else {
    return r;
  }
}

__device__ __forceinline__ float at4(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// torch.clamp(v, 0, hi): NaN stays NaN (the caller tests it first)
__device__ __forceinline__ float clamp_to(float v, float hi) {
  return fminf(fmaxf(v, 0.0f), hi);
}

// the next power of two of lanes that holds np points
__device__ __forceinline__ int lanes_for(int np) {
  int width = 1;
  while (width < np) width <<= 1;
  return width;
}

// the sum over lanes 0..width-1, in each of them (the same in all: an xor
// butterfly adds the same two values on both sides)
__device__ __forceinline__ float lanes_sum(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1)
    v = v + __shfl_xor_sync(FULL, v, o);
  return v;
}

// lane j's softmax weight of logit x over the np lanes (the lanes past
// them -inf), as torch's persistent warp softmax runs it: a butterfly
// maximum and sum over the next power of two of lanes, exp(x - max) / sum
__device__ __forceinline__ float warp_softmax(float x, int width) {
  float mx = x;
  for (int o = width >> 1; o > 0; o >>= 1) {
    const float p = __shfl_xor_sync(FULL, mx, o);
    mx = mx < p ? p : mx;
  }
  const float e = expf(x - mx);
  const float sum = lanes_sum(0.0f + e, width);
  return sum == 0.0f ? __int_as_float(0x7fc00000) : e / sum;
}

// a warp's (batch, query, head) and its inputs, every load issued at
// once: lane j < np holds logit j and point j's offsets, every lane the
// query's box (ctr x, ctr y, w, h)
struct Head {
  int h, bq, b;
  float x, ox, oy, r[4];
};

__device__ __forceinline__ Head head_of(int g, int lane, int np, int nq,
                                        int nh,
                                        const float* __restrict__ off,
                                        const float* __restrict__ logits,
                                        const float* __restrict__ refer) {
  Head w;
  w.h = g % nh;
  w.bq = g / nh;
  w.b = w.bq / nq;
  w.x = -INFINITY;
  w.ox = 0.0f;
  w.oy = 0.0f;
  if (lane < np) {
    const long long j = (long long)g * np + lane;
    w.x = logits[j];
    w.ox = off[2 * j];
    w.oy = off[2 * j + 1];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) w.r[i] = refer[(long long)w.bq * 4 + i];
  return w;
}

// a point's sampling geometry: the fractions fx = x - floor(x) and fy,
// bit k of mask set where corner k lies inside the level, and corner
// k's row of the batch's values (the level's first row plus the clamped
// row inside it; a NaN location reads the level's row 0)
struct Point {
  float fx, fy;
  unsigned mask;
  int row[4];
};

__device__ __forceinline__ Point locate(float ox, float oy, const float* r,
                                        float inv, float wl, float hl,
                                        int start) {
  Point p;
  const float lx = r[0] + ox * inv * r[2] * 0.5f;
  const float ly = r[1] + oy * inv * r[3] * 0.5f;
  const float sx = lx * wl - 0.5f, sy = ly * hl - 0.5f;
  const float x0 = floorf(sx), y0 = floorf(sy);
  p.fx = sx - x0;
  p.fy = sy - y0;
  p.mask = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float xi = x0 + (float)(k & 1), yi = y0 + (float)(k >> 1);
    if (xi >= 0.0f && xi < wl && yi >= 0.0f && yi < hl) p.mask |= 1u << k;
    p.row[k] = start + ((isnan(xi) || isnan(yi))
                            ? 0
                            : (int)(clamp_to(yi, hl - 1.0f) * wl +
                                    clamp_to(xi, wl - 1.0f)));
  }
  return p;
}

// the corners (0,0), (1,0), (0,1), (1,1): their in-map masks m_k and
// masked weights m_k w_k (a NaN weight stays NaN)
__device__ __forceinline__ void corners(float fx, float fy, unsigned mask,
                                        float m[4], float w[4]) {
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  const float wt[4] = {gx * gy, fx * gy, gx * fy, fx * fy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m[k] = (mask >> k) & 1u ? 1.0f : 0.0f;
    w[k] = wt[k] * m[k];
  }
}

template <int MODE, int PPL>
__global__ void __launch_bounds__(WARPS * 32)
deform_sample_kernel(const float* __restrict__ off,
                     const float* __restrict__ logits,
                     const float* __restrict__ refer,
                     const void* __restrict__ vals, float* __restrict__ out,
                     int nbqh, int nq, int nh, int rows, int nl, int ndp,
                     Levels lv) {
  using RawT = typename Raw<MODE>::T;
  constexpr int ESZ = MODE == 2 ? 2 : 4;   // bytes a value
  __shared__ __align__(16) float tile[WARPS][GROUPS * PPL][DH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x * WARPS + warp;
  if (g >= nbqh) return;                   // the whole warp together
  const int np = nl * ndp;
  const Head hd = head_of(g, lane, np, nq, nh, off, logits, refer);

  // lane j < np: point j's softmax weight and geometry
  const float attw = warp_softmax(hd.x, lanes_for(np));
  Point pt = {0.0f, 0.0f, 0u, {0, 0, 0, 0}};
  if (lane < np) {
    const int l = lane / ndp;
    pt = locate(hd.ox, hd.oy, hd.r, 1.0f / (float)ndp,
                (float)level_at(lv.w, l), (float)level_at(lv.h, l),
                level_at(lv.start, l));
  }

  // lane group grp takes the points grp + GROUPS * t, 4 channels a lane:
  // every corner row of them requested before the first product
  const int grp = lane >> 3, c4 = (lane & 7) * 4;
  const char* vrow = reinterpret_cast<const char*>(vals) +
                     (((long long)hd.b * rows * nh + hd.h) * DH + c4) * ESZ;
  const long long rstride = (long long)nh * DH * ESZ;
  float a[PPL], fx[PPL], fy[PPL];
  unsigned mask[PPL];
  RawT v[PPL][4];
#pragma unroll
  for (int t = 0; t < PPL; ++t) {
    const int src = grp + GROUPS * t;
    a[t] = __shfl_sync(FULL, attw, src);
    fx[t] = __shfl_sync(FULL, pt.fx, src);
    fy[t] = __shfl_sync(FULL, pt.fy, src);
    mask[t] = __shfl_sync(FULL, pt.mask, src);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int row = __shfl_sync(FULL, pt.row[k], src);
      v[t][k] = src < np ? load_row<MODE>(vrow + row * rstride) : RawT{};
    }
  }

  // each point's corner sum from 0 in corner order, times its weight,
  // into the [point][channel] tile
#pragma unroll
  for (int t = 0; t < PPL; ++t) {
    const int j = grp + GROUPS * t;
    if (j < np) {
      float m[4], w[4];
      corners(fx[t], fy[t], mask[t], m, w);
      float4 vk[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) vk[k] = widen<MODE>(v[t][k]);
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc = acc + at4(vk[k], c) * w[k];
        p[c] = acc * a[t];
      }
      *reinterpret_cast<float4*>(&tile[warp][j][c4]) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
  }
  __syncwarp();

  // lane = channel: per level the point sum as torch's reduction kernel
  // takes it (four accumulators from 0, point p into p % 4, then ((a0 +
  // a1) + a2) + a3: for NDP <= 4 the points in order), then the levels
  // from 0
  float acc_out = 0.0f;
  for (int l = 0; l < nl; ++l) {
    const float* pts = &tile[warp][l * ndp][lane];
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    for (int p = 0; p < ndp; p += 4) {
      a0 = a0 + pts[p * DH];
      if (p + 1 < ndp) a1 = a1 + pts[(p + 1) * DH];
      if (p + 2 < ndp) a2 = a2 + pts[(p + 2) * DH];
      if (p + 3 < ndp) a3 = a3 + pts[(p + 3) * DH];
    }
    acc_out = acc_out + (((a0 + a1) + a2) + a3);
  }
  out[(long long)g * DH + lane] = acc_out;
}

template <int PPL>
__global__ void __launch_bounds__(WARPS * 32)
deform_sample_backward_kernel(const float* __restrict__ gout,
                              const float* __restrict__ off,
                              const float* __restrict__ logits,
                              const float* __restrict__ refer,
                              const float* __restrict__ vals,
                              float* __restrict__ g_off,
                              float* __restrict__ g_logits,
                              float* __restrict__ g_refer,
                              float* __restrict__ g_vals, int nbqh, int nq,
                              int nh, int rows, int nl, int ndp, Levels lv) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (g >= nbqh) return;                   // the whole warp together
  const int np = nl * ndp;
  const int width = lanes_for(np);
  const bool mine = lane < np;
  const int grp = lane >> 3, c4 = (lane & 7) * 4;
  const Head hd = head_of(g, lane, np, nq, nh, off, logits, refer);
  const float4 go =
      __ldg(reinterpret_cast<const float4*>(gout + (long long)g * DH + c4));

  // lane j < np: point j's softmax weight and geometry, as K7 has them
  const float attw = warp_softmax(hd.x, width);
  const float inv = 1.0f / (float)ndp;
  Point pt = {0.0f, 0.0f, 0u, {0, 0, 0, 0}};
  float wl = 0.0f, hl = 0.0f;
  if (mine) {
    const int l = lane / ndp;
    wl = (float)level_at(lv.w, l);
    hl = (float)level_at(lv.h, l);
    pt = locate(hd.ox, hd.oy, hd.r, inv, wl, hl, level_at(lv.start, l));
  }

  // K7's lane groups and up-front loads
  const long long vbase = ((long long)hd.b * rows * nh + hd.h) * DH + c4;
  const long long rstride = (long long)nh * DH;
  float a[PPL], fx[PPL], fy[PPL];
  unsigned mask[PPL];
  int row[PPL][4];
  float4 v[PPL][4];
#pragma unroll
  for (int t = 0; t < PPL; ++t) {
    const int src = grp + GROUPS * t;
    a[t] = __shfl_sync(FULL, attw, src);
    fx[t] = __shfl_sync(FULL, pt.fx, src);
    fy[t] = __shfl_sync(FULL, pt.fy, src);
    mask[t] = __shfl_sync(FULL, pt.mask, src);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      row[t][k] = __shfl_sync(FULL, pt.row[k], src);
      v[t][k] = src < np ? load_row<0>(reinterpret_cast<const char*>(
                               vals + vbase + row[t][k] * rstride))
                         : float4{};
    }
  }

  // per point and corner: the value gradient's row, and d_k = v_k . g,
  // the corner row's dot product with the output gradient over the lane's
  // 4 channels, then over its lane group
  float d[PPL][4];
#pragma unroll
  for (int t = 0; t < PPL; ++t) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4& r = v[t][k];
      d[t][k] = ((r.x * go.x + r.y * go.y) + r.z * go.z) + r.w * go.w;
    }
    if (grp + GROUPS * t < np) {
      float m[4], w[4];
      corners(fx[t], fy[t], mask[t], m, w);
      const float4 ag = make_float4(go.x * a[t], go.y * a[t], go.z * a[t],
                                    go.w * a[t]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 c = make_float4(ag.x * w[k], ag.y * w[k], ag.z * w[k],
                                     ag.w * w[k]);
        // a NaN product is not 0: it is added, as the plain scatter adds it
        if (c.x != 0.0f || c.y != 0.0f || c.z != 0.0f || c.w != 0.0f)
          atomicAdd(reinterpret_cast<float4*>(g_vals + vbase +
                                              row[t][k] * rstride),
                    c);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < PPL; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      for (int o = 4; o > 0; o >>= 1)
        d[t][k] = d[t][k] + __shfl_xor_sync(FULL, d[t][k], o);

  // lane j takes its point's four sums (lane group j % GROUPS holds them,
  // at its point j / GROUPS) and forms, with its own corner weights,
  // S_j = sum_k m_k w_k d_k and Dx_j, Dy_j with d(m_k w_k)/dfx, /dfy
  float dk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int from = (lane % GROUPS) * 8;
#pragma unroll
  for (int t = 0; t < PPL; ++t)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float x = __shfl_sync(FULL, d[t][k], from);
      if (lane / GROUPS == t) dk[k] = x;
    }
  float s_mine = 0.0f, dx_mine = 0.0f, dy_mine = 0.0f;
  if (mine) {
    float m[4], w[4];
    corners(pt.fx, pt.fy, pt.mask, m, w);
    const float gx = 1.0f - pt.fx, gy = 1.0f - pt.fy;
#pragma unroll
    for (int k = 0; k < 4; ++k) s_mine = s_mine + w[k] * dk[k];
    // the corners (0,0), (1,0), (0,1), (1,1)
    dx_mine = (m[0] * -gy) * dk[0] + (m[1] * gy) * dk[1] +
              (m[2] * -pt.fy) * dk[2] + (m[3] * pt.fy) * dk[3];
    dy_mine = (m[0] * -gx) * dk[0] + (m[1] * -pt.fx) * dk[1] +
              (m[2] * gx) * dk[2] + (m[3] * pt.fx) * dk[3];
  }

  // logits: the softmax backward over the np lanes
  const float as = lanes_sum(mine ? attw * s_mine : 0.0f, width);
  // offsets and boxes: through x = (ctr + off * (1/NDP) * wh * 0.5) * Wl
  float cx = 0.0f, cy = 0.0f, cw = 0.0f, ch = 0.0f;
  if (mine) {
    const long long j = (long long)g * np + lane;
    g_logits[j] = attw * (s_mine - as);
    const float glx = (attw * dx_mine) * wl, gly = (attw * dy_mine) * hl;
    const float tx = glx * 0.5f, ty = gly * 0.5f;
    g_off[2 * j] = (tx * hd.r[2]) * inv;
    g_off[2 * j + 1] = (ty * hd.r[3]) * inv;
    cx = glx;
    cy = gly;
    cw = tx * (hd.ox * inv);
    ch = ty * (hd.oy * inv);
  }
  cx = lanes_sum(cx, width);
  cy = lanes_sum(cy, width);
  cw = lanes_sum(cw, width);
  ch = lanes_sum(ch, width);
  if (lane == 0) {
    float* gr = g_refer + (long long)hd.bq * 4;
    atomicAdd(gr + 0, cx);
    atomicAdd(gr + 1, cy);
    atomicAdd(gr + 2, cw);
    atomicAdd(gr + 3, ch);
  }
}

// both entry points: the sizes the kernels take (at most MAX_LEVELS
// levels, 32 points a head, fewer than 2^31 warps), the levels' (h, w)
// and first rows for l < nl (rows concatenated in order, adding up to
// rows), and the grid of warps; false where any does not fit
bool launch_shape(int batch, int nq, int nh, int rows, int nl, int ndp,
                  const int* hs, const int* ws, Levels* lv,
                  long long* blocks) {
  if (batch < 0 || nq < 0 || nh < 1 || nl < 1 || nl > MAX_LEVELS ||
      ndp < 1 || nl * ndp > GROUPS * MAX_PPL)
    return false;
  long long start = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv->h[l] = l < nl ? hs[l] : 0;
    lv->w[l] = l < nl ? ws[l] : 0;
    lv->start[l] = (int)start;
    if (l < nl) {
      if (hs[l] < 1 || ws[l] < 1) return false;
      start += (long long)hs[l] * ws[l];
    }
  }
  const long long warps = (long long)batch * nq * nh;
  *blocks = (warps + WARPS - 1) / WARPS;
  return start == rows && *blocks * WARPS <= 0x7fffffffLL;
}

// the 16-byte loads and vector atomics need 16-byte aligned rows
bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <int MODE, int PPL>
void launch_sample(unsigned blocks, cudaStream_t st, const float* o,
                   const float* lg, const float* rf, const void* vals,
                   float* dst, int nbqh, int nq, int nh, int rows,
                   int nl, int ndp, const Levels& lv) {
  deform_sample_kernel<MODE, PPL><<<blocks, WARPS * 32, 0, st>>>(
      o, lg, rf, vals, dst, nbqh, nq, nh, rows, nl, ndp, lv);
}

// the kernel instance for PPL = ceil(nl * ndp / GROUPS), 1..MAX_PPL
template <int MODE>
void launch_sample_ppl(int ppl, unsigned blocks, cudaStream_t st,
                       const float* o, const float* lg, const float* rf,
                       const void* vals, float* dst, int nbqh, int nq,
                       int nh, int rows, int nl, int ndp, const Levels& lv) {
  switch (ppl) {
#define RVT_CASE(P)                                                         \
  case P:                                                                   \
    launch_sample<MODE, P>(blocks, st, o, lg, rf, vals, dst, nbqh, nq, nh,  \
                           rows, nl, ndp, lv);                              \
    break;
    RVT_CASE(1) RVT_CASE(2) RVT_CASE(3) RVT_CASE(4)
    RVT_CASE(5) RVT_CASE(6) RVT_CASE(7) RVT_CASE(8)
#undef RVT_CASE
  }
}

}  // namespace

// off, logits, refer f32 and contiguous as above; vals (batch, rows, nh,
// 32) contiguous and 16-byte aligned, f32 (mode 0, 1) or bf16 (mode 2);
// out (batch, nq, nh, 32) f32; levels (h, w) for l < nl, their rows
// concatenated in order
extern "C" int rvt_deform_sample(const void* off, const void* logits,
                                 const void* refer, const void* vals,
                                 void* out, int batch, int nq, int nh,
                                 int rows, int nl, int ndp, int h0, int w0,
                                 int h1, int w1, int h2, int w2, int h3,
                                 int w3, int mode, void* stream) {
  Levels lv;
  long long blocks;
  const int hs[MAX_LEVELS] = {h0, h1, h2, h3}, ws[MAX_LEVELS] = {w0, w1, w2, w3};
  if (mode < 0 || mode > 2 || !aligned16(vals) ||
      !launch_shape(batch, nq, nh, rows, nl, ndp, hs, ws, &lv, &blocks))
    return (int)cudaErrorInvalidValue;
  const int nbqh = batch * nq * nh;
  if (nbqh == 0) return (int)cudaSuccess;
  const int ppl = (nl * ndp + GROUPS - 1) / GROUPS;
  cudaStream_t st = (cudaStream_t)stream;
  const float* o = (const float*)off;
  const float* lg = (const float*)logits;
  const float* rf = (const float*)refer;
  float* dst = (float*)out;
  switch (mode) {
    case 0:
      launch_sample_ppl<0>(ppl, (unsigned)blocks, st, o, lg, rf, vals, dst,
                           nbqh, nq, nh, rows, nl, ndp, lv);
      break;
    case 1:
      launch_sample_ppl<1>(ppl, (unsigned)blocks, st, o, lg, rf, vals, dst,
                           nbqh, nq, nh, rows, nl, ndp, lv);
      break;
    default:
      launch_sample_ppl<2>(ppl, (unsigned)blocks, st, o, lg, rf, vals, dst,
                           nbqh, nq, nh, rows, nl, ndp, lv);
  }
  return (int)cudaGetLastError();
}

// gout (batch, nq, nh, 32) and K7's inputs (mode 0: f32 values), all f32
// and contiguous, gout, vals and g_vals 16-byte aligned; g_off, g_logits
// written whole; g_refer (batch, nq, 4) and g_vals (batch, rows, nh, 32)
// zero-filled by the caller and added into
extern "C" int rvt_deform_sample_backward(
    const void* gout, const void* off, const void* logits, const void* refer,
    const void* vals, void* g_off, void* g_logits, void* g_refer,
    void* g_vals, int batch, int nq, int nh, int rows, int nl, int ndp,
    int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
    void* stream) {
  Levels lv;
  long long blocks;
  const int hs[MAX_LEVELS] = {h0, h1, h2, h3}, ws[MAX_LEVELS] = {w0, w1, w2, w3};
  if (!aligned16(gout) || !aligned16(vals) || !aligned16(g_vals) ||
      !launch_shape(batch, nq, nh, rows, nl, ndp, hs, ws, &lv, &blocks))
    return (int)cudaErrorInvalidValue;
  const int nbqh = batch * nq * nh;
  if (nbqh == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)blocks;
  cudaStream_t st = (cudaStream_t)stream;
  const float* args[5] = {(const float*)gout, (const float*)off,
                          (const float*)logits, (const float*)refer,
                          (const float*)vals};
  float* outs[4] = {(float*)g_off, (float*)g_logits, (float*)g_refer,
                    (float*)g_vals};
  switch ((nl * ndp + GROUPS - 1) / GROUPS) {
#define RVT_CASE(P)                                                         \
  case P:                                                                   \
    deform_sample_backward_kernel<P><<<grid, WARPS * 32, 0, st>>>(          \
        args[0], args[1], args[2], args[3], args[4], outs[0], outs[1],      \
        outs[2], outs[3], nbqh, nq, nh, rows, nl, ndp, lv);                 \
    break;
    RVT_CASE(1) RVT_CASE(2) RVT_CASE(3) RVT_CASE(4)
    RVT_CASE(5) RVT_CASE(6) RVT_CASE(7) RVT_CASE(8)
#undef RVT_CASE
  }
  return (int)cudaGetLastError();
}
