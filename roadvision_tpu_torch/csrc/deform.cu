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
//     attention-weighted point sum from 0 in point order, then the sum
//     over levels from 0, every product and sum rounded on its own
//     (built with --fmad=false).
//   Values are read in f32 or bf16; with bf16_vals an f32 value is
//   rounded to bf16 (nearest even) in registers before its product, as
//   the plain version's .to(bfloat16) does, so no bf16 copy of the value
//   tensor is made.
//   Bound: bytes. One launch reads the logits, offsets and boxes once
//   and the value rows its corners touch (at 640 x 8 with 300 queries
//   some 900,000 row reads of 128 bytes, many of them the same rows), and
//   writes 2.5 MB; its arithmetic is ~100 scalar operations a channel and
//   point. Design (simple first): one warp a (batch, query, head), lane =
//   channel; lanes 0..NL*NDP-1 compute one point's softmax weight,
//   location, four corner weights and row indices, which shuffles hand to
//   every lane; each corner is one coalesced row read (128 bytes in f32,
//   64 in bf16); no shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 32;           // channels a head: one lane each
constexpr int MAX_LEVELS = 4;
constexpr int WARPS = 8;         // warps a block
constexpr unsigned FULL = 0xffffffffu;

struct Levels {
  int h[MAX_LEVELS], w[MAX_LEVELS], start[MAX_LEVELS];
};

// MODE 0: f32 values; 1: f32 values rounded to bf16; 2: bf16 values
template <int MODE>
__device__ __forceinline__ float value_at(const void* __restrict__ v,
                                          long long i) {
  if (MODE == 2)
    return __bfloat162float(
        reinterpret_cast<const __nv_bfloat16*>(v)[i]);
  const float x = reinterpret_cast<const float*>(v)[i];
  return MODE == 1 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// torch.clamp(v, 0, hi): NaN stays NaN (the caller tests it first)
__device__ __forceinline__ float clamp_to(float v, float hi) {
  return fminf(fmaxf(v, 0.0f), hi);
}

template <int MODE>
__global__ void __launch_bounds__(WARPS * 32)
deform_sample_kernel(const float* __restrict__ off,
                     const float* __restrict__ logits,
                     const float* __restrict__ refer,
                     const void* __restrict__ vals, float* __restrict__ out,
                     long long nbqh, int nq, int nh, int rows, int nl,
                     int ndp, Levels lv) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (g >= nbqh) return;                   // the whole warp together
  const int h = (int)(g % nh);
  const long long bq = g / nh;
  const int b = (int)(bq / nq);
  const int np = nl * ndp;

  // the softmax, as torch's persistent warp softmax runs it
  const bool mine = lane < np;
  const float x = mine ? logits[g * np + lane] : -INFINITY;
  int width = 1;
  while (width < np) width <<= 1;
  float mx = x;
  for (int o = width >> 1; o > 0; o >>= 1) {
    const float p = __shfl_xor_sync(FULL, mx, o);
    mx = mx < p ? p : mx;
  }
  const float e = expf(x - mx);
  float sum = 0.0f + e;
  for (int o = width >> 1; o > 0; o >>= 1)
    sum = sum + __shfl_xor_sync(FULL, sum, o);
  const float attw = sum == 0.0f ? __int_as_float(0x7fc00000) : e / sum;

  // lane j < np: point j's location, corner weights and rows
  float w4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int i4[4] = {0, 0, 0, 0};
  if (mine) {
    const int l = lane / ndp;
    const float* o2 = off + (g * np + lane) * 2;
    const float* r4 = refer + bq * 4;
    const float inv = 1.0f / (float)ndp;
    const float lx = r4[0] + o2[0] * inv * r4[2] * 0.5f;
    const float ly = r4[1] + o2[1] * inv * r4[3] * 0.5f;
    const float wl = (float)lv.w[l], hl = (float)lv.h[l];
    const float sx = lx * wl - 0.5f, sy = ly * hl - 0.5f;
    const float x0 = floorf(sx), y0 = floorf(sy);
    const float fx = sx - x0, fy = sy - y0;
    const float gx = 1.0f - fx, gy = 1.0f - fy;
    const float wt[4] = {gx * gy, fx * gy, gx * fy, fx * fy};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xi = x0 + (float)(k & 1), yi = y0 + (float)(k >> 1);
      const bool inb = xi >= 0.0f && xi < wl && yi >= 0.0f && yi < hl;
      w4[k] = wt[k] * (inb ? 1.0f : 0.0f);
      i4[k] = (isnan(xi) || isnan(yi))
                  ? 0
                  : (int)(clamp_to(yi, hl - 1.0f) * wl +
                          clamp_to(xi, wl - 1.0f));
    }
  }

  // every lane: its channel of every corner row, summed in the plain order
  const long long base = (long long)b * rows;
  float acc_out = 0.0f;
  for (int l = 0; l < nl; ++l) {
    const long long lbase = base + lv.start[l];
    float lsum = 0.0f;
    for (int p = 0; p < ndp; ++p) {
      const int j = l * ndp + p;
      float gv[4], wk[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wk[k] = __shfl_sync(FULL, w4[k], j);
        const int row = __shfl_sync(FULL, i4[k], j);
        gv[k] = value_at<MODE>(vals, ((lbase + row) * nh + h) * DH + lane);
      }
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = acc + gv[k] * wk[k];
      lsum = lsum + acc * __shfl_sync(FULL, attw, j);
    }
    acc_out = acc_out + lsum;
  }
  out[g * DH + lane] = acc_out;
}

}  // namespace

// off, logits, refer f32 and contiguous as above; vals (batch, rows, nh,
// 32) contiguous, f32 (mode 0, 1) or bf16 (mode 2); out (batch, nq, nh,
// 32) f32; levels (h, w) for l < nl, their rows concatenated in order
extern "C" int rvt_deform_sample(const void* off, const void* logits,
                                 const void* refer, const void* vals,
                                 void* out, int batch, int nq, int nh,
                                 int rows, int nl, int ndp, int h0, int w0,
                                 int h1, int w1, int h2, int w2, int h3,
                                 int w3, int mode, void* stream) {
  if (nl < 1 || nl > MAX_LEVELS || ndp < 1 || nl * ndp > 32 || nh < 1 ||
      mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  const int hs[MAX_LEVELS] = {h0, h1, h2, h3}, ws[MAX_LEVELS] = {w0, w1, w2, w3};
  long long start = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv.h[l] = l < nl ? hs[l] : 0;
    lv.w[l] = l < nl ? ws[l] : 0;
    lv.start[l] = (int)start;
    if (l < nl) {
      if (hs[l] < 1 || ws[l] < 1) return (int)cudaErrorInvalidValue;
      start += (long long)hs[l] * ws[l];
    }
  }
  if (start != rows) return (int)cudaErrorInvalidValue;
  const long long nbqh = (long long)batch * nq * nh;
  if (nbqh == 0) return (int)cudaSuccess;
  const long long blocks = (nbqh + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* o = (const float*)off;
  const float* lg = (const float*)logits;
  const float* rf = (const float*)refer;
  float* dst = (float*)out;
  switch (mode) {
    case 0:
      deform_sample_kernel<0><<<(unsigned)blocks, WARPS * 32, 0, st>>>(
          o, lg, rf, vals, dst, nbqh, nq, nh, rows, nl, ndp, lv);
      break;
    case 1:
      deform_sample_kernel<1><<<(unsigned)blocks, WARPS * 32, 0, st>>>(
          o, lg, rf, vals, dst, nbqh, nq, nh, rows, nl, ndp, lv);
      break;
    default:
      deform_sample_kernel<2><<<(unsigned)blocks, WARPS * 32, 0, st>>>(
          o, lg, rf, vals, dst, nbqh, nq, nh, rows, nl, ndp, lv);
  }
  return (int)cudaGetLastError();
}
