// CLAHE on uint8 luma planes for Hopper (sm_90a): two kernels.
//
// K1 clahe_tile_luts_kernel
//   Replaces roadvision_tpu/ops/clahe.py::_luts_for_plane (histogram,
//   clip, redistribution, CDF). The JAX package computes it in XLA with
//   a nibble one-hot matmul per tile; there is no TPU kernel for it.
//   Bound: device-memory bytes (each input byte read once, 256 bytes
//   written per tile; ~16.6 MB for 8 x 1080p, 0.00499 ms at 3.35 TB/s).
//   Design: one block of 256 threads per (image, tile); at 1080p all
//   512 blocks are resident at once. A tile row is cut into pieces of 16
//   bytes; a thread owns pieces p = tid, tid + 256, ... and loads each
//   with one 128-bit load, LUT_UNROLL = 4 of them in flight before it counts
//   any, so a block keeps 16 KiB on its way instead of 256 bytes. The
//   row and column of a piece cost one divide per 16 pixels. Counting
//   goes into one histogram per warp in shared memory (8 x 1 KiB), so
//   warps never contend, with plain shared-memory atomics: the card
//   resolves lanes that hit one address well enough that merging runs of
//   equal bytes in registers first only cost time. What does pay is one
//   step up: a piece whose 16 bytes are equal is grouped with the warp's
//   other such pieces by __match_any_sync (once per 16 pixels, and only
//   when the warp has one) and one lane adds 16 per piece. Tiles whose
//   width, row stride or pointer is not a multiple of 16 take the same
//   code with guarded byte loads. Then thread t owns bin t: the warps'
//   histograms are summed, the excess over the clip is reduced by warp
//   shuffles and one cross-warp step, OpenCV's redistribution follows,
//   and the 256-wide inclusive scan is five shuffles plus the totals of
//   the warps before: three barriers after the counting, where a
//   Hillis-Steele scan in shared memory took sixteen. The LUT is
//   rint(cdf * scale) in float32 with scale = float32(255 / tile_area)
//   from the host, as in clahe.py:177-182. ops/clahe.py::
//   tile_luts_by_pieces is this layout in numpy.
//
// K2 clahe_apply_kernel
//   Replaces roadvision_tpu/ops/pallas_clahe.py::sweep_pallas together
//   with the bilinear blend around it (clahe.py::_apply_band_sweep).
//   Bound: device-memory bytes (plane read once, written once; ~33 MB
//   for 8 x 1080p, 0.00996 ms at 3.35 TB/s). The plane fits in L2, so
//   what decides the time is the instruction count per pixel. On the TPU
//   a gather is slow, so the JAX package packs four LUT taps per (bin,
//   column) and sweeps all 256 bins; on Hopper a gather from shared
//   memory is cheap, so the sweep goes away but the packed table stays.
//   Design: the host cuts the rows where the pair of tile rows (r1, r2)
//   changes and then into chunks of a few rows (ops/clahe.py::
//   row_chunks); one block takes one chunk of one image. It builds in
//   shared memory the chunk's packed table over the gx + 1 column
//   intervals, one entry per (interval, bin) holding the four taps
//   l11, l12, l21, l22 (built from 32-bit loads of the four LUT rows),
//   so a pixel costs one shared gather instead of four byte gathers, and
//   a block reads four LUT rows per interval instead of staging all
//   gy * gx. A thread owns four adjacent columns: the shared-memory
//   address of each column's interval and its blend weights sit in
//   registers for the whole chunk, and each row is one 32-bit load and
//   one 32-bit store per four pixels. Rows whose width or pointers are
//   not a multiple of four take the same arithmetic with guarded byte
//   accesses. Row tables (weights) and column tables (interval, weights)
//   come from the host, computed in numpy exactly as
//   clahe.py::_interp_coords / _interp_weight_num do.
//   "fixed" blend: entries are four bytes in a word; exact uint32
//   rationals, half-even division (clahe.py:338-345).
//   "cv2" blend: every float multiply and add rounds on its own
//   (__fmul_rn / __fadd_rn, and the file is built with --fmad=false),
//   then round-half-even and clamp (clahe.py:347-375). The conversions
//   stay off the slow conversion unit and stay exact: entries are four
//   f16 values (a byte is exact in f16, and f16 -> f32 is one
//   instruction), and the result is rounded by adding 1.5 * 2^23, which
//   leaves rint(v) in the low mantissa bits.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- K1 ------------------------------------------------------------------

constexpr int LUT_THREADS = 256;   // one thread per bin in the tail
constexpr int LUT_WARPS = LUT_THREADS / 32;
constexpr int LUT_PIECE = 16;      // bytes of a piece: one 128-bit load
static_assert(LUT_PIECE == sizeof(uint4), "a piece is one uint4");
// 16-byte loads a thread starts before it counts any: 2, 4 and 8 take the
// same time warm, 4 the least with L2 flushed
constexpr int LUT_UNROLL = 4;
constexpr int LUT_STEP = LUT_UNROLL * LUT_THREADS;   // pieces per pass
constexpr unsigned FULL = 0xffffffffu;

// Pieces p0 + u * LUT_THREADS + tid, u < LUT_UNROLL, of this block's tile:
// piece p is bytes [16 c, 16 c + 16) of tile row p / ppr, little-endian in
// q[u]; nv[u] is how many of them lie inside the tile (0: no such piece).
template <bool ALIGNED>
__device__ __forceinline__ void load_pieces(const uint8_t* __restrict__ base,
                                            int w, int tw, int ppr,
                                            int npieces, int p0,
                                            uint4 (&q)[LUT_UNROLL],
                                            int (&nv)[LUT_UNROLL]) {
#pragma unroll
  for (int u = 0; u < LUT_UNROLL; ++u) {
    const int p = p0 + u * LUT_THREADS + (int)threadIdx.x;
    q[u] = make_uint4(0u, 0u, 0u, 0u);
    nv[u] = 0;
    if (p < npieces) {
      const int row = p / ppr;
      const int c = p - row * ppr;
      const uint8_t* src = base + (size_t)row * w + 16 * c;
      if (ALIGNED) {
        q[u] = __ldg(reinterpret_cast<const uint4*>(src));
        nv[u] = 16;
      } else {
        nv[u] = min(16, tw - 16 * c);
        uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (k < nv[u]) words[k >> 2] |= (uint32_t)src[k] << (8 * (k & 3));
        }
        q[u] = make_uint4(words[0], words[1], words[2], words[3]);
      }
    }
  }
}

// Count one piece into the warp's own histogram. All 32 lanes call it
// together. A piece of one value ("flat") is grouped with the warp's
// other flat pieces of that value and one lane adds 16 for each; every
// other piece adds its bytes one by one.
template <bool ALIGNED>
__device__ __forceinline__ void count_piece(int* wh, const uint4 q,
                                            const int nvalid, const int lane) {
  const uint32_t first = q.x & 0xffu;
  const bool flat = nvalid == 16 && q.x == q.y && q.y == q.z && q.z == q.w &&
                    q.x == first * 0x01010101u;
  if (__any_sync(FULL, flat)) {
    // a lane that is not flat brings a key no other lane holds
    const unsigned peers =
        __match_any_sync(FULL, flat ? (int)first : 256 + lane);
    if (flat && lane == __ffs(peers) - 1) {
      atomicAdd(&wh[first], 16 * __popc(peers));
    }
  }
  if (!flat && nvalid > 0) {
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (ALIGNED || k < nvalid) {
        atomicAdd(&wh[(words[k >> 2] >> (8 * (k & 3))) & 0xffu], 1);
      }
    }
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(LUT_THREADS)
clahe_tile_luts_kernel(const uint8_t* __restrict__ x,
                       uint8_t* __restrict__ luts, int h, int w, int gy,
                       int gx, int th, int tw, int clip, float scale) {
  __shared__ int wh[LUT_WARPS][256];     // one histogram per warp
  __shared__ int part[2][LUT_WARPS];     // cross-warp step: excess, scan
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int n = blockIdx.y;
  const int ty = tile / gx;
  const int tx = tile - ty * gx;
  const uint8_t* base = x + (size_t)n * h * w + (size_t)(ty * th) * w +
                        (size_t)(tx * tw);
  const int ppr = (tw + 15) >> 4;        // pieces per tile row
  const int npieces = th * ppr;

#pragma unroll
  for (int k = 0; k < LUT_WARPS; ++k) wh[k][tid] = 0;
  __syncthreads();
  // every thread makes the same number of passes: count_piece is collective
  for (int p0 = 0; p0 < npieces; p0 += LUT_STEP) {
    uint4 q[LUT_UNROLL];
    int nv[LUT_UNROLL];
    load_pieces<ALIGNED>(base, w, tw, ppr, npieces, p0, q, nv);
#pragma unroll
    for (int u = 0; u < LUT_UNROLL; ++u) {
      count_piece<ALIGNED>(wh[warp], q[u], nv[u], lane);
    }
  }
  __syncthreads();

  // thread t owns bin t from here on
  int c = 0;
#pragma unroll
  for (int k = 0; k < LUT_WARPS; ++k) c += wh[k][tid];
  if (clip > 0) {
    const int clipped = min(c, clip);
    int ex = c - clipped;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ex += __shfl_xor_sync(FULL, ex, o);
    if (lane == 0) part[0][warp] = ex;
    __syncthreads();
    int excess = 0;
#pragma unroll
    for (int k = 0; k < LUT_WARPS; ++k) excess += part[0][k];
    const int redist = excess / 256;
    const int residual = excess - redist * 256;
    const int step = max(256 / max(residual, 1), 1);
    const int bump = (tid % step == 0) && (tid / step < residual);
    c = clipped + redist + bump;
  }
  // inclusive scan over the 256 bins: shuffles inside a warp, then the
  // totals of the warps before this one
  int cdf = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(FULL, cdf, o);
    if (lane >= o) cdf += up;
  }
  if (lane == 31) part[1][warp] = cdf;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < LUT_WARPS - 1; ++k) {
    if (k < warp) cdf += part[1][k];
  }
  float r = rintf(__fmul_rn((float)cdf, scale));
  r = fminf(fmaxf(r, 0.0f), 255.0f);
  luts[(((size_t)n * gy + ty) * gx + tx) * 256 + tid] = (uint8_t)r;
}


constexpr int PX = 4;          // adjacent pixels per thread per row
constexpr int APPLY_MAX_THREADS = 512;

// Shared-memory reads by 32-bit shared-space address: one register per
// column holds the address of its interval's table, so a gather is one
// shift-add and one load. The "memory" clobber keeps them behind the
// barrier that follows the table build.
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "r"(addr) : "memory");
  return v;
}

// byte K of a word
template <int K>
__device__ __forceinline__ uint32_t byte_of(uint32_t word) {
  return K == 0 ? (word & 0xffu)
                : K == 3 ? (word >> 24) : __byte_perm(word, 0, 0x4440 + K);
}

// two bytes (byte i of lo_src and of hi_src) as the f16 pair of their
// values, exactly: 0x64vv is the half 1024 + v, and 1024 comes off
__device__ __forceinline__ uint32_t half_pair(uint32_t lo_src,
                                              uint32_t hi_src, int i) {
  const uint32_t p =
      (__byte_perm(lo_src, hi_src, ((4 + i) << 8) | i) & 0x00ff00ffu) |
      0x64006400u;
  const __half2 hv = __hsub2(*reinterpret_cast<const __half2*>(&p),
                             __floats2half2_rn(1024.0f, 1024.0f));
  return *reinterpret_cast<const uint32_t*>(&hv);
}

// The packed table has one entry per (column interval c, bin v) holding
// the four taps l11, l12, l21, l22. "fixed" blend: four bytes in a word.
// "cv2" blend: four f16 values in two words (bytes are exact in f16, and
// f16 -> f32 is one instruction on the floating-point pipe, where a byte
// -> f32 costs two, one of them on the busier integer pipe).
template <bool FIXED, bool ALIGNED>
__global__ void __launch_bounds__(APPLY_MAX_THREADS)
clahe_apply_kernel(const uint8_t* __restrict__ x,
                   const uint8_t* __restrict__ luts,
                   const int* __restrict__ chunks,
                   const int* __restrict__ row_i,
                   const float* __restrict__ row_f,
                   const int* __restrict__ col_c,
                   const int* __restrict__ col_n,
                   const float* __restrict__ col_a,
                   const float* __restrict__ col_a1,
                   uint8_t* __restrict__ out, int h, int w, int gy, int gx,
                   int th, int tw) {
  constexpr int ENTRY = FIXED ? 4 : 8;   // bytes per table entry
  extern __shared__ uint4 tab4[];
  const uint32_t tab_s = (uint32_t)__cvta_generic_to_shared(tab4);
  const int n = blockIdx.y;
  // this block's rows [y0, y1) and their tile rows r1, r2
  const int4 ch = __ldg(reinterpret_cast<const int4*>(chunks) + blockIdx.x);
  const uint8_t* lut1 = luts + ((size_t)n * gy + ch.z) * gx * 256;
  const uint8_t* lut2 = luts + ((size_t)n * gy + ch.w) * gx * 256;
  // interval c blends tile columns max(c - 1, 0) and min(c, gx - 1);
  // one task packs four bins of one interval
  for (int t = threadIdx.x; t < (gx + 1) * 64; t += blockDim.x) {
    const int c = t >> 6;
    const int o1 = max(c - 1, 0) * 256 + (t & 63) * 4;
    const int o2 = min(c, gx - 1) * 256 + (t & 63) * 4;
    const uint32_t a = __ldg(reinterpret_cast<const uint32_t*>(lut1 + o1));
    const uint32_t b = __ldg(reinterpret_cast<const uint32_t*>(lut1 + o2));
    const uint32_t cc = __ldg(reinterpret_cast<const uint32_t*>(lut2 + o1));
    const uint32_t d = __ldg(reinterpret_cast<const uint32_t*>(lut2 + o2));
    if (FIXED) {
      const uint32_t ab_lo = __byte_perm(a, b, 0x5140);   // a0 b0 a1 b1
      const uint32_t ab_hi = __byte_perm(a, b, 0x7362);   // a2 b2 a3 b3
      const uint32_t cd_lo = __byte_perm(cc, d, 0x5140);
      const uint32_t cd_hi = __byte_perm(cc, d, 0x7362);
      tab4[t] = make_uint4(__byte_perm(ab_lo, cd_lo, 0x5410),
                           __byte_perm(ab_lo, cd_lo, 0x7632),
                           __byte_perm(ab_hi, cd_hi, 0x5410),
                           __byte_perm(ab_hi, cd_hi, 0x7632));
    } else {
      tab4[2 * t] = make_uint4(half_pair(a, b, 0), half_pair(cc, d, 0),
                               half_pair(a, b, 1), half_pair(cc, d, 1));
      tab4[2 * t + 1] = make_uint4(half_pair(a, b, 2), half_pair(cc, d, 2),
                                   half_pair(a, b, 3), half_pair(cc, d, 3));
    }
  }
  __syncthreads();

  const uint32_t twn = 2u * (uint32_t)tw;
  const uint32_t thn = 2u * (uint32_t)th;
  const uint32_t den = 4u * (uint32_t)th * (uint32_t)tw;
  const int rows = ch.y - ch.x;
  const size_t first = ((size_t)n * h + ch.x) * w;
  const uint8_t* xb = x + first;
  uint8_t* ob = out + first;
  const int* yn = row_i + 3 * ch.x + 2;
  const float2* yw = reinterpret_cast<const float2*>(row_f) + ch.x;
  const int nq = (w + PX - 1) / PX;
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    const int x0 = q * PX;
    // the column tables are padded to a multiple of PX entries
    uint32_t tcol[PX], xan[PX];
    float xa[PX], xa1[PX];
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      tcol[k] = tab_s + (uint32_t)__ldg(col_c + x0 + k) * (256 * ENTRY);
      if (FIXED) {
        xan[k] = (uint32_t)__ldg(col_n + x0 + k);
      } else {
        xa[k] = __ldg(col_a + x0 + k);
        xa1[k] = __ldg(col_a1 + x0 + k);
      }
    }
    uint32_t off = (uint32_t)x0;   // within the chunk: fits 32 bits
    for (int r = 0; r < rows; ++r, off += (uint32_t)w) {
      uint32_t pw = 0;
      if (ALIGNED) {
        pw = __ldg(reinterpret_cast<const uint32_t*>(xb + off));
      } else {
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          if (x0 + k < w) pw |= (uint32_t)xb[off + k] << (8 * k);
        }
      }
      const uint32_t v[PX] = {byte_of<0>(pw), byte_of<1>(pw), byte_of<2>(pw),
                              byte_of<3>(pw)};
      uint32_t res[PX];
      if (FIXED) {
        const uint32_t yan = (uint32_t)__ldg(yn + 3 * r);
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          const uint32_t taps = lds32(tcol[k] + v[k] * ENTRY);
          const uint32_t l11 = taps & 0xffu, l12 = (taps >> 8) & 0xffu;
          const uint32_t l21 = (taps >> 16) & 0xffu, l22 = taps >> 24;
          const uint32_t top = l11 * (twn - xan[k]) + l12 * xan[k];
          const uint32_t bot = l21 * (twn - xan[k]) + l22 * xan[k];
          const uint32_t num = top * (thn - yan) + bot * yan;
          const uint32_t qq = num / den;
          const uint32_t rem = num - qq * den;
          const uint32_t up =
              (2u * rem > den) || (2u * rem == den && (qq & 1u));
          res[k] = qq + up;
        }
      } else {
        const float2 yy = __ldg(yw + r);   // (frac, 1 - frac) of the row
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          const uint2 taps = lds64(tcol[k] + v[k] * ENTRY);
          const float2 t1 =
              __half22float2(*reinterpret_cast<const __half2*>(&taps.x));
          const float2 t2 =
              __half22float2(*reinterpret_cast<const __half2*>(&taps.y));
          const float top = __fadd_rn(__fmul_rn(t1.x, xa1[k]),
                                      __fmul_rn(t1.y, xa[k]));
          const float bot = __fadd_rn(__fmul_rn(t2.x, xa1[k]),
                                      __fmul_rn(t2.y, xa[k]));
          const float rr =
              __fadd_rn(__fmul_rn(top, yy.y), __fmul_rn(bot, yy.x));
          // adding 1.5 * 2^23 leaves rint(rr) in the low mantissa bits.
          // The clamp to [0, 255] is a no-op and is left out: the taps
          // are at most 255 and each weight pair is (f, fl(1 - f)), so
          // rr lies within 255 * (1 + 2^-22), which rounds to 255
          res[k] = (uint32_t)__float_as_int(__fadd_rn(rr, 12582912.0f));
        }
      }
      // the low byte of every result
      const uint32_t word = __byte_perm(__byte_perm(res[0], res[1], 0x0040),
                                        __byte_perm(res[2], res[3], 0x0040),
                                        0x5410);
      if (ALIGNED) {
        *reinterpret_cast<uint32_t*>(ob + off) = word;
      } else {
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          if (x0 + k < w) ob[off + k] = (uint8_t)(word >> (8 * k));
        }
      }
    }
  }
}

}  // namespace

extern "C" int rvt_clahe_tile_luts(const void* x, void* luts, int n, int h,
                                   int w, int gy, int gx, int th, int tw,
                                   int clip, float scale, void* stream) {
  // 128-bit loads need every piece of every tile row on a 16-byte boundary
  const bool aligned = tw % 16 == 0 && w % 16 == 0 && (uintptr_t)x % 16 == 0;
  auto kern = aligned ? clahe_tile_luts_kernel<true>
                      : clahe_tile_luts_kernel<false>;
  dim3 grid(gy * gx, n);
  kern<<<grid, LUT_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (uint8_t*)luts, h, w, gy, gx, th, tw, clip, scale);
  return (int)cudaGetLastError();
}

extern "C" int rvt_clahe_apply(const void* x, const void* luts,
                               const void* chunks, const void* row_i,
                               const void* row_f, const void* col_c,
                               const void* col_n, const void* col_a,
                               const void* col_a1, void* out, int n, int h,
                               int w, int gy, int gx, int th, int tw,
                               int nchunks, int fixed, void* stream) {
  const bool aligned = w % PX == 0 && (uintptr_t)x % PX == 0 &&
                       (uintptr_t)out % PX == 0;
  auto kern = fixed ? (aligned ? clahe_apply_kernel<true, true>
                               : clahe_apply_kernel<true, false>)
                    : (aligned ? clahe_apply_kernel<false, true>
                               : clahe_apply_kernel<false, false>);
  const size_t smem = (size_t)(gx + 1) * 256 * (fixed ? 4 : 8);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // every thread gets the same number of column groups, in whole warps
  const int nq = (w + PX - 1) / PX;
  const int passes = (nq + APPLY_MAX_THREADS - 1) / APPLY_MAX_THREADS;
  const int threads = ((nq + passes - 1) / passes + 31) / 32 * 32;
  dim3 grid(nchunks, n);
  kern<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const uint8_t*)luts, (const int*)chunks,
      (const int*)row_i, (const float*)row_f, (const int*)col_c,
      (const int*)col_n, (const float*)col_a, (const float*)col_a1,
      (uint8_t*)out, h, w, gy, gx, th, tw);
  return (int)cudaGetLastError();
}
