// Median filter on uint8 planes for Hopper (sm_90a), replicate border.
//
// K3, two kernels behind one entry point (rvt_median_k):
//
// median3_kernel (k = 3, the main path)
//   Replaces roadvision_tpu/ops/pallas_median.py::median3_pallas.
//   Bound: device-memory bytes (each plane read once and written once;
//   ~99.5 MB for 3 planes x 8 x 1080p, 0.0297 ms at 3.35 TB/s). The
//   Pallas kernel computes in int32 on 128x128 tiles because Mosaic
//   rejects uint8 blocks and unaligned lane slices. A byte-per-thread
//   port of that is bound by its instruction count, not by bytes: nine
//   byte-wide shared loads and 38 scalar min/max per output byte.
//   Design: no shared memory. A thread owns a strip 16 pixels wide and
//   8 rows tall. It reads each input row once as one 128-bit load plus
//   the two bytes beside the strip (L1 serves the overlap with the
//   neighbouring strips), a few rows ahead of their use so that enough
//   loads are in flight, keeps a rolling three-row window in registers
//   and writes each output row with one 128-bit store. The arithmetic is
//   the shared sorted-columns identity of roadvision_tpu/ops/median.py:
//   sort every column of three once, then
//   med3(max3(lows), med3(mids), min3(highs)) over the three columns of
//   each output. It runs packed, two pixels per 32-bit register in
//   16-bit lanes (even pixels in one register, odd pixels in another, so
//   a pixel's left and right neighbours are whole registers and only the
//   seams between words need a byte permute), with Hopper's three-input
//   min and max (DPX, VIMNMX3.U16x2); the middle of three is the sum
//   less the least and the greatest. Byte values fit the lanes exactly,
//   so the result is exact. The aligned kernel is about 1,660 instructions for
//   a thread's 128 pixels, about 13 per pixel. Rows that are 16-byte aligned
//   (w % 16 == 0 and aligned pointers) take the wide path; any other
//   width or pointer takes the same arithmetic with byte loads and
//   guarded byte stores.
//
// median_kernel<K> (k = 5, 7, 9; off the main path)
//   Covers what the Pallas kernel never did (the XLA sort in
//   roadvision_tpu/ops/median.py::median_planar_i32). One block per 32x32
//   output tile stages the clamped halo in shared memory; each thread
//   selects the median by a bitwise search on the value: the largest m
//   with #(p < m) < (k*k+1)/2, eight passes of k*k compares, exact for
//   any window.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- k = 3

constexpr int STRIP = 16;           // pixels per thread per row
constexpr int ROWS3 = 8;            // output rows per thread
constexpr int AHEAD = 3;            // input rows loaded ahead of their use
constexpr int THREADS3 = 128;
constexpr int NREG = 9;             // registers of one unpacked row

__device__ __forceinline__ uint32_t perm(uint32_t a, uint32_t b, uint32_t s) {
  return __byte_perm(a, b, s);
}

// Two pixels per register, in 16-bit lanes. The middle of three is their
// sum less the least and the greatest: lanes hold at most 3 * 255, so the
// packed adds never carry between lanes, and the adds can run on
// another pipe than the three-input min and max.
__device__ __forceinline__ uint32_t mid_of(uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t lo, uint32_t hi) {
  return a + b + c - lo - hi;
}
__device__ __forceinline__ uint32_t med3(uint32_t a, uint32_t b, uint32_t c) {
  return mid_of(a, b, c, __vimin3_u16x2(a, b, c), __vimax3_u16x2(a, b, c));
}

// one input row of a strip as it comes from memory
struct Raw {
  uint32_t wd[4];        // 16 pixels
  uint32_t left, right;  // the pixels beside them (replicated at the border)
};

template <bool ALIGNED>
__device__ __forceinline__ Raw load_raw(const uint8_t* __restrict__ row,
                                        int x0, int w) {
  Raw r;
  if (ALIGNED) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + x0));
    r.wd[0] = v.x; r.wd[1] = v.y; r.wd[2] = v.z; r.wd[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        v |= (uint32_t)row[min(x0 + 4 * j + b, w - 1)] << (8 * b);
      }
      r.wd[j] = v;
    }
  }
  r.left = row[max(x0 - 1, 0)];
  r.right = row[min(x0 + STRIP, w - 1)];
  return r;
}

// s[0..3]: even pixels (4j, 4j+2) of word j; s[4..7]: odd pixels
// (4j+1, 4j+3); s[8]: left neighbour in the low lane, right neighbour
// in the high lane
__device__ __forceinline__ void unpack(const Raw& r, uint32_t (&s)[NREG]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = perm(r.wd[j], 0, 0x4240);
    s[4 + j] = perm(r.wd[j], 0, 0x4341);
  }
  s[8] = r.left | (r.right << 16);
}

// the register left of the even pixels of word j, and right of the odd
__device__ __forceinline__ uint32_t odd_before(const uint32_t (&s)[NREG],
                                               int j) {
  return j == 0 ? perm(s[8], s[4], 0x5410)
                : perm(s[4 + j - 1], s[4 + j], 0x5432);
}
__device__ __forceinline__ uint32_t even_after(const uint32_t (&s)[NREG],
                                               int j) {
  return j == 3 ? perm(s[3], s[8], 0x7632) : perm(s[j], s[j + 1], 0x5432);
}

// median of 9 from three sorted columns (left, centre, right)
__device__ __forceinline__ uint32_t pick(uint32_t lo_l, uint32_t lo_c,
                                         uint32_t lo_r, uint32_t mid_l,
                                         uint32_t mid_c, uint32_t mid_r,
                                         uint32_t hi_l, uint32_t hi_c,
                                         uint32_t hi_r) {
  return med3(__vimax3_u16x2(lo_l, lo_c, lo_r), med3(mid_l, mid_c, mid_r),
              __vimin3_u16x2(hi_l, hi_c, hi_r));
}

// one output row from its sorted columns, stored as 16 bytes
template <bool ALIGNED>
__device__ __forceinline__ void emit(const uint32_t (&lo)[NREG],
                                     const uint32_t (&mid)[NREG],
                                     const uint32_t (&hi)[NREG],
                                     uint8_t* __restrict__ orow, int x0,
                                     int w) {
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t even = pick(
        odd_before(lo, j), lo[j], lo[4 + j],
        odd_before(mid, j), mid[j], mid[4 + j],
        odd_before(hi, j), hi[j], hi[4 + j]);
    const uint32_t odd = pick(
        lo[j], lo[4 + j], even_after(lo, j),
        mid[j], mid[4 + j], even_after(mid, j),
        hi[j], hi[4 + j], even_after(hi, j));
    o[j] = perm(even, odd, 0x6240);   // the low byte of every lane
  }
  if (ALIGNED) {
    *reinterpret_cast<uint4*>(orow) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int i = 0; i < STRIP; ++i) {
      if (x0 + i < w) orow[i] = (uint8_t)(o[i >> 2] >> (8 * (i & 3)));
    }
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS3)
median3_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
               int h, int w, int strips, int bands, long long total) {
  const long long idx = (long long)blockIdx.x * THREADS3 + threadIdx.x;
  if (idx >= total) return;
  const int strip = (int)(idx % strips);
  const long long t = idx / strips;
  const int band = (int)(t % bands);
  const size_t plane = (size_t)(t / bands) * h * w;
  const int x0 = strip * STRIP;
  const int y0 = band * ROWS3;
  const uint8_t* px = x + plane;
  uint8_t* po = out + plane + x0;

  // input rows y0 - 1 .. y0 + ROWS3, clamped to the plane
  Raw raw[ROWS3 + 2];
#pragma unroll
  for (int j = 0; j < ROWS3 + 2; ++j) {
    if (j < 2 + AHEAD) {
      raw[j] = load_raw<ALIGNED>(
          px + (size_t)min(max(y0 - 1 + j, 0), h - 1) * w, x0, w);
    }
  }
  uint32_t a[NREG], b[NREG], c[NREG];
  unpack(raw[0], a);
  unpack(raw[1], b);
#pragma unroll
  for (int r = 0; r < ROWS3; ++r) {
    if (r + 2 + AHEAD < ROWS3 + 2) {
      raw[r + 2 + AHEAD] = load_raw<ALIGNED>(
          px + (size_t)min(y0 + 1 + r + AHEAD, h - 1) * w, x0, w);
    }
    unpack(raw[r + 2], c);
    // every column of three sorted once, shared by the outputs it feeds
    uint32_t lo[NREG], mid[NREG], hi[NREG];
#pragma unroll
    for (int j = 0; j < NREG; ++j) {
      lo[j] = __vimin3_u16x2(a[j], b[j], c[j]);
      hi[j] = __vimax3_u16x2(a[j], b[j], c[j]);
      mid[j] = mid_of(a[j], b[j], c[j], lo[j], hi[j]);
    }
    const int y = y0 + r;
    if (y < h) emit<ALIGNED>(lo, mid, hi, po + (size_t)y * w, x0, w);
#pragma unroll
    for (int j = 0; j < NREG; ++j) {
      a[j] = b[j];
      b[j] = c[j];
    }
  }
}

// ------------------------------------------------------------ k = 5, 7, 9

constexpr int TILE = 32;
constexpr int ROWS = 8;  // blockDim = (TILE, ROWS)

template <int K>
__global__ void median_kernel(const uint8_t* __restrict__ x,
                              uint8_t* __restrict__ out, int h, int w) {
  constexpr int R = K / 2;
  constexpr int SW = TILE + K - 1;
  constexpr int SH = TILE + K - 1;
  __shared__ uint8_t s[SH][SW];
  const size_t plane = (size_t)blockIdx.z * h * w;
  const int bx = blockIdx.x * TILE;
  const int by = blockIdx.y * TILE;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int i = tid; i < SH * SW; i += TILE * ROWS) {
    const int sy = i / SW;
    const int sx = i - sy * SW;
    const int yy = min(max(by + sy - R, 0), h - 1);
    const int xx = min(max(bx + sx - R, 0), w - 1);
    s[sy][sx] = x[plane + (size_t)yy * w + xx];
  }
  __syncthreads();

  const int ox = bx + threadIdx.x;
  if (ox >= w) return;
  for (int r = threadIdx.y; r < TILE; r += ROWS) {
    const int oy = by + r;
    if (oy >= h) break;
    int p[K * K];
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
#pragma unroll
      for (int dx = 0; dx < K; ++dx) p[dy * K + dx] = s[r + dy][threadIdx.x + dx];
    }
    constexpr int need = (K * K) / 2 + 1;
    int m = 0;
#pragma unroll
    for (int bit = 7; bit >= 0; --bit) {
      const int t = m | (1 << bit);
      int below = 0;
#pragma unroll
      for (int i = 0; i < K * K; ++i) below += p[i] < t;
      if (below < need) m = t;
    }
    out[plane + (size_t)oy * w + ox] = (uint8_t)m;
  }
}

}  // namespace

extern "C" int rvt_median_k(const void* x, void* out, int n, int h, int w,
                            int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* in = (const uint8_t*)x;
  uint8_t* o = (uint8_t*)out;
  if (k == 3) {
    const int strips = (w + STRIP - 1) / STRIP;
    const int bands = (h + ROWS3 - 1) / ROWS3;
    const long long total = (long long)n * bands * strips;
    const long long blocks = (total + THREADS3 - 1) / THREADS3;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const bool aligned = w % STRIP == 0 && (uintptr_t)in % 16 == 0 &&
                         (uintptr_t)o % 16 == 0;
    if (aligned) {
      median3_kernel<true><<<(unsigned)blocks, THREADS3, 0, st>>>(
          in, o, h, w, strips, bands, total);
    } else {
      median3_kernel<false><<<(unsigned)blocks, THREADS3, 0, st>>>(
          in, o, h, w, strips, bands, total);
    }
    return (int)cudaGetLastError();
  }
  dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, n);
  dim3 block(TILE, ROWS);
  switch (k) {
    case 5: median_kernel<5><<<grid, block, 0, st>>>(in, o, h, w); break;
    case 7: median_kernel<7><<<grid, block, 0, st>>>(in, o, h, w); break;
    case 9: median_kernel<9><<<grid, block, 0, st>>>(in, o, h, w); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
