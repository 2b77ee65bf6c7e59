// CLAHE on uint8 luma planes for Hopper (sm_90a): two kernels.
//
// K1 clahe_tile_luts_kernel
//   Replaces roadvision_tpu/ops/clahe.py::_luts_for_plane (histogram,
//   clip, redistribution, CDF). The JAX package computes it in XLA with
//   a nibble one-hot matmul per tile; there is no TPU kernel for it.
//   Bound: device-memory bytes (each input byte read once, 256 bytes
//   written per tile; ~16.6 MB for 8 x 1080p). Design: one block of 256
//   threads per (image, tile). The histogram lives in shared memory.
//   Flat image regions put many equal values in one warp, which would
//   serialise shared-memory atomics on one address, so each warp first
//   groups equal values with __match_any_sync and one lane adds the
//   group's count. Thread t then owns bin t for the clip, the OpenCV
//   redistribution and the 256-wide inclusive scan. The LUT is
//   rint(cdf * scale) in float32 with scale = float32(255 / tile_area)
//   from the host, as in clahe.py:177-182.
//
// K2 clahe_apply_kernel
//   Replaces roadvision_tpu/ops/pallas_clahe.py::sweep_pallas together
//   with the bilinear blend around it (clahe.py::_apply_band_sweep). On
//   the TPU a gather is slow, so the JAX package packs four LUT taps per
//   (bin, column) and sweeps all 256 bins; on Hopper a gather from
//   shared memory is cheap, so the packed table and the sweep go away.
//   Bound: device-memory bytes (plane read once, written once; ~33 MB
//   for 8 x 1080p). Design: a block stages its image's gy*gx*256 LUT
//   bytes (16 KiB at 8x8) in shared memory, then walks a band of rows;
//   each pixel reads its four taps and blends. Row and column tables
//   (tile indices, weights) come from the host, computed in numpy
//   exactly as clahe.py::_interp_coords / _interp_weight_num do.
//   "fixed" blend: exact uint32 rationals, half-even division
//   (clahe.py:338-345). "cv2" blend: every float multiply and add rounds
//   on its own (__fmul_rn / __fadd_rn, and the file is built with
//   --fmad=false), then rintf and clamp (clahe.py:347-375).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void clahe_tile_luts_kernel(const uint8_t* __restrict__ x,
                                       uint8_t* __restrict__ luts,
                                       int h, int w, int gy, int gx,
                                       int th, int tw, int clip,
                                       float scale) {
  __shared__ int hist[256];
  __shared__ int excess_s;
  const int tid = threadIdx.x;  // blockDim.x == 256
  const int lane = tid & 31;
  const int tile = blockIdx.x;
  const int n = blockIdx.y;
  const int ty = tile / gx;
  const int tx = tile - ty * gx;
  hist[tid] = 0;
  if (tid == 0) excess_s = 0;
  __syncthreads();

  const uint8_t* base = x + (size_t)n * h * w + (size_t)(ty * th) * w +
                        (size_t)(tx * tw);
  const int area = th * tw;
  // uniform trip count: every lane reaches __match_any_sync together
  for (int i0 = 0; i0 < area; i0 += 256) {
    const int i = i0 + tid;
    int v = 256 + lane;  // a value no other lane holds; never counted
    if (i < area) {
      const int yy = i / tw;
      const int xx = i - yy * tw;
      v = base[(size_t)yy * w + xx];
    }
    const unsigned peers = __match_any_sync(0xffffffffu, v);
    if (v < 256 && lane == __ffs(peers) - 1) {
      atomicAdd(&hist[v], __popc(peers));
    }
  }
  __syncthreads();

  int c = hist[tid];
  if (clip > 0) {
    const int clipped = min(c, clip);
    int ex = c - clipped;
    for (int o = 16; o > 0; o >>= 1) ex += __shfl_down_sync(0xffffffffu, ex, o);
    if (lane == 0) atomicAdd(&excess_s, ex);
    __syncthreads();
    const int excess = excess_s;
    const int redist = excess / 256;
    const int residual = excess - redist * 256;
    const int step = max(256 / max(residual, 1), 1);
    const int bump = (tid % step == 0) && (tid / step < residual);
    c = clipped + redist + bump;
  }
  __syncthreads();
  hist[tid] = c;
  __syncthreads();
  for (int off = 1; off < 256; off <<= 1) {
    const int add = tid >= off ? hist[tid - off] : 0;
    __syncthreads();
    hist[tid] += add;
    __syncthreads();
  }
  float r = rintf(__fmul_rn((float)hist[tid], scale));
  r = fminf(fmaxf(r, 0.0f), 255.0f);
  luts[(((size_t)n * gy + ty) * gx + tx) * 256 + tid] = (uint8_t)r;
}

__global__ void clahe_apply_kernel(const uint8_t* __restrict__ x,
                                   const uint8_t* __restrict__ luts,
                                   const int* __restrict__ row_i,
                                   const float* __restrict__ row_f,
                                   const int* __restrict__ col_i,
                                   const float* __restrict__ col_f,
                                   uint8_t* __restrict__ out,
                                   int h, int w, int gy, int gx, int th,
                                   int tw, int rows_per_block, int fixed) {
  extern __shared__ int4 lut_s4[];
  const uint8_t* lut_s = reinterpret_cast<const uint8_t*>(lut_s4);
  const int n = blockIdx.y;
  const int nl = gy * gx * 256;
  const int4* src4 = reinterpret_cast<const int4*>(luts + (size_t)n * nl);
  for (int i = threadIdx.x; i < nl / 16; i += blockDim.x) lut_s4[i] = src4[i];
  __syncthreads();

  const uint32_t twn = 2u * (uint32_t)tw;
  const uint32_t thn = 2u * (uint32_t)th;
  const uint32_t den = 4u * (uint32_t)th * (uint32_t)tw;
  const int y0 = blockIdx.x * rows_per_block;
  const int y1 = min(y0 + rows_per_block, h);
  for (int y = y0; y < y1; ++y) {
    const uint8_t* l1 = lut_s + row_i[3 * y] * gx * 256;
    const uint8_t* l2 = lut_s + row_i[3 * y + 1] * gx * 256;
    const uint32_t yan = (uint32_t)row_i[3 * y + 2];
    const float ya = row_f[2 * y];
    const float ya1 = row_f[2 * y + 1];
    const uint8_t* xr = x + ((size_t)n * h + y) * w;
    uint8_t* orow = out + ((size_t)n * h + y) * w;
    for (int xx = threadIdx.x; xx < w; xx += blockDim.x) {
      const int v = xr[xx];
      const int o1 = col_i[3 * xx] * 256 + v;
      const int o2 = col_i[3 * xx + 1] * 256 + v;
      const uint32_t l11 = l1[o1], l12 = l1[o2], l21 = l2[o1], l22 = l2[o2];
      uint32_t res;
      if (fixed) {
        const uint32_t xan = (uint32_t)col_i[3 * xx + 2];
        const uint32_t top = l11 * (twn - xan) + l12 * xan;
        const uint32_t bot = l21 * (twn - xan) + l22 * xan;
        const uint32_t num = top * (thn - yan) + bot * yan;
        const uint32_t q = num / den;
        const uint32_t rem = num - q * den;
        const uint32_t up = (2u * rem > den) || (2u * rem == den && (q & 1u));
        res = q + up;
      } else {
        const float xa = col_f[2 * xx];
        const float xa1 = col_f[2 * xx + 1];
        const float top = __fadd_rn(__fmul_rn((float)l11, xa1),
                                    __fmul_rn((float)l12, xa));
        const float bot = __fadd_rn(__fmul_rn((float)l21, xa1),
                                    __fmul_rn((float)l22, xa));
        float r = rintf(__fadd_rn(__fmul_rn(top, ya1), __fmul_rn(bot, ya)));
        r = fminf(fmaxf(r, 0.0f), 255.0f);
        res = (uint32_t)r;
      }
      orow[xx] = (uint8_t)res;
    }
  }
}

}  // namespace

extern "C" int rvt_clahe_tile_luts(const void* x, void* luts, int n, int h,
                                   int w, int gy, int gx, int th, int tw,
                                   int clip, float scale, void* stream) {
  dim3 grid(gy * gx, n);
  clahe_tile_luts_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (uint8_t*)luts, h, w, gy, gx, th, tw, clip, scale);
  return (int)cudaGetLastError();
}

extern "C" int rvt_clahe_apply(const void* x, const void* luts,
                               const void* row_i, const void* row_f,
                               const void* col_i, const void* col_f,
                               void* out, int n, int h, int w, int gy, int gx,
                               int th, int tw, int fixed, void* stream) {
  const int rows_per_block = 16;
  const size_t smem = (size_t)gy * gx * 256;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        clahe_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((h + rows_per_block - 1) / rows_per_block, n);
  clahe_apply_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (const uint8_t*)luts, (const int*)row_i,
      (const float*)row_f, (const int*)col_i, (const float*)col_f,
      (uint8_t*)out, h, w, gy, gx, th, tw, rows_per_block, fixed);
  return (int)cudaGetLastError();
}
