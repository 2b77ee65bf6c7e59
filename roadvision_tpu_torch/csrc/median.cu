// Median filter on uint8 planes for Hopper (sm_90a), replicate border.
//
// K3 median_kernel<K>
//   Replaces roadvision_tpu/ops/pallas_median.py::median3_pallas (k = 3)
//   and, for k = 5, 7, 9, the XLA sort in
//   roadvision_tpu/ops/median.py::median_planar_i32, which the Pallas
//   kernel never covered.
//   Bound: device-memory bytes (each plane read once and written once;
//   ~99.5 MB for 3 planes x 8 x 1080p). The Pallas kernel computes in
//   int32 on 128x128 tiles because Mosaic rejects uint8 blocks and
//   unaligned lane slices; here the planes stay uint8 end to end.
//   Design: one block per 32x32 output tile of one plane stages the
//   (32+k-1)^2 halo in shared memory, clamping coordinates for the
//   replicate border, so each input byte comes from device memory about
//   once. Each thread then loads its k*k window into registers.
//   k = 3 runs the 19-exchange median-of-9 network of the Pallas kernel.
//   k >= 5 selects the median by a bitwise search on the value: the
//   largest m with #(p < m) < (k*k+1)/2, eight passes of k*k compares,
//   exact for any window.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;  // blockDim = (TILE, ROWS)

__device__ __forceinline__ void ex(int& a, int& b) {
  const int lo = min(a, b);
  const int hi = max(a, b);
  a = lo;
  b = hi;
}

__device__ __forceinline__ int median9(int* p) {
  ex(p[1], p[2]); ex(p[4], p[5]); ex(p[7], p[8]);
  ex(p[0], p[1]); ex(p[3], p[4]); ex(p[6], p[7]);
  ex(p[1], p[2]); ex(p[4], p[5]); ex(p[7], p[8]);
  ex(p[0], p[3]); ex(p[5], p[8]); ex(p[4], p[7]);
  ex(p[3], p[6]); ex(p[1], p[4]); ex(p[2], p[5]);
  ex(p[4], p[7]); ex(p[4], p[2]); ex(p[6], p[4]);
  ex(p[4], p[2]);
  return p[4];
}

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
    int m;
    if (K == 3) {
      m = median9(p);
    } else {
      constexpr int need = (K * K) / 2 + 1;
      m = 0;
#pragma unroll
      for (int bit = 7; bit >= 0; --bit) {
        const int t = m | (1 << bit);
        int below = 0;
#pragma unroll
        for (int i = 0; i < K * K; ++i) below += p[i] < t;
        if (below < need) m = t;
      }
    }
    out[plane + (size_t)oy * w + ox] = (uint8_t)m;
  }
}

}  // namespace

extern "C" int rvt_median_k(const void* x, void* out, int n, int h, int w,
                            int k, void* stream) {
  dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, n);
  dim3 block(TILE, ROWS);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* in = (const uint8_t*)x;
  uint8_t* o = (uint8_t*)out;
  switch (k) {
    case 3: median_kernel<3><<<grid, block, 0, st>>>(in, o, h, w); break;
    case 5: median_kernel<5><<<grid, block, 0, st>>>(in, o, h, w); break;
    case 7: median_kernel<7><<<grid, block, 0, st>>>(in, o, h, w); break;
    case 9: median_kernel<9><<<grid, block, 0, st>>>(in, o, h, w); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
