// K3 — 3x3 median filter.
//
// Replaces: stepth_tpu/match/pallas_post.py, `_median_kernel` (called through
// `median3_pallas`). Same output contract: the median of the 3x3
// neighbourhood with edge replicate (an out-of-image neighbour takes the
// clamped index), computed with the 19-comparator median-of-9 network in the
// reference's order. A selection, not arithmetic, so it equals dense.median3
// bit for bit.
//
// What bounds it on an H100: memory. It reads and writes 4 bytes per pixel
// (16.6 MB at 1080p); the 19 min/max pairs are far below the card's compute
// rate. Design: one thread per pixel, 32 x 8 blocks so a warp reads 32
// consecutive floats of a row; the eight neighbour re-reads hit L1/L2.

#include "common.cuh"

namespace {

__device__ __forceinline__ void cswap(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

__global__ void median3_kernel(const float* __restrict__ x,
                               float* __restrict__ out, int h, int w) {
  const int cx = blockIdx.x * blockDim.x + threadIdx.x;
  const int cy = blockIdx.y * blockDim.y + threadIdx.y;
  if (cx >= w || cy >= h) return;
  float p[9];
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = min(max(cy + dy, 0), h - 1);
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int xx = min(max(cx + dx, 0), w - 1);
      p[(dy + 1) * 3 + (dx + 1)] = x[(size_t)yy * w + xx];
    }
  }
  // Smith's median-of-9 network (pallas_post._MEDIAN9_NET)
  cswap(p[1], p[2]); cswap(p[4], p[5]); cswap(p[7], p[8]);
  cswap(p[0], p[1]); cswap(p[3], p[4]); cswap(p[6], p[7]);
  cswap(p[1], p[2]); cswap(p[4], p[5]); cswap(p[7], p[8]);
  cswap(p[0], p[3]); cswap(p[5], p[8]); cswap(p[4], p[7]);
  cswap(p[3], p[6]); cswap(p[1], p[4]); cswap(p[2], p[5]);
  cswap(p[4], p[7]); cswap(p[4], p[2]); cswap(p[6], p[4]);
  cswap(p[4], p[2]);
  out[(size_t)cy * w + cx] = p[4];
}

}  // namespace

extern "C" int stepth_median3(const float* x, float* out, int h, int w,
                              void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  STEPTH_LAUNCH(median3_kernel, grid, block, 0, stream, x, out, h, w);
}
