// Shared device helpers for the port's kernels.
//
// box_ordered() reproduces the reference's box-sum association exactly, so a
// kernel, its plain PyTorch version and the Pallas kernel add the same f32
// values in the same order:
//   window 9:  y(k) = (c(k) + c(k-1)) + c(k+1);  z(k) = (y(k) + y(k-3)) + y(k+3)
//              (the two-stage 3x3 decomposition of pallas_dense.box_sum_slab)
//   otherwise: z(k) = ((c(k-r) + c(k-r+1)) + ...) + c(k+r)
// Only adds are involved, so no FMA contraction can change the result.
#pragma once

#include <cuda_runtime.h>

namespace stepth {

constexpr float kBig = 1e30f;

// Sum of the `win` values centred on p[0], spaced `stride` apart.
__device__ __forceinline__ float box_ordered(const float* p, int stride, int win) {
  if (win == 9) {
    const float* a = p - 3 * stride;
    const float* b = p + 3 * stride;
    float y0 = (p[0] + p[-stride]) + p[stride];
    float ym = (a[0] + a[-stride]) + a[stride];
    float yp = (b[0] + b[-stride]) + b[stride];
    return (y0 + ym) + yp;
  }
  const int r = win / 2;
  float z = p[-r * stride];
  for (int j = -r + 1; j <= r; ++j) z = z + p[j * stride];
  return z;
}

// Census cost: Hamming distance between the int32 descriptor planes
// [P, H, W] of the left image at (row, xl) and the right image at (row, xr);
// `plane` is H * W and `row` the row's offset y * W.
__device__ __forceinline__ int hamming(const int* __restrict__ lc,
                                       const int* __restrict__ rc, int nplanes,
                                       size_t plane, size_t row, int xl, int xr) {
  int ham = 0;
  for (int p = 0; p < nplanes; ++p) {
    ham += __popc((unsigned)(lc[p * plane + row + xl] ^ rc[p * plane + row + xr]));
  }
  return ham;
}

// In-image test for a cost row: local row y of an input that starts at
// global row g_row0 of an image g_h rows tall (a row shard carries halo
// rows that lie outside the global image).
__device__ __forceinline__ bool row_in_image(int y, int h, int g_row0, int g_h) {
  const int g = g_row0 + y;
  return y >= 0 && y < h && g >= 0 && g < g_h;
}

}  // namespace stepth

// Launch helper: sets the dynamic shared-memory cap when above the 48 KB
// default, launches, and returns cudaGetLastError().
#define STEPTH_LAUNCH(kernel, grid, block, smem, stream, ...)                  \
  do {                                                                         \
    if ((smem) > 48 * 1024) {                                                  \
      cudaError_t e_ = cudaFuncSetAttribute(                                   \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(smem));   \
      if (e_ != cudaSuccess) return (int)e_;                                   \
    }                                                                          \
    kernel<<<(grid), (block), (smem), (cudaStream_t)(stream)>>>(__VA_ARGS__);  \
    return (int)cudaGetLastError();                                            \
  } while (0)
