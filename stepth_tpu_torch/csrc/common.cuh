// Shared device helpers for the port's kernels.
//
// box_ordered() reproduces the reference's box-sum association exactly, so a
// kernel, its plain PyTorch version and the Pallas kernel add the same f32
// values in the same order:
//   window 9:  y(k) = (c(k) + c(k-1)) + c(k+1);  z(k) = (y(k) + y(k-3)) + y(k+3)
//              (the two-stage 3x3 decomposition of pallas_dense.box_sum_slab)
//   otherwise: z(k) = ((c(k-r) + c(k-r+1)) + ...) + c(k+r)
// Only adds are involved, so no FMA contraction can change the result.
//
// cost_front_vertical() is K6's cost front (K1 forms the same costs and sums
// from shared-memory tiles of its own, in the same association), and
// WtaState the running first-minimum WTA of K1, K8 and K9.
#pragma once

#include <cuda_bf16.h>
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

// The cost front for disparity d of an output tile of BH rows starting at y0
// and QC - 2r cost columns starting at x0 (r = win / 2), computed by the NT
// threads of a block:
//   (1) C [BH + 2r][QC]: the masked cost of rows [y0 - r, y0 + BH + r) and
//       columns [x0 - r, x0 - r + QC) — SAD, SSD or, with nplanes > 0, the
//       census Hamming distance against the right sample at x - d (column
//       0 where x - d < 0), 0 outside the image (zero-padded box sums);
//   (2) V [BH][QC]: its vertical box sums for the BH output rows.
// The horizontal sum of output (k, q) is then box_ordered(&V[k*QC + q + r],
// 1, win). Ends with a barrier; the caller's reads of V for this d finish
// before its next call's first barrier, so C and V are safely reused.
template <int BH, int NT>
__device__ __forceinline__ void cost_front_vertical(
    float* C, float* V, const float* __restrict__ lg, const float* __restrict__ rg,
    const int* __restrict__ lc, const int* __restrict__ rc, int nplanes, int h, int w,
    int x0, int y0, int QC, int d, int win, int squared, int g_row0, int g_h) {
  const int r = win / 2;
  const int SR = BH + 2 * r;
  for (int e = threadIdx.x; e < SR * QC; e += NT) {
    const int k = e / QC, q = e - (e / QC) * QC;
    const int y = y0 - r + k, x = x0 - r + q;
    float c = 0.f;
    if (row_in_image(y, h, g_row0, g_h) && x >= 0 && x < w) {
      const int xs = x - d < 0 ? 0 : x - d;
      if (nplanes) {
        c = (float)hamming(lc, rc, nplanes, (size_t)h * w, (size_t)y * w, x, xs);
      } else {
        const float diff = lg[(size_t)y * w + x] - rg[(size_t)y * w + xs];
        c = squared ? diff * diff : fabsf(diff);
      }
    }
    C[e] = c;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BH * QC; e += NT) {
    const int k = e / QC, q = e - (e / QC) * QC;
    V[e] = box_ordered(&C[(k + r) * QC + q], QC, win);
  }
  __syncthreads();
}

// Parabolic subpixel disparity of a winner `bestd` with neighbour costs
// cm1, cp1 and cost cb (interior winners only), as the reference's WTA.
__device__ __forceinline__ float subpixel_disp(float cm1, float cb, float cp1, int bestd,
                                               int D) {
  const float denom = cm1 - 2.0f * cb + cp1;
  float delta = fabsf(denom) > 1e-6f ? (cm1 - cp1) / (2.0f * denom) : 0.f;
  delta = fminf(fmaxf(delta, -0.5f), 0.5f);
  const float bd = (float)bestd;
  return (bestd >= 1 && bestd <= D - 2) ? bd + delta : bd;
}

// The reference's running WTA over ascending d (strict <: the first minimum
// wins), with the subpixel neighbours and, for uniqueness, the best cost
// outside the winner's +-1 zone.
struct WtaState {
  float best, cm1, cb, cp1, prev, runlag2, second;
  int bestd;

  __device__ __forceinline__ void init() {
    best = kBig; cm1 = 0.f; cb = kBig; cp1 = kBig; prev = 0.f;
    runlag2 = kBig; second = kBig; bestd = 0;
  }

  __device__ __forceinline__ void update(float a, int d, bool use_uniq) {
    const bool upd = a < best;
    const bool is_next = !upd && bestd == d - 1;
    if (upd) { cm1 = prev; cb = a; }
    if (is_next) cp1 = a;
    if (use_uniq) {
      // second best outside the +-1 zone: restart from min over [0, d-2]
      // on a new best, else accumulate costs with d > bestd + 1
      const bool far = !upd && d > bestd + 1;
      if (upd) second = runlag2;
      if (far) second = fminf(second, a);
      runlag2 = fminf(runlag2, prev + (d < 1 ? kBig : 0.f));
    }
    if (upd) { best = a; bestd = d; }
    prev = a;
  }

  __device__ __forceinline__ float disp(int D) const {
    return subpixel_disp(cm1, cb, cp1, bestd, D);
  }

  __device__ __forceinline__ float valid(bool use_uniq, float uniq1p) const {
    return (!use_uniq || cb * uniq1p <= second) ? 1.f : 0.f;
  }
};

// f32 <-> volume element type (bf16 rounds to nearest even, as torch and
// jnp's astype do)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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
