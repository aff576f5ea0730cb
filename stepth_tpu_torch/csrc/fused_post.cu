// Post-processing kernels: K3 (3x3 median), K4 (LR check), K5 (fill).
//
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

// K4 — left-right consistency check.
//
// Replaces: stepth_tpu/match/pallas_post.py, `_lr_kernel` (called through
// `lr_consistency_pallas`). Same output contract as dense.lr_consistency:
// with xr = clip(rint(x - dL), 0, W-1) in f32 (rintf rounds half to even,
// as jnp.round does), a pixel is valid iff |dL - dR[xr]| <= thr and the
// reference's sweep over shifts s < D selects xr: for xr >= 1 the shift
// x - xr lies in [0, D); for xr = 0 every s >= x samples the edge column,
// so x < D suffices. The Pallas kernel sweeps shifts per row slab; the
// closed form needs one gather per pixel.
//
// What bounds it on an H100: memory (8 bytes in, 1 out per pixel). One
// thread per pixel, 32 x 8 blocks so a warp reads 32 consecutive floats.
__global__ void lr_check_kernel(const float* __restrict__ dl,
                                const float* __restrict__ dr,
                                bool* __restrict__ out, int h, int w, int D,
                                float thr) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t row = (size_t)y * w;
  const float d = dl[row + x];
  const float xf = (float)x;
  const float xr = fminf(fmaxf(rintf(xf - d), 0.f), (float)(w - 1));
  const float shift = xf - xr;
  const bool in_range =
      xr >= 1.f ? (shift >= 0.f && shift < (float)D) : (x < D);
  out[row + x] = in_range && fabsf(d - dr[row + (int)xr]) <= thr;
}

// K5 — scanline occlusion fill.
//
// Replaces: stepth_tpu/match/pallas_post.py, `_fill_kernel` (called through
// `fill_invalid_pallas`). Same output contract as dense.fill_invalid: an
// invalid pixel takes min(nearest valid value to its left, nearest valid
// value to its right), 0 where neither exists; a valid pixel keeps its
// value. Selects only, so it is bit-equal to the plain version.
//
// What bounds it on an H100: memory (9 bytes in, 4 out per pixel) and the
// row scan's barriers. Design: one block per row; each of FT threads owns a
// contiguous chunk of columns, finds the last and first valid index in it,
// a shared-memory Hillis-Steele scan turns those into the nearest valid
// index before and after each chunk, and each thread then walks its chunk
// right to left (writing the right-hand candidate) and left to right
// (finishing the minimum).
constexpr int FT = 256;

// torch.minimum's NaN rule: a NaN operand wins.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__global__ void __launch_bounds__(FT) fill_invalid_kernel(
    const float* __restrict__ disp, const bool* __restrict__ valid,
    float* __restrict__ out, int h, int w) {
  __shared__ int last[FT];   // prefix max of each chunk's last valid index
  __shared__ int first[FT];  // suffix min of each chunk's first valid index
  const int t = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * w;
  const float* d = disp + row;
  const bool* v = valid + row;
  float* o = out + row;
  const int chunk = (w + FT - 1) / FT;
  const int a = min(t * chunk, w), b = min(a + chunk, w);

  int lv = -1, fv = w;
  for (int x = a; x < b; ++x) {
    if (v[x]) {
      if (fv == w) fv = x;
      lv = x;
    }
  }
  last[t] = lv;
  first[t] = fv;
  __syncthreads();
  for (int k = 1; k < FT; k <<= 1) {
    const int l = t >= k ? last[t - k] : -1;
    const int f = t + k < FT ? first[t + k] : w;
    __syncthreads();
    last[t] = max(last[t], l);
    first[t] = min(first[t], f);
    __syncthreads();
  }
  const float inf = __int_as_float(0x7f800000);
  // nearest valid value after the chunk, then walk right to left
  int ri = t + 1 < FT ? first[t + 1] : w;
  float right = ri < w ? d[ri] : inf;
  for (int x = b - 1; x >= a; --x) {
    if (v[x]) {
      right = d[x];
      o[x] = d[x];
    } else {
      o[x] = right;
    }
  }
  // nearest valid value before the chunk, then walk left to right
  int li = t > 0 ? last[t - 1] : -1;
  float left = li >= 0 ? d[li] : inf;
  for (int x = a; x < b; ++x) {
    if (v[x]) {
      left = d[x];
    } else {
      const float f = nan_min(left, o[x]);
      o[x] = isfinite(f) ? f : 0.f;
    }
  }
}

}  // namespace

extern "C" int stepth_lr_check(const float* dl, const float* dr, bool* out,
                               int h, int w, int D, float thr, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  STEPTH_LAUNCH(lr_check_kernel, grid, block, 0, stream, dl, dr, out, h, w, D, thr);
}

extern "C" int stepth_fill_invalid(const float* disp, const bool* valid,
                                   float* out, int h, int w, void* stream) {
  STEPTH_LAUNCH(fill_invalid_kernel, dim3(h), FT, 0, stream, disp, valid, out, h, w);
}

extern "C" int stepth_median3(const float* x, float* out, int h, int w,
                              void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  STEPTH_LAUNCH(median3_kernel, grid, block, 0, stream, x, out, h, w);
}
