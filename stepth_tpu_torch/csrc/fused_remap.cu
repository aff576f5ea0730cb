// K11 — bilinear remap through an (x, y) sample map, fill outside.
//
// Replaces: stepth_tpu/ops/pallas_remap.py, `_remap_kernel` (called through
// `remap_bilinear_pallas`). The TPU kernel avoids gathers: a host plan per
// rig bounds each tile's source offsets, and the kernel rolls a VMEM band by
// every candidate offset. A GPU gathers natively, so this kernel samples
// the map directly: no plan, no smoothness limit, any map.
//
// Output contract: ops/rectify.remap_bilinear, i.e. the reference's
// map_coordinates(order=1, mode="nearest") masked by the raw map's
// in-bounds test. Per output pixel, with fy = y - floor(y), fx likewise:
//   out = ((((1-fy)(1-fx))·v00 + ((1-fy)fx)·v01) + (fy(1-fx))·v10) + (fy·fx)·v11
// added left to right, each weight product formed before it meets its
// value, the +1 taps clamped to the last row/column (where their weight is
// 0). Every product and sum is written with __fmul_rn/__fadd_rn/__fsub_rn so
// nvcc cannot contract a*b + c into an FMA: the kernel is bit-equal to the
// plain version in torch, which rounds each op.
//
// A pixel whose map entry is not finite or lies outside [0, Ws-1] x
// [0, Hs-1] (compared in f32; NaN compares false) gets `fill` and touches
// nothing else: no float-to-int conversion of a NaN or a huge value.
//
// What bounds it on an H100: memory. Per output pixel it reads the 8-byte
// map entry and four source taps and writes C floats; at 1080p gray that
// is ~33 MB, ~0.010 ms at 3.35 TB/s. Design: one thread per output pixel
// on a 2-D grid of 32 x 8 blocks, the map read as one float2 (a warp reads
// 256 consecutive bytes), the taps through __ldg (rectification maps are
// smooth, so neighbouring threads read neighbouring source pixels and L1
// serves the re-reads), and the C channel planes of an [H, W, C] image
// looped in the thread on the same weights: one launch per view.

#include "common.cuh"

namespace {

__global__ void remap_bilinear_kernel(const float* __restrict__ src,
                                      const float2* __restrict__ map,
                                      float* __restrict__ out, int hs, int ws,
                                      int h, int w, int c, float fill) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= w || oy >= h) return;
  const size_t o = (size_t)oy * w + ox;
  const float2 m = map[o];
  const float x = m.x, y = m.y;
  float* dst = out + o * c;
  if (!(x >= 0.f && x <= (float)(ws - 1) && y >= 0.f && y <= (float)(hs - 1))) {
    for (int k = 0; k < c; ++k) dst[k] = fill;
    return;
  }
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = __fsub_rn(x, x0f), fy = __fsub_rn(y, y0f);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  const float w00 = __fmul_rn(gy, gx), w01 = __fmul_rn(gy, fx);
  const float w10 = __fmul_rn(fy, gx), w11 = __fmul_rn(fy, fx);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = min(x0 + 1, ws - 1), y1 = min(y0 + 1, hs - 1);
  const float* r0 = src + (size_t)y0 * ws * c;
  const float* r1 = src + (size_t)y1 * ws * c;
  for (int k = 0; k < c; ++k) {
    float acc = __fmul_rn(w00, __ldg(r0 + (size_t)x0 * c + k));
    acc = __fadd_rn(acc, __fmul_rn(w01, __ldg(r0 + (size_t)x1 * c + k)));
    acc = __fadd_rn(acc, __fmul_rn(w10, __ldg(r1 + (size_t)x0 * c + k)));
    acc = __fadd_rn(acc, __fmul_rn(w11, __ldg(r1 + (size_t)x1 * c + k)));
    dst[k] = acc;
  }
}

}  // namespace

extern "C" int stepth_remap_bilinear(const float* src, const float* map, float* out,
                                     int hs, int ws, int h, int w, int c, float fill,
                                     void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  STEPTH_LAUNCH(remap_bilinear_kernel, grid, block, 0, stream, src,
                reinterpret_cast<const float2*>(map), out, hs, ws, h, w, c, fill);
}
