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
// map entry and four source taps and writes C floats; at 1080p with C = 3
// that is ~66 MB, ~0.020 ms at 3.35 TB/s. Design: each thread makes 4
// consecutive output pixels of a row, so the wide accesses stay wide: the
// map's 4 entries come as two float4 (a warp reads 1 KB of consecutive
// bytes) and the 4·C outputs, 16C contiguous bytes, go out as C float4
// stores; the C channels of an [H, W, C] image share one pixel's weights,
// one launch per view. The taps stay __ldg gathers (rectification maps are
// smooth, so neighbouring threads read neighbouring source pixels and L1
// serves the re-reads). The vector accesses need W % 4 == 0 and a map and
// an output on 16-byte boundaries; otherwise (a view with a storage offset,
// any W) the same kernel reads and writes them element by element.

#include "common.cuh"

namespace {

// The bilinear taps of one map entry (x, y): false outside the source.
struct Taps {
  const float* r0;
  const float* r1;
  int x0, x1;
  float w00, w01, w10, w11;

  __device__ __forceinline__ bool init(const float* src, float x, float y, int hs, int ws,
                                       int c) {
    if (!(x >= 0.f && x <= (float)(ws - 1) && y >= 0.f && y <= (float)(hs - 1))) return false;
    const float x0f = floorf(x), y0f = floorf(y);
    const float fx = __fsub_rn(x, x0f), fy = __fsub_rn(y, y0f);
    const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
    w00 = __fmul_rn(gy, gx); w01 = __fmul_rn(gy, fx);
    w10 = __fmul_rn(fy, gx); w11 = __fmul_rn(fy, fx);
    x0 = (int)x0f * c;
    x1 = min((int)x0f + 1, ws - 1) * c;
    const int y0 = (int)y0f, y1 = min(y0 + 1, hs - 1);
    r0 = src + (size_t)y0 * ws * c;
    r1 = src + (size_t)y1 * ws * c;
    return true;
  }

  // channel k, in map_coordinates' order of products and sums
  __device__ __forceinline__ float sample(int k) const {
    float acc = __fmul_rn(w00, __ldg(r0 + x0 + k));
    acc = __fadd_rn(acc, __fmul_rn(w01, __ldg(r0 + x1 + k)));
    acc = __fadd_rn(acc, __fmul_rn(w10, __ldg(r1 + x0 + k)));
    return __fadd_rn(acc, __fmul_rn(w11, __ldg(r1 + x1 + k)));
  }
};

// C > 0: that many channels, vector stores when `vec`; C == 0: `c`
// channels, element stores. `vec`: the map is read as float4 too.
template <int C>
__global__ void __launch_bounds__(256) remap_bilinear_kernel(
    const float* __restrict__ src, const float* __restrict__ map, float* __restrict__ out,
    int hs, int ws, int h, int w, int c, float fill, int vec) {
  const int x0 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (x0 >= w || oy >= h) return;
  const size_t o = (size_t)oy * w + x0;
  const int np = min(4, w - x0);
  float mx[4], my[4];
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(map + 2 * o);
    const float4 b = *reinterpret_cast<const float4*>(map + 2 * o + 4);
    mx[0] = a.x; my[0] = a.y; mx[1] = a.z; my[1] = a.w;
    mx[2] = b.x; my[2] = b.y; mx[3] = b.z; my[3] = b.w;
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      mx[p] = p < np ? map[2 * (o + p)] : 0.f;
      my[p] = p < np ? map[2 * (o + p) + 1] : 0.f;
    }
  }
  if (C > 0 && vec) {
    float r[4 * (C > 0 ? C : 1)];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      Taps t;
      const bool in = t.init(src, mx[p], my[p], hs, ws, C);
#pragma unroll
      for (int k = 0; k < C; ++k) r[p * C + k] = in ? t.sample(k) : fill;
    }
    float4* dst = reinterpret_cast<float4*>(out + o * C);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      dst[k] = make_float4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
    }
    return;
  }
  const int cc = C > 0 ? C : c;
  for (int p = 0; p < np; ++p) {
    Taps t;
    const bool in = t.init(src, mx[p], my[p], hs, ws, cc);
    float* dst = out + (o + p) * cc;
    for (int k = 0; k < cc; ++k) dst[k] = in ? t.sample(k) : fill;
  }
}

template <int C>
int launch_remap(const float* src, const float* map, float* out, int hs, int ws, int h, int w,
                 int c, float fill, void* stream) {
  const int vec = w % 4 == 0 && (size_t)map % 16 == 0 && (size_t)out % 16 == 0;
  const dim3 block(32, 8);
  const dim3 grid(((w + 3) / 4 + 31) / 32, (h + 7) / 8);
  STEPTH_LAUNCH(remap_bilinear_kernel<C>, grid, block, 0, stream, src, map, out, hs, ws, h,
                w, c, fill, vec);
}

}  // namespace

extern "C" int stepth_remap_bilinear(const float* src, const float* map, float* out,
                                     int hs, int ws, int h, int w, int c, float fill,
                                     void* stream) {
  switch (c) {
    case 1: return launch_remap<1>(src, map, out, hs, ws, h, w, c, fill, stream);
    case 2: return launch_remap<2>(src, map, out, hs, ws, h, w, c, fill, stream);
    case 3: return launch_remap<3>(src, map, out, hs, ws, h, w, c, fill, stream);
    case 4: return launch_remap<4>(src, map, out, hs, ws, h, w, c, fill, stream);
    default: return launch_remap<0>(src, map, out, hs, ws, h, w, c, fill, stream);
  }
}
