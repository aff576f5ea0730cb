// Shared device helpers for the port's kernels.
//
// The box sums reproduce the reference's association exactly, so a kernel,
// its plain PyTorch version and the Pallas kernel add the same f32 values in
// the same order:
//   window 9:  y(k) = (c(k) + c(k-1)) + c(k+1);  z(k) = (y(k) + y(k-3)) + y(k+3)
//              (the two-stage 3x3 decomposition of pallas_dense.box_sum_slab)
//   otherwise: z(k) = ((c(k-r) + c(k-r+1)) + ...) + c(k+r)
// Only adds are involved, so no FMA contraction can change the result.
//
// K1, K2 and K6 share the cost front: the images (or census planes) staged
// in shared-memory tiles by load_tile(), the costs and their vertical box
// sums formed in registers by vertical_walk(), the horizontal sums by
// box_run(); for a box radius known only at run time, vertical_walk_image()
// and box_rt() read the images from global memory instead. WtaState is the
// running first-minimum WTA of K1, K8 and K9.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace stepth {

constexpr float kBig = 1e30f;

enum Cost { kSad, kSsd, kCensus };

// The physical column of logical column `col` of a row of vertical sums:
// every 32 floats are followed by 4 spare ones, so that the 8 threads of a
// quarter-warp reading float4s 32 bytes apart hit distinct banks. Logical
// float4 f lies at float 4 * (f + (f >> 3)).
__device__ __forceinline__ int swz(int col) { return col + ((col >> 5) << 2); }
__host__ __device__ constexpr int swz_width(int cols) {
  return (cols + 3) / 4 * 4 + ((cols + 3) / 4 * 4 + 31) / 32 * 4;
}

// Sum of the 2R + 1 values v[i .. i + 2R], left to right (windows but 9).
template <int R, int N>
__device__ __forceinline__ float box_chain(const float (&v)[N], int i) {
  float z = v[i];
#pragma unroll
  for (int j = 1; j <= 2 * R; ++j) z = z + v[i + j];
  return z;
}

// The box sums of M consecutive centres v[OFF + R + i], window 9 forming
// each 3-sum once: y(k) = (c(k) + c(k-1)) + c(k+1), z(k) = (y(k) + y(k-3)) +
// y(k+3).
template <int R, bool NINE, int OFF, int N, int M>
__device__ __forceinline__ void box_run(const float (&v)[N], float (&z)[M]) {
  if (NINE) {
    float y3[M + 6];  // y3[m]: the 3-sum centred on v[OFF + m + 1]
#pragma unroll
    for (int m = 0; m < M + 6; ++m) y3[m] = (v[OFF + m + 1] + v[OFF + m]) + v[OFF + m + 2];
#pragma unroll
    for (int i = 0; i < M; ++i) z[i] = (y3[i + 3] + y3[i]) + y3[i + 6];
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) z[i] = box_chain<R>(v, OFF + i);
  }
}

// The word at (plane p, row y0 + k, column x0 + col) of the census planes
// `c` [P, h, w] (nplanes > 0) or of the f32 image `g`, clamped to the image
// (the costs mask what lies outside).
__device__ __forceinline__ const uint32_t* tile_src(const float* g, const int* c, int nplanes,
                                                    int h, int w, int p, int y, int x) {
  y = min(max(y, 0), h - 1);
  x = min(max(x, 0), w - 1);
  const size_t o = (size_t)y * w + x;
  return nplanes ? reinterpret_cast<const uint32_t*>(c + p * (size_t)h * w + o)
                 : reinterpret_cast<const uint32_t*>(g + o);
}

// Loads rows [y0, y0 + nr) x columns [x0, x0 + ncols) of every plane into
// dst [P][nr][ncols], by the NT threads of the block. Called with constant
// sizes it divides by constants only.
template <int NT>
__device__ __forceinline__ void load_tile(uint32_t* dst, const float* __restrict__ g,
                                          const int* __restrict__ c, int nplanes, int h,
                                          int w, int y0, int x0, int nr, int ncols) {
  const int planes = nplanes ? nplanes : 1;
  for (int e = threadIdx.x; e < planes * nr * ncols; e += NT) {
    const int p = e / (nr * ncols), k = e / ncols % nr, col = e % ncols;
    dst[e] = *tile_src(g, c, nplanes, h, w, p, y0 + k, x0 + col);
  }
}

// load_tile by asynchronous 4-byte copies (cp.async): every copy of the
// thread is in flight at once; cp_async_wait_all() then a barrier make them
// visible to the block.
__device__ __forceinline__ void cp_async_word(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
template <int NT>
__device__ __forceinline__ void load_tile_async(uint32_t* dst, const float* __restrict__ g,
                                                const int* __restrict__ c, int nplanes, int h,
                                                int w, int y0, int x0, int nr, int ncols) {
  const int planes = nplanes ? nplanes : 1;
  for (int e = threadIdx.x; e < planes * nr * ncols; e += NT) {
    const int p = e / (nr * ncols), k = e / ncols % nr, col = e % ncols;
    cp_async_word(dst + e, tile_src(g, c, nplanes, h, w, p, y0 + k, x0 + col));
  }
}

// The vertical pass of the shared-memory cost front (K1, K2, K6): one
// column and DW consecutive disparities (or candidates). F gives the
// geometry: BH output rows, box radius R, NR = BH + 2R cost rows, the row
// strides TW of the left tile, SW of the right slab and RS of the sums. For
// each disparity, the costs of the NR rows (0 where `mask` has no bit: rows
// outside the image or the global [0, g_h), and every row of a column
// outside the image; with BAD, 1e6 on the rows of `mask` for a candidate
// whose bit is set in `bad`: the right sample lies outside the image) and
// their vertical box sums for the BH output rows, stored a sums row apart
// from `out`, the next disparity's BH rows further. `lt` points at the
// column of the left tile, `rt` at the first disparity's column of the
// right slab (x - d; the next disparity's is one to the left). Only the
// first nq disparities' sums are stored.
template <class F, int DW, bool NINE, int COST, bool BAD>
__device__ __forceinline__ void vertical_walk(const uint32_t* lt, const uint32_t* rt,
                                              float* out, uint32_t mask, int planes,
                                              uint32_t bad, int nq = DW) {
  // every row is loaded (the tiles are clamped, so in bounds) and masked
  // after: no branch keeps a load from being issued early
  float c[DW][F::NR];
  if (COST == kCensus) {
    int ham[DW][F::NR] = {};
    for (int p = 0; p < planes; ++p) {
#pragma unroll
      for (int k = 0; k < F::NR; ++k) {
        const uint32_t l = lt[(p * F::NR + k) * F::TW];
#pragma unroll
        for (int q = 0; q < DW; ++q) ham[q][k] += __popc(l ^ rt[(p * F::NR + k) * F::SW - q]);
      }
    }
#pragma unroll
    for (int k = 0; k < F::NR; ++k) {
#pragma unroll
      for (int q = 0; q < DW; ++q) c[q][k] = (float)ham[q][k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < F::NR; ++k) {
      const float l = __uint_as_float(lt[k * F::TW]);
#pragma unroll
      for (int q = 0; q < DW; ++q) {
        const float diff = l - __uint_as_float(rt[k * F::SW - q]);
        c[q][k] = COST == kSsd ? __fmul_rn(diff, diff) : fabsf(diff);  // no FMA
      }
    }
  }
#pragma unroll
  for (int k = 0; k < F::NR; ++k) {
#pragma unroll
    for (int q = 0; q < DW; ++q) {
      c[q][k] = !(mask >> k & 1u) ? 0.f : BAD && (bad >> q & 1u) ? 1e6f : c[q][k];
    }
  }
#pragma unroll
  for (int q = 0; q < DW; ++q) {
    if (q >= nq) break;
    float z[F::BH];
    box_run<F::R, NINE, 0>(c[q], z);
#pragma unroll
    for (int j = 0; j < F::BH; ++j) out[(q * F::BH + j) * F::RS] = z[j];
  }
}

// The box sum of radius r centred on get(0), r known only at run time, in
// the reference's association (window 9 in two stages).
template <class G>
__device__ __forceinline__ float box_rt(const G& get, int r) {
  if (r == 4) {
    const float y0 = (get(0) + get(-1)) + get(1);
    const float ym = (get(-3) + get(-4)) + get(-2);
    const float yp = (get(3) + get(2)) + get(4);
    return (y0 + ym) + yp;
  }
  float z = get(-r);
  for (int t = -r + 1; t <= r; ++t) z = z + get(t);
  return z;
}

// The cost of pixel (y, x) against right column xr, read from the images
// (or census planes [P, h, w]) in global memory; y, x and xr in the image.
template <int COST>
__device__ __forceinline__ float image_cost(const float* __restrict__ lg,
                                            const float* __restrict__ rg,
                                            const int* __restrict__ lc,
                                            const int* __restrict__ rc, int planes, int h,
                                            int w, int y, int x, int xr) {
  const size_t o = (size_t)y * w;
  if (COST == kCensus) {
    int ham = 0;
    for (int p = 0; p < planes; ++p) {
      const size_t po = (size_t)p * h * w + o;
      ham += __popc((unsigned)(lc[po + x] ^ rc[po + xr]));
    }
    return (float)ham;
  }
  const float diff = lg[o + x] - rg[o + xr];
  return COST == kSsd ? __fmul_rn(diff, diff) : fabsf(diff);  // no FMA
}

// The vertical pass for a box radius r known only at run time (windows
// above 17, or tiles too large for shared memory), one disparity: the bh
// vertical sums of column x for output rows y0 .. y0 + bh - 1, each from its
// 2r + 1 costs read from the images (rows outside [ylo, yhi) cost 0; with
// `bad`, 1e6), stored `rs` apart from `out`. xr is the right column of x
// (already clamped where the contract clamps it).
template <int COST>
__device__ __forceinline__ void vertical_walk_image(
    const float* __restrict__ lg, const float* __restrict__ rg, const int* __restrict__ lc,
    const int* __restrict__ rc, int planes, int h, int w, int y0, int x, int xr, bool bad,
    int ylo, int yhi, float* out, int bh, int rs, int r) {
  for (int j = 0; j < bh; ++j) {
    const auto cost = [&](int i) {
      const int y = y0 + j + i;
      if (y < ylo || y >= yhi) return 0.f;
      return bad ? 1e6f : image_cost<COST>(lg, rg, lc, rc, planes, h, w, y, x, xr);
    };
    out[j * rs] = box_rt(cost, r);
  }
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

// torch.minimum / torch.maximum on the card: NaN where either operand is
// NaN, else min.f32 / max.f32, the instructions fminf / fmaxf (torch's ::min
// and ::max) compile to, so the sign of a zero comes out as torch gives it.
// One instruction each (sm_80+). The NaN is the canonical one where torch
// returns the NaN operand's bits: only NaN positions are compared.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

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
