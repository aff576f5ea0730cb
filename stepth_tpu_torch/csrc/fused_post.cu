// Post-processing kernels: K3 (3x3 median), K4 (LR check), K5 (fill).
//
// K3 — 3x3 median filter.
//
// Replaces: stepth_tpu/match/pallas_post.py, `_median_kernel` (called through
// `median3_pallas`). Same output contract as the plain version
// (fused_post.median3_plain): the median of the 3x3 neighbourhood with edge
// replicate (an out-of-image neighbour takes the clamped index), by the
// 19-exchange median-of-9 network in the reference's order, each exchange a
// torch.minimum / torch.maximum pair (a NaN propagates: nan_min / nan_max).
// A selection, not arithmetic, so it equals the plain version bit for bit.
//
// What bounds it on an H100: memory, 4 bytes in and 4 out per pixel (16.6 MB
// at 1080p). Design: a thread makes a strip of 4 columns x RY rows. It
// issues the RY + 2 input rows' loads at once, as float4s (a warp reads
// 512 contiguous bytes of a row), and takes the columns left and right of
// its four from the neighbouring lanes by shuffles (the warp's edge lanes
// load them). The network's first nine exchanges sort each row triplet on
// its own, so each input row's triplets are sorted once and serve the three
// outputs that read that row; only the other ten exchanges run per output.
// Outputs leave as float4 streaming stores. RY is 8 where that still gives
// the card 8 warps a SM (1080p: 2,040 warps), else 2, else 1 (row shards,
// the coarse levels: shorter strips, more warps). Rows that are not 16-byte
// aligned (w % 4 != 0, offset views) run the same strips with scalar loads
// and stores.

#include "common.cuh"

namespace {

using stepth::nan_max;
using stepth::nan_min;

constexpr unsigned kFull = 0xffffffffu;
constexpr int MED_BY = 4;  // strips stacked in a block of 32 x MED_BY threads

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

__device__ __forceinline__ void cswap(float& a, float& b) {
  const float lo = nan_min(a, b), hi = nan_max(a, b);
  a = lo;
  b = hi;
}

// The network's first nine exchanges restricted to one row triplet:
// (1,2), (0,1), (1,2) (pallas_post._MEDIAN9_NET[0:9], rows 0, 1, 2).
__device__ __forceinline__ void sort_triplets(const float (&e)[6], float (&t)[4][3]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t[j][0] = e[j];
    t[j][1] = e[j + 1];
    t[j][2] = e[j + 2];
    cswap(t[j][1], t[j][2]);
    cswap(t[j][0], t[j][1]);
    cswap(t[j][1], t[j][2]);
  }
}

// The network's last ten exchanges on the sorted triplets of rows y - 1, y
// and y + 1: the median p[4].
__device__ __forceinline__ float median_of_sorted(const float (&a)[3], const float (&b)[3],
                                                  const float (&c)[3]) {
  float p[9] = {a[0], a[1], a[2], b[0], b[1], b[2], c[0], c[1], c[2]};
  cswap(p[0], p[3]); cswap(p[5], p[8]); cswap(p[4], p[7]);
  cswap(p[3], p[6]); cswap(p[1], p[4]); cswap(p[2], p[5]);
  cswap(p[4], p[7]); cswap(p[4], p[2]); cswap(p[6], p[4]);
  cswap(p[4], p[2]);
  return p[4];
}

template <bool VEC, int RY>
__global__ void __launch_bounds__(32 * MED_BY) median3_kernel(const float* __restrict__ x,
                                                              float* __restrict__ out, int h,
                                                              int w) {
  const int lane = threadIdx.x;
  const int y0 = (blockIdx.y * MED_BY + threadIdx.y) * RY;
  if (y0 >= h) return;  // a warp is one strip row: it leaves whole
  const int nq = (w + 3) / 4;  // column quads
  const int q = blockIdx.x * 32 + lane;
  const int c0 = 4 * min(q, nq - 1);  // lanes past the last quad load it again
  // e[i]: columns c0 - 1 .. c0 + 4 (clamped) of input row y0 - 1 + i (clamped)
  float e[RY + 2][6];
#pragma unroll
  for (int i = 0; i < RY + 2; ++i) {
    const float* row = x + (size_t)min(max(y0 - 1 + i, 0), h - 1) * w;
    if (VEC) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + c0));
      e[i][1] = v.x;
      e[i][2] = v.y;
      e[i][3] = v.z;
      e[i][4] = v.w;
      e[i][0] = lane == 0 ? __ldg(row + max(c0 - 1, 0)) : 0.f;
      e[i][5] = lane == 31 || c0 + 4 >= w ? __ldg(row + min(c0 + 4, w - 1)) : 0.f;
    } else {
#pragma unroll
      for (int t = 0; t < 6; ++t) e[i][t] = __ldg(row + min(max(c0 - 1 + t, 0), w - 1));
    }
  }
  if (VEC) {
#pragma unroll
    for (int i = 0; i < RY + 2; ++i) {
      const float l = __shfl_up_sync(kFull, e[i][4], 1);
      const float r = __shfl_down_sync(kFull, e[i][1], 1);
      if (lane != 0) e[i][0] = l;
      if (lane != 31 && c0 + 4 < w) e[i][5] = r;
    }
  }
  float ta[4][3], tb[4][3], tc[4][3];
  sort_triplets(e[0], ta);
  sort_triplets(e[1], tb);
#pragma unroll
  for (int k = 0; k < RY; ++k) {
    sort_triplets(e[k + 2], tc);
    float m[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = median_of_sorted(ta[j], tb[j], tc[j]);
    const int y = y0 + k;
    if (y < h && q < nq) {
      float* o = out + (size_t)y * w + 4 * q;
      if (VEC) {
        __stcs(reinterpret_cast<float4*>(o), make_float4(m[0], m[1], m[2], m[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * q + j < w) __stcs(o + j, m[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        ta[j][t] = tb[j][t];
        tb[j][t] = tc[j][t];
      }
    }
  }
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
// invalid pixel takes torch.minimum(nearest valid value to its left,
// nearest valid value to its right), +inf standing for a side with none, and
// 0 where that is not finite; a valid pixel keeps its value. Selects only,
// so it is bit-equal to the plain version.
//
// What bounds it on an H100: memory, 5 bytes in and 4 out per pixel (18.7 MB
// at 1080p). Design: one warp per row, FILL_WARPS rows a block, so that the
// 1,080 rows of a 1080p map are resident at once (270 blocks, up to four a
// SM) and no barrier is left. A lane holds 4 consecutive columns of each
// 128-column segment of the row. The warp issues all of its row's loads at
// once (a float4 of disp and 4 bytes of valid a lane and segment, up to NSEG
// segments: the on-chip row, 2048 columns at most, fewer for a narrow map,
// whose code is then shorter) and keeps the row in registers. The scans are
// ballots: the nearest lane below with a valid column (__clz of the ballot
// under the lane) hands over its last valid value by a shuffle, the nearest
// above (__ffs) its first; a warp-uniform carry crosses the segments,
// forward then backward; within a lane, four selects. Each output is written
// once, as a float4 streaming store. Rows wider than the on-chip row run in
// chunks of it: the invalid run after a chunk's last valid column takes one
// value, torch.minimum(the value left of it, the first valid value after
// it), and is written by stores alone once that value is known. Rows that
// are not 16-byte aligned (w % 4 != 0, offset views) load and store column
// by column.
constexpr int FILL_WARPS = 4;

__device__ __forceinline__ float finite_or_0(float f) { return isfinite(f) ? f : 0.f; }

// bit k set where byte k of a word of bools is not 0
__device__ __forceinline__ uint32_t valid_bits(uint32_t bytes) {
  return ((__vcmpne4(bytes, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

// o[a, b) = val, by the warp
template <bool VEC>
__device__ __forceinline__ void fill_run(float* __restrict__ o, int a, int b, float val,
                                         int lane) {
  int a4 = a, b4 = a;
  if (VEC) {
    a4 = min((a + 3) & ~3, b);
    b4 = max(b & ~3, a4);
    for (int i = a4 + 4 * lane; i < b4; i += 128)
      __stcs(reinterpret_cast<float4*>(o + i), make_float4(val, val, val, val));
  }
  for (int i = a + lane; i < a4; i += 32) __stcs(o + i, val);
  for (int i = b4 + lane; i < b; i += 32) __stcs(o + i, val);
}

template <bool VEC, int NSEG>
__global__ void __launch_bounds__(32 * FILL_WARPS) fill_invalid_kernel(
    const float* __restrict__ disp, const bool* __restrict__ valid, float* __restrict__ out,
    int h, int w) {
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.x * FILL_WARPS + (threadIdx.x >> 5);
  if (y >= h) return;  // the whole warp
  const float* d = disp + (size_t)y * w;
  const unsigned char* v = reinterpret_cast<const unsigned char*>(valid) + (size_t)y * w;
  float* o = out + (size_t)y * w;
  const float inf = __int_as_float(0x7f800000);
  const uint32_t below = (1u << lane) - 1u, above = ~below & ~(1u << lane);
  float carry_l = inf;  // the last valid value before the chunk (inf: none)
  int run = 0;          // columns [run, c0) are invalid and not written yet
  for (int c0 = 0; c0 < w; c0 += 128 * NSEG) {
    const bool last = c0 + 128 * NSEG >= w;
    const int nseg = min(NSEG, (w - c0 + 127) / 128);
    float4 q[NSEG];
    uint32_t m[NSEG];  // validity of q's four columns
#pragma unroll
    for (int s = 0; s < NSEG; ++s) {
      const int c = c0 + 128 * s + 4 * lane;
      q[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      m[s] = 0;
      if (VEC) {
        if (c < w) {
          q[s] = __ldcs(reinterpret_cast<const float4*>(d + c));
          m[s] = valid_bits(__ldcs(reinterpret_cast<const unsigned int*>(v + c)));
        }
      } else {
        float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c + k < w) {
            f[k] = d[c + k];
            m[s] |= (v[c + k] != 0 ? 1u : 0u) << k;
          }
        }
        q[s] = make_float4(f[0], f[1], f[2], f[3]);
      }
    }
    // forward: each invalid column takes the nearest valid value to its left
    const float entry_l = carry_l;
    bool any = false;  // the chunk has a valid column
    int lv = -1;       // its last valid column (rows of several chunks)
#pragma unroll
    for (int s = 0; s < NSEG; ++s) {
      if (s < nseg) {
        const uint32_t mk = m[s], bal = __ballot_sync(kFull, mk != 0);
        float4& e = q[s];
        const float lastv = (mk & 8) ? e.w : (mk & 4) ? e.z : (mk & 2) ? e.y : e.x;
        const uint32_t lo = bal & below;
        const float from = __shfl_sync(kFull, lastv, lo ? 31 - __clz(lo) : lane);
        const float left = lo ? from : carry_l;
        if (!(mk & 1)) e.x = left;
        if (!(mk & 2)) e.y = e.x;
        if (!(mk & 4)) e.z = e.y;
        if (!(mk & 8)) e.w = e.z;
        carry_l = __shfl_sync(kFull, e.w, 31);
        if (bal) {
          any = true;
          if (!last) {
            const int hi = 31 - __clz(bal);
            lv = c0 + 128 * s + 4 * hi + 31 - __clz(__shfl_sync(kFull, mk, hi));
          }
        }
      }
    }
    // backward: each invalid column takes min(its left value, the nearest
    // valid value to its right), 0 where that is not finite
    float carry_r = inf;
#pragma unroll
    for (int s = NSEG - 1; s >= 0; --s) {
      if (s < nseg) {
        const uint32_t mk = m[s], bal = __ballot_sync(kFull, mk != 0);
        float4& e = q[s];
        const float firstv = (mk & 1) ? e.x : (mk & 2) ? e.y : (mk & 4) ? e.z : e.w;
        const uint32_t hi = bal & above;
        const float from = __shfl_sync(kFull, firstv, hi ? __ffs(hi) - 1 : lane);
        float r = hi ? from : carry_r;
        if (mk & 8) r = e.w; else e.w = finite_or_0(nan_min(e.w, r));
        if (mk & 4) r = e.z; else e.z = finite_or_0(nan_min(e.z, r));
        if (mk & 2) r = e.y; else e.y = finite_or_0(nan_min(e.y, r));
        if (mk & 1) r = e.x; else e.x = finite_or_0(nan_min(e.x, r));
        carry_r = __shfl_sync(kFull, r, 0);
      }
    }
    // the run left open by earlier chunks ends at this chunk's first valid
    // value (carry_r), or at the row's end (inf)
    if (run < c0 && (any || last))
      fill_run<VEC>(o, run, c0, finite_or_0(nan_min(entry_l, carry_r)), lane);
    // columns from `limit` on wait for a later chunk's first valid value
    const int limit = last ? w : any ? lv + 1 : run;
#pragma unroll
    for (int s = 0; s < NSEG; ++s) {
      const int c = c0 + 128 * s + 4 * lane;
      if (s < nseg && c < limit) {
        const float4 e = q[s];
        if (VEC && c + 3 < limit) {
          __stcs(reinterpret_cast<float4*>(o + c), e);
        } else {
          __stcs(o + c, e.x);
          if (c + 1 < limit) __stcs(o + c + 1, e.y);
          if (c + 2 < limit) __stcs(o + c + 2, e.z);
          if (c + 3 < limit) __stcs(o + c + 3, e.w);
        }
      }
    }
    run = limit;
  }
}

// K5 with the fewest segments that hold a row (wider rows: 16, in chunks)
template <bool VEC>
int launch_fill(const float* disp, const bool* valid, float* out, int h, int w,
                void* stream) {
  auto kern = w <= 256    ? fill_invalid_kernel<VEC, 2>
              : w <= 512  ? fill_invalid_kernel<VEC, 4>
              : w <= 1024 ? fill_invalid_kernel<VEC, 8>
                          : fill_invalid_kernel<VEC, 16>;
  const dim3 grid((h + FILL_WARPS - 1) / FILL_WARPS);
  STEPTH_LAUNCH(kern, grid, 32 * FILL_WARPS, 0, stream, disp, valid, out, h, w);
}

// K3 with the tallest strips (8, 2 or 1 rows) that still give the card 8
// warps a SM
template <bool VEC>
int launch_median(const float* x, float* out, int h, int w, void* stream) {
  const long long nq = (w + 3) / 4, fill = 132 * 256;
  const int ry = nq * ((h + 7) / 8) >= fill ? 8 : nq * ((h + 1) / 2) >= fill ? 2 : 1;
  auto kern = ry == 8   ? median3_kernel<VEC, 8>
              : ry == 2 ? median3_kernel<VEC, 2>
                        : median3_kernel<VEC, 1>;
  const dim3 block(32, MED_BY);
  const dim3 grid((nq + 31) / 32, (h + ry * MED_BY - 1) / (ry * MED_BY));
  STEPTH_LAUNCH(kern, grid, block, 0, stream, x, out, h, w);
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
  if (w % 4 == 0 && aligned(disp, 16) && aligned(out, 16) && aligned(valid, 4))
    return launch_fill<true>(disp, valid, out, h, w, stream);
  return launch_fill<false>(disp, valid, out, h, w, stream);
}

extern "C" int stepth_median3(const float* x, float* out, int h, int w,
                              void* stream) {
  if (w % 4 == 0 && aligned(x, 16) && aligned(out, 16))
    return launch_median<true>(x, out, h, w, stream);
  return launch_median<false>(x, out, h, w, stream);
}
