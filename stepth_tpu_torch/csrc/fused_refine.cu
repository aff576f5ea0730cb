// K2 — tile-base refine kernel (one pyramid level), with its right view.
//
// Replaces: stepth_tpu/match/pallas_refine.py, `_refine_kernel` (called
// through `refine_level`). Same output contract: per (tile_rows x 128-column)
// plan tile, up to nw[i, jc] base windows in plan order, candidates
// s = base + o for o = -R..R ascending (s may be negative); cost
// |L(x) - R(x-s)| (or squared), or with nplanes > 0 the census Hamming
// distance of int32 descriptor planes [P, H, W]; 1e6 where x-s falls outside
// [0, W), zeroed outside the image before a zero-padded win x win box sum; a
// strict-< WTA merged across windows; subpixel pairs only within one window
// and only for offset index in [1, 2R-1]; result clipped to [0, W-1].
//
// Right view (lr = 1). The reference accumulates it from each tile's whole
// 256-column cost region, real columns [jc*128 - M, jc*128 - M + 256) with
// M = round_up(2*(win/2), 8), whose horizontal box sums wrap modulo 256 at
// both ends (pltpu.roll). A candidate at region column q' with offset o
// costs right column u = x(q') - s, and is taken only for
// q' in [R + o, 255 - R + o], with x(q') and u inside the image. The first
// minimum wins in the order (tile jc, window wi, offset o). So in this mode
// the block computes the circular box sums of the whole region; each thread
// keeps, for eight target positions q in [2R, 256) (u fixed per window), the
// window's running first minimum over o, and at the window's end merges it
// into a u64 [H, W] buffer by atomicMin of (f32 bits of the cost << 32 |
// (jc * K + wi) * (2R + 1) + o + R): costs are nonnegative, so the bits order
// as the values, and ties go to the smallest key, the reference's order.
// `stepth_refine_emit_r` then decodes the key through the plan into dR,
// -1e6 where no candidate reached u. The forward disparity reads the same
// sums at region columns [M, M + 128), where nothing wraps, so it is
// bit-equal to lr = 0.
//
// What bounds it on an H100: instructions, their latency and barriers, not
// bytes (a 1080p level reads ~16 MB of images in all). The work is (2R+1) x
// nw candidates of cost and box sums per pixel; the right view doubles the
// columns costed. The candidates of one window differ only by a shift of
// the right image's column, so the design stages each window once and
// costs all its candidates from shared memory:
//
// - A block owns an 8-row band of a 128-column plan tile (bands never
//   straddle plan tiles because tile_rows is a multiple of 8). Blocks of a
//   32-column slice of a tile, four times as many at the coarse levels,
//   were timed and not faster.
// - The band's left image (or census planes) with its box halo is copied
//   into shared memory once per block; per window, the right slab that
//   covers its candidates (columns x - base - R .. x - base + R of the band's
//   footprint, up to DC candidates at a time), clamped to the image: the cost
//   rule is applied per (column, candidate) in the walk (1e6 where x - s
//   falls outside [0, W), 0 outside the image or the shard's global rows).
//   The slab is read by the vertical pass only, so the next window's is
//   copied (cp.async, all of a thread's words in flight at once) while the
//   horizontal pass runs.
// - Vertical pass: one thread per (column, candidate; two with census and
//   no right view) costs the column from the tiles and forms the vertical box sums in
//   registers (common.cuh's vertical_walk, as K1 and K6), into shared
//   memory. One barrier pair a window (a chunk of DC candidates), none per
//   candidate.
// - Horizontal pass: one thread per 8 neighbouring columns of a row reads
//   its sums as float4s (swizzled: no bank conflicts), forms the horizontal
//   sums in registers and updates the WTA of its pixels: cost, neighbours
//   and the packed (window << 8 | offset index) of the first minimum, so the
//   disparity is read from the plan once at the end.
// - Right view: a warp is one row of the 256-column region; the circular
//   box sums wrap modulo 256 at both ends. Column q' at offset o offers its
//   cost to target q = q' + R - o, a shift uniform over the warp, so each
//   thread takes the sums its 8 targets need from its left neighbours by
//   shuffles and a 3-stage barrel shift, keeps their per-window first
//   minimum in registers and, at the window's end, merges it by atomicMin
//   into the u64 buffer.
//
// Windows 1..17 are compile-time instantiations (window 9 in the two-stage
// association); larger windows, and tiles of many census planes that would
// not fit in shared memory, run the same kernel with the box radius at run
// time, which sums each output's costs from the images in global memory.

#include <cmath>
#include <cstdint>

#include "common.cuh"

using namespace stepth;

namespace {

constexpr int BH = 8;     // output rows per block
constexpr int TW = 128;   // plan tile width (part of the output contract)
constexpr int CW = 256;   // the reference's cost-region width (right view)
constexpr int Q = 8;      // columns a thread of the horizontal pass takes
constexpr int DC = 5;     // candidates a chunk (a window's at R <= 2)
constexpr size_t kMaxSmem = 232448;  // shared memory a block may use
// candidates a vertical walk: two with census and no right view (the left
// words are loaded once for both), one otherwise (timed on an H100: two are
// 10-15% faster there, ~20% slower with SAD, ~5% slower with the right
// view, whose kernel is at its register cap)
constexpr int DW_CENSUS = 2;

// A block's shared geometry: box radius R, NR cost rows, TW columns of the
// left tile and of the sums (the band's forward columns and their box halo,
// or the 256-column region), the right slab's SW = TW + DC - 1 and the sums'
// physical row stride RS.
struct RefGeo {
  int R, NR, TW, SW, RS;
  __host__ __device__ constexpr RefGeo(int r, int cols)
      : R(r), NR(BH + 2 * r), TW(cols), SW(cols + DC - 1), RS(swz_width(cols)) {}
  // words: the sums [DC][BH][RS], the left tile [P][NR][TW], the slab [P][NR][SW]
  __host__ __device__ constexpr size_t words(int planes) const {
    return (size_t)DC * BH * RS + (size_t)planes * NR * (TW + SW);
  }
};

__host__ __device__ constexpr int sum_cols(bool lr, int r) { return lr ? CW : TW + 2 * r; }

template <bool LR, int R_>
struct RefFront {
  static constexpr int R = R_, BH = ::BH;
  static constexpr int NR = RefGeo(R_, sum_cols(LR, R_)).NR;
  static constexpr int TW = RefGeo(R_, sum_cols(LR, R_)).TW;
  static constexpr int SW = RefGeo(R_, sum_cols(LR, R_)).SW;
  static constexpr int RS = RefGeo(R_, sum_cols(LR, R_)).RS;
  static constexpr int R4 = LR ? (R_ + 3) / 4 * 4 : 0;  // sums read left of a segment
  static constexpr int NV = LR ? Q + 2 * R4 : (Q + 2 * R_ + 3) / 4 * 4;
};

struct RefArgs {
  const float* lg;
  const float* rg;
  const int* lc;
  const int* rc;
  int nplanes;
  const int* bases;
  const int* nw;
  float* disp;
  unsigned long long* rbuf;
  int h, w, nc, K, tile_rows, R, r, M, squared, g_row0, g_h;
};

// LR: with the right view (whole 256-column regions); RB: the box radius
// (< 0: a.r at run time).
template <bool LR, int RB, bool NINE>
__global__ void __launch_bounds__(LR ? 2 * TW : TW, LR ? 2 : 4)
    fused_refine_kernel(RefArgs a) {
  constexpr int NT = LR ? 2 * TW : TW;
  constexpr int TPR = LR ? CW / Q : TW / Q;  // threads a row of the horizontal pass
  constexpr bool RT = RB < 0;
  constexpr int RBc = RB < 0 ? 0 : RB;
  constexpr int DWC = LR ? 1 : DW_CENSUS;  // census candidates a walk
  using F = RefFront<LR, RBc>;
  static_assert(!LR || TPR == 32, "a warp is a row of the region");
  const RefGeo geo(RT ? a.r : RBc, sum_cols(LR, RT ? a.r : RBc));
  const int r = geo.R, R = a.R, n = 2 * a.R + 1;
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);
  uint32_t* lt = reinterpret_cast<uint32_t*>(vs + DC * BH * geo.RS);
  const int planes = a.nplanes ? a.nplanes : 1;
  uint32_t* rt = lt + planes * geo.NR * geo.TW;

  const int tid = threadIdx.x;
  const int jc = blockIdx.x;
  const int x0 = jc * TW;  // first forward column
  const int y0 = blockIdx.y * BH;
  const int tile = (y0 / a.tile_rows) * a.nc + jc;
  const int xo = LR ? jc * TW - a.M : x0 - r;  // the real column of sums column 0
  int nwt = a.nw[tile];
  nwt = nwt < 1 ? 1 : (nwt > a.K ? a.K : nwt);  // the reference always runs window 0
  // the cost rows that cost anything: inside [0, h) and the global [0, g_h)
  const int ylo = max(0, -a.g_row0), yhi = min(a.h, a.g_h - a.g_row0);
  const int klo = ylo - (y0 - r), khi = yhi - (y0 - r);
  uint32_t rowmask = 0;
  if (!RT) {
#pragma unroll
    for (int k = 0; k < F::NR; ++k) {
      if (k >= klo && k < khi) rowmask |= 1u << k;
    }
  }
  // the left tile and the first slab: column t of a slab holds right column
  // xo - s0 - (DC - 1) + t, s0 the chunk's first candidate
  if (!RT) {
    load_tile_async<NT>(lt, a.lg, a.lc, a.nplanes, a.h, a.w, y0 - r, xo, geo.NR, geo.TW);
    load_tile_async<NT>(rt, a.rg, a.rc, a.nplanes, a.h, a.w, y0 - r,
                        xo - (a.bases[tile * a.K] - R) - (DC - 1), geo.NR, geo.SW);
  }

  // horizontal pass: row j, columns [g * Q, g * Q + Q) of the sums (LR: of
  // the region; the forward pixels are region columns [M, M + 128))
  const int j = tid / TPR, g = tid % TPR;
  const bool fwd = !LR || (g * Q >= a.M && g * Q < a.M + TW);
  const int xf = LR ? xo + g * Q : x0 + g * Q;  // its first forward pixel
  const int nvalid = fwd && y0 + j < a.h ? min(Q, a.w - xf) : 0;
  float cb[Q], cm1[Q], cp1[Q], prev[Q], rb[LR ? Q : 1];
  int key[Q], ro[LR ? Q : 1];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    cb[i] = kBig; cm1[i] = 0.f; cp1[i] = kBig; key[i] = -2;
  }

  for (int wi = 0; wi < nwt; ++wi) {
    const int base = a.bases[tile * a.K + wi];
    const int nbase = wi + 1 < nwt ? a.bases[tile * a.K + wi + 1] : 0;
#pragma unroll
    for (int i = 0; i < Q; ++i) prev[i] = 0.f;
    if (LR) {
#pragma unroll
      for (int t = 0; t < Q; ++t) { rb[t] = kBig; ro[t] = -1; }
    }
    for (int oc0 = 0; oc0 < n; oc0 += DC) {
      const int dc = min(DC, n - oc0);
      const int s0 = base + oc0 - R;  // the chunk's first candidate
      cp_async_wait_all();
      __syncthreads();  // the chunk's slab (and the left tile) in place; the
                        // last chunk's sums read
      const int dw = a.nplanes && !RT ? DWC : 1;
      for (int e = tid; e < (dc + dw - 1) / dw * geo.TW; e += NT) {
        const int dd = e / geo.TW * dw, col = e % geo.TW;
        const int x = xo + col, xs = x - s0 - dd;
        const bool in = x >= 0 && x < a.w;
        uint32_t bad = 0;  // candidates whose right column lies outside the image
#pragma unroll
        for (int q = 0; q < DWC; ++q) bad |= (uint32_t)(xs - q < 0 || xs - q >= a.w) << q;
        float* out = vs + dd * BH * geo.RS + swz(col);
        const uint32_t* rcol = rt + col + DC - 1 - dd;
        if (RT) {
          const int lo = in ? ylo : 0, hi = in ? yhi : 0;
          const int xr = min(max(xs, 0), a.w - 1);
          if (a.nplanes) {
            vertical_walk_image<kCensus>(a.lg, a.rg, a.lc, a.rc, planes, a.h, a.w, y0, x, xr,
                                         bad & 1u, lo, hi, out, BH, geo.RS, r);
          } else if (a.squared) {
            vertical_walk_image<kSsd>(a.lg, a.rg, a.lc, a.rc, 1, a.h, a.w, y0, x, xr, bad & 1u,
                                      lo, hi, out, BH, geo.RS, r);
          } else {
            vertical_walk_image<kSad>(a.lg, a.rg, a.lc, a.rc, 1, a.h, a.w, y0, x, xr, bad & 1u,
                                      lo, hi, out, BH, geo.RS, r);
          }
        } else {
          const uint32_t mask = in ? rowmask : 0u;
          if (a.nplanes) {
            vertical_walk<F, DWC, NINE, kCensus, true>(lt + col, rcol, out, mask, planes, bad,
                                                      dc - dd);
          } else if (a.squared) {
            vertical_walk<F, 1, NINE, kSsd, true>(lt + col, rcol, out, mask, 1, bad,
                                                      dc - dd);
          } else {
            vertical_walk<F, 1, NINE, kSad, true>(lt + col, rcol, out, mask, 1, bad,
                                                      dc - dd);
          }
        }
      }
      __syncthreads();  // the chunk's sums are in place; the slab is free
      // copy the next chunk's slab while this one's sums are read
      if (!RT && oc0 + DC < n) {
        load_tile_async<NT>(rt, a.rg, a.rc, a.nplanes, a.h, a.w, y0 - r, xo - s0 - DC - (DC - 1),
                            geo.NR, geo.SW);
      } else if (!RT && wi + 1 < nwt) {
        load_tile_async<NT>(rt, a.rg, a.rc, a.nplanes, a.h, a.w, y0 - r,
                            xo - (nbase - R) - (DC - 1), geo.NR, geo.SW);
      }
      for (int dd = 0; dd < dc; ++dd) {
        const int oc = oc0 + dd;
        const float* row = vs + (dd * BH + j) * geo.RS;
        float z[Q];
        if (RT) {
#pragma unroll
          for (int i = 0; i < Q; ++i) {
            // the output's sums column (modulo 256 in the region)
            const int c = LR ? g * Q + i : g * Q + i + r;
            z[i] = box_rt([&](int t) { return row[swz(LR ? (c + t) & (CW - 1) : c + t)]; }, r);
          }
        } else {
          float v[F::NV];
#pragma unroll
          for (int m = 0; m < F::NV / 4; ++m) {
            // logical float4 of the row (LR: starting R4 left of the
            // segment, modulo the 64 of the region)
            const int f = LR ? (g * (Q / 4) - F::R4 / 4 + m) & (CW / 4 - 1) : g * (Q / 4) + m;
            const float4 q4 = *reinterpret_cast<const float4*>(row + 4 * (f + (f >> 3)));
            v[4 * m] = q4.x; v[4 * m + 1] = q4.y; v[4 * m + 2] = q4.z; v[4 * m + 3] = q4.w;
          }
          box_run<RBc, NINE, F::R4 - (LR ? RBc : 0)>(v, z);
        }
        // the forward WTA: strict <, merged across windows in plan order;
        // the subpixel pair only within one window
        const int cur = wi << 8 | oc;
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          const bool upd = z[i] < cb[i];
          const bool nxt = !upd && key[i] == cur - 1;
          if (upd) { cm1[i] = prev[i]; cb[i] = z[i]; key[i] = cur; }
          if (nxt) cp1[i] = z[i];
          prev[i] = z[i];
        }
        if (LR) {
          // target q = g*Q + t takes column q - sh, sh = R - o = 2R - oc in
          // [0, 2R]: from lane g - (sh >> 3) - 1 or g - (sh >> 3), element
          // (t - (sh & 7)) mod Q
          const int sh = 2 * R - oc, lsh = sh >> 3, bsh = sh & 7;
          float c16[2 * Q];
#pragma unroll
          for (int i = 0; i < Q; ++i) {
            c16[i] = __shfl_up_sync(0xffffffffu, z[i], lsh + 1);
            c16[Q + i] = __shfl_up_sync(0xffffffffu, z[i], lsh);
          }
#pragma unroll
          for (int st = 0; st < 3; ++st) {  // c16[i] <- c16[i - bsh], bsh < Q = 8
            const int b = 1 << st;
            const bool on = bsh & b;
#pragma unroll
            for (int i = 2 * Q - 1; i >= b; --i) c16[i] = on ? c16[i - b] : c16[i];
          }
#pragma unroll
          for (int t = 0; t < Q; ++t) {
            const int q = g * Q + t, xc = xo + q - sh, u = xo + q - R - base;
            if (q >= 2 * R && xc >= 0 && xc < a.w && u >= 0 && u < a.w &&
                c16[Q + t] < rb[t]) {
              rb[t] = c16[Q + t];
              ro[t] = oc;
            }
          }
        }
      }
    }
    if (LR && y0 + j < a.h) {
      const unsigned k0 = (unsigned)((jc * a.K + wi) * n);
#pragma unroll
      for (int t = 0; t < Q; ++t) {
        if (ro[t] < 0) continue;
        const int u = xo + g * Q + t - R - base;
        unsigned long long* p = a.rbuf + (size_t)(y0 + j) * a.w + u;
        const unsigned long long packed =
            ((unsigned long long)__float_as_uint(rb[t]) << 32) | (k0 + ro[t]);
        atomicMin(p, packed);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < Q; ++i) {
    if (i >= nvalid) continue;
    const int oi = key[i] & 0xff;
    const float denom = cm1[i] - 2.0f * cb[i] + cp1[i];
    float delta = fabsf(denom) > 1e-6f ? (cm1[i] - cp1[i]) / (2.0f * denom) : 0.f;
    delta = fminf(fmaxf(delta, -0.5f), 0.5f);
    float dv = (float)(a.bases[tile * a.K + (key[i] >> 8)] + oi - R);
    if (oi >= 1 && oi <= 2 * R - 1) dv = dv + delta;
    a.disp[(size_t)(y0 + j) * a.w + xf + i] = fminf(fmaxf(dv, 0.f), (float)(a.w - 1));
  }
}

// Right-view decode: the winning key of each (y, u) back to its candidate
// s = bases[i, jc, wi] + o; -1e6 where the buffer kept its all-ones start.
__global__ void refine_emit_r_kernel(const unsigned long long* __restrict__ rbuf,
                                     const int* __restrict__ bases,
                                     float* __restrict__ dispr, int h, int w,
                                     int nc, int K, int tile_rows, int R) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t o = (size_t)y * w + x;
  const unsigned long long v = rbuf[o];
  if (v == ~0ull) {
    dispr[o] = -1e6f;
    return;
  }
  const unsigned key = (unsigned)(v & 0xffffffffull);
  const unsigned n = 2 * R + 1;
  const int off = (int)(key % n) - R;
  const unsigned tw = key / n;
  const int wi = (int)(tw % K), jc = (int)(tw / K);
  dispr[o] = (float)(bases[((y / tile_rows) * nc + jc) * K + wi] + off);
}

// K2's plan — the per-tile search windows of one refine level.
//
// Replaces no Pallas kernel: it stands for the XLA glue of
// stepth_tpu/match/pallas_refine.py, `tile_windows_from_prior`, which the
// plain torch version (`fused_refine.tile_windows_from_prior`) launches as
// ~360 small ops a level. Same output contract, bases i32[nr, nc, K] and
// nw i32[nr, nc], for a prior f32[hp, wp] already padded to whole
// (tile_rows x 128) tiles and its tile means f32[nr, nc] (torch's own
// reduction, which the plain version takes too: a mean summed in another
// order could differ in the last bit and flip round(mean) at a half).
//
// One block a tile, one thread an 8x8 subtile ((tile_rows / 8) x 16 of
// them; a thread takes every blockDim-th subtile where there are more than
// 1024). A thread sums its subtile in the plain version's order (dy outer,
// dx inner, from 0.0f, no contraction), then scales by 1/64. The tile's
// min and max, and each greedy window's lowest uncovered subtile and the
// highest one within 2R of it, are block reductions: min and max are exact
// in any order. Everything after them is the plain version's f32 rule on
// values every thread holds, so all threads compute the same c. A tile whose
// prior fits one window stops after the first reduction; the cover stops
// once nothing is left uncovered (every later window repeats the 1e30
// sentinel's c, which the block writes without reducing again).
//
// What bounds it on an H100: bytes, one read of the padded prior (8.4 MB
// at 1088 x 1920, ~2.5 us at 3.35 TB/s); the greedy cover adds two barriers
// a window on the tiles that need more than one, and these chains, not the
// bytes, set its time (timed on an H100: 6-14 us at 1088 x 1920, K = 16,
// where the plain version takes milliseconds of host time). One block a tile
// because the cover of a tile is a chain of dependent reductions over its
// subtiles alone: nothing is shared between tiles, and a tile's subtiles
// fit one block.
constexpr int kPlanThreads = 1024;  // most threads a plan block takes
constexpr int kPlanOwn = 32;        // most subtiles a thread owns (a bit each)

struct PlanArgs {
  const float* prior;  // [hp, wp], hp = nr * tile_rows, wp = nc * 128
  const float* mean;   // [nr, nc]
  int* bases;          // [nr, nc, K]
  int* nw;             // [nr, nc]
  int wp, nc, tile_rows, K, max_base, R, single;
};

// The block's min of `lo` and max of `hi`, read by every thread. `buf`
// holds 64 floats (the warps' `lo`, then their `hi`); the caller alternates
// two such buffers between consecutive calls, so one barrier a call
// suffices. Threads past the block's subtiles pass +inf and -inf, which
// change neither.
__device__ __forceinline__ void block_minmax(float& lo, float& hi, float* buf) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    buf[warp] = lo;
    buf[32 + warp] = hi;
  }
  __syncthreads();
  lo = buf[0];
  hi = buf[32];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) {
    lo = fminf(lo, buf[i]);
    hi = fmaxf(hi, buf[32 + i]);
  }
}

__global__ void __launch_bounds__(kPlanThreads) refine_plan_kernel(PlanArgs a) {
  __shared__ float red[2][64];
  extern __shared__ float subs[];  // the tile's subtile means
  const int jc = blockIdx.x, i = blockIdx.y, tile = i * a.nc + jc;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float fmax_base = (float)a.max_base;
  const float bm = fminf(fmaxf(rintf(a.mean[tile]), 0.f), fmax_base);
  const int b_mean = (int)bm;
  int* bases = a.bases + (size_t)tile * a.K;
  if (a.single) {  // K = 2, nw = 1: both slots the tile mean's base
    if (tid < a.K) bases[tid] = b_mean;
    if (tid == 0) a.nw[tile] = 1;
    return;
  }

  // the subtile means; row-major (sr, sc) order within the tile
  const int nsub = a.tile_rows / 8 * (TW / 8);
  float lo = INFINITY, hi = -INFINITY;
  for (int s = tid; s < nsub; s += nt) {
    const float* p = a.prior + (size_t)(i * a.tile_rows + s / (TW / 8) * 8) * a.wp +
                     jc * TW + s % (TW / 8) * 8;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 8; ++dy) {
      // two float4: the wrapper checks that the prior is 16-byte aligned,
      // and wp and the subtile's first column are multiples of 8
      const float4* row = reinterpret_cast<const float4*>(p + (size_t)dy * a.wp);
      const float4 q0 = __ldg(row), q1 = __ldg(row + 1);
      const float v[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
      for (int dx = 0; dx < 8; ++dx) acc = __fadd_rn(acc, v[dx]);
    }
    const float m = __fmul_rn(acc, 1.0f / 64.0f);
    subs[s] = m;
    lo = fminf(lo, m);
    hi = fmaxf(hi, m);
  }
  block_minmax(lo, hi, red[0]);
  const float blo = fminf(fminf(fmaxf(floorf(lo), 0.f), fmax_base), bm);
  const float bhi = fmaxf(fminf(fmaxf(ceilf(hi), 0.f), fmax_base), bm);
  const float fr = (float)a.R;
  if (bm - blo <= fr && bhi - bm <= fr) {  // the tile fits one window
    for (int k = tid; k < a.K; k += nt) bases[k] = b_mean;
    if (tid == 0) a.nw[tile] = 1;
    return;
  }

  // the greedy cover: bit j of `uncov` is subtile tid + j * nt
  uint32_t uncov = 0;
  for (int s = tid, j = 0; s < nsub; s += nt, ++j) uncov |= 1u << j;
  const float reach = (float)(2 * a.R);
  int nw = 0, k = 0, c = 0;
  for (; k < a.K; ++k) {
    float v = INFINITY, vhi = -INFINITY;
    for (int s = tid, j = 0; s < nsub; s += nt, ++j) {
      v = fminf(v, (uncov >> j & 1u) ? subs[s] : kBig);
    }
    float unused = -INFINITY;
    block_minmax(v, unused, red[(2 * k + 1) & 1]);
    const float lim = __fadd_rn(v, reach);
    for (int s = tid, j = 0; s < nsub; s += nt, ++j) {
      const float m = subs[s];
      vhi = fmaxf(vhi, (uncov >> j & 1u) && m <= lim ? m : -kBig);
    }
    float none = INFINITY;
    block_minmax(none, vhi, red[(2 * k + 2) & 1]);
    vhi = fmaxf(vhi, v);
    c = (int)fminf(fmaxf(rintf(__fmul_rn(__fadd_rn(v, vhi), 0.5f)), 0.f), fmax_base);
    if (tid == 0) bases[k] = c;
    if (!(v < kBig)) break;  // nothing uncovered: every later window is this one
    ++nw;
    const float top = __fadd_rn((float)c, fr);
    for (int s = tid, j = 0; s < nsub; s += nt, ++j) {
      if (!(subs[s] > top)) uncov &= ~(1u << j);
    }
  }
  for (int kk = k + 1 + tid; kk < a.K; kk += nt) bases[kk] = c;
  if (tid == 0) a.nw[tile] = nw < 1 ? 1 : nw;
}


// shared memory of a block: the sums, and the tiles unless RB < 0
template <bool LR>
size_t refine_smem(const RefArgs& a, bool tiles) {
  return 4 * RefGeo(a.r, sum_cols(LR, a.r)).words(tiles ? (a.nplanes ? a.nplanes : 1) : 0);
}

template <bool LR, int RB, bool NINE>
int launch_refine(const RefArgs& a, void* stream) {
  const dim3 grid(a.nc, (a.h + BH - 1) / BH);
  auto kern = fused_refine_kernel<LR, RB, NINE>;
  STEPTH_LAUNCH(kern, grid, LR ? 2 * TW : TW, refine_smem<LR>(a, RB >= 0), stream, a);
}

// Windows up to 17 whose tiles fit in shared memory run the compile-time
// radius; the others read the images from global memory.
template <bool LR>
int launch_refine_window(const RefArgs& a, int win, void* stream) {
  if (refine_smem<LR>(a, true) > kMaxSmem) return launch_refine<LR, -1, false>(a, stream);
  if (win == 9) return launch_refine<LR, 4, true>(a, stream);
  switch (a.r) {
    case 0: return launch_refine<LR, 0, false>(a, stream);
    case 1: return launch_refine<LR, 1, false>(a, stream);
    case 2: return launch_refine<LR, 2, false>(a, stream);
    case 3: return launch_refine<LR, 3, false>(a, stream);
    case 4: return launch_refine<LR, 4, false>(a, stream);
    case 5: return launch_refine<LR, 5, false>(a, stream);
    case 6: return launch_refine<LR, 6, false>(a, stream);
    case 7: return launch_refine<LR, 7, false>(a, stream);
    case 8: return launch_refine<LR, 8, false>(a, stream);
    default: return launch_refine<LR, -1, false>(a, stream);
  }
}

}  // namespace

// `rbuf` (lr = 1) must hold all ones (u64 max) on entry.
extern "C" int stepth_fused_refine(
    const float* lg, const float* rg, const int* lc, const int* rc, int nplanes,
    const int* bases, const int* nw, float* disp, unsigned long long* rbuf,
    int h, int w, int nc, int K, int tile_rows, int R, int win, int M,
    int squared, int g_row0, int g_h, int lr, void* stream) {
  if (h < 1 || w < 1 || nc < 1 || K < 1 || R < 0 || 2 * R + 1 > 255 || win < 1 ||
      tile_rows < 8 || tile_rows % 8 || nplanes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const RefArgs a{lg, rg, lc, rc, nplanes, bases, nw, disp, rbuf, h, w, nc, K, tile_rows,
                  R, win / 2, M, squared, g_row0, g_h};
  if (lr) return launch_refine_window<true>(a, win, stream);
  return launch_refine_window<false>(a, win, stream);
}

extern "C" int stepth_refine_emit_r(const unsigned long long* rbuf,
                                    const int* bases, float* dispr, int h, int w,
                                    int nc, int K, int tile_rows, int R,
                                    void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  STEPTH_LAUNCH(refine_emit_r_kernel, grid, block, 0, stream, rbuf, bases, dispr,
                h, w, nc, K, tile_rows, R);
}

// The plan of a padded prior f32[hp, wp] (hp % tile_rows == 0, wp % 128 ==
// 0) from its tile means f32[nr, nc]: bases i32[nr, nc, K], nw i32[nr, nc].
// `single` (the capped window count is 1): K = 2, both slots round(mean).
extern "C" int stepth_refine_plan(const float* prior, const float* mean, int* bases, int* nw,
                                  int hp, int wp, int tile_rows, int K, int max_base, int R,
                                  int single, void* stream) {
  const int nsub = tile_rows / 8 * (TW / 8);
  if (hp < 1 || wp < TW || wp % TW || tile_rows < 8 || tile_rows % 8 || hp % tile_rows ||
      K < 1 || R < 0 || nsub > kPlanThreads * kPlanOwn ||
      reinterpret_cast<uintptr_t>(prior) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const PlanArgs a{prior, mean, bases, nw, wp, wp / TW, tile_rows, K, max_base, R, single};
  const dim3 grid(wp / TW, hp / tile_rows);
  const int threads = min((nsub + 31) / 32 * 32, kPlanThreads);
  STEPTH_LAUNCH(refine_plan_kernel, grid, threads, (size_t)nsub * sizeof(float), stream, a);
}
