// K6-K10 — the semi-global matching pipeline.
//
// Replaces the five Pallas kernels of stepth_tpu/match/pallas_sgm.py:
//   K6  `_volume_kernel`     -> sgm_volume_kernel:   box-aggregated cost volume
//   K7  `_scan_kernel`       -> sgm_scan_kernel:     one SGM direction, acc + L
//   K8  `_scan_wta_kernel`   -> sgm_scan_wta_kernel: the final up-scan with the
//                                                    WTA fused in
//   K9  `_wta_kernel`        -> sgm_wta_kernel:      WTA from a volume
//   K10 `_scan_kernel_carry` -> sgm_scan_kernel<..., CARRY = true>: K7 on a row
//                               shard, seeded from the upstream shard's final
//                               carry and emitting its own (the sharded relay)
// Volumes are [D, H, W] (d outermost, as the reference's), f32 or bf16, of
// the real image size: no padding, and no transposes — a scan indexes
// either axis directly.
//
// Exactness. Every f32 value is formed by the same ops in the same order as
// the reference: K6 uses common.cuh's cost front, in K1's association; a
// scan step is min_l = min_d prev, cand = min(prev, min(prev[d-1],
// prev[d+1]) + p1), cand = min(cand, min_l + p2), L = (c + cand) - min_l
// (only adds: no FMA can form), out = acc + L rounded once to the volume
// type; minima are exact in any order. The carry stays f32.
//
// Scans as independent chains. A direction with step (dy, dx) is a set of
// 1-D chains: rows (dy = 0), columns (dx = 0) or diagonals (both +-1), each
// starting from an all-zero predecessor where it enters the image — the
// reference's zero-filled carry shift. One warp walks one chain with the D
// path costs spread over its lanes (lane l holds d = l + 32 j, j < ND): min_l
// is a butterfly reduction, d +- 1 come by shuffles, d >= D lanes hold BIG.
//
// K7, K8 and K10 stage their inputs through shared memory. Read by a
// warp with d on its lanes, one step of one chain touches 32 planes H·W
// apart: 32 sectors for 128 useful bytes, one DRAM latency per serial step.
// So a block owns a band of neighbouring chains that is contiguous in
// memory at every step — a run of R elements (64 bytes of f32 at D=64): the
// columns [c0, c0 + R) of a row for dy = +-1 (chains indexed by their
// intercept c = x - dx·dy·y, so a diagonal band is a row segment that
// shifts by one column a row, with the lanes outside the image masked), or
// P rows, whose stage of R steps is one R-element run per (d, row), for
// dy = 0. Each stage's [D, P] runs of vol and acc go into a ring of shared-
// memory slots by 4-byte cp.async, whole sectors per request, one or two
// stages ahead of the recurrence;
// the warps then scan the stage from shared memory (a padded d-stride puts
// the 32 d's a warp reads in 32 banks), leave acc + L in the slot's acc
// region, and after a barrier the block writes that region back in runs of
// R consecutive addresses. What bounds a scan: the bytes (vol read, acc
// read, out written) at full resolution; the serial chain (H or W dependent
// steps of ~a dozen shuffles each) at the 135x240 coarse level.
//
// At D > 128 the staged tile falls to 2 steps a stage and one block an SM,
// so K7's scans over rows (dy = +-1: the diagonals, down and up) take a
// ring there instead, where the wrapper sees a pitch TMA can address
// (w·sizeof(T) and the pointers 16-byte multiples) and a schedule of no
// more blocks than the card has SMs: persistent blocks, a bulk tensor copy
// (TMA) per step and tensor into per-step slots, scan warps, write warps
// and a copy thread joined by per-slot mbarriers, no block-wide barrier
// (the section "K7 at D > 128" below). What bounds it on an H100 at 1080p,
// D=256: the write-back, not the copies or the recurrence, and most for
// the diagonals, whose unaligned runs share sectors with their neighbours.
// Upright images gain too (1920x1080: diagonals 8.1 -> 7.1 ms, 69
// blocks). The staged kernel still runs the scans along rows (dy = 0),
// every scan at D <= 128 (KITTI, the coarse levels), unaligned pitches,
// rows wider than 132 bands on an H100 (2112 columns), and K10; and every
// scan at 256 < D <= 512 (a 6 MP Middlebury frame at D=290), on a deep
// tiling that fits those D in a block's shared memory (the section "K7 at
// D > 256" below).
//
// K10 is K7's kernel with CARRY set; K7's instantiation compiles without the
// carry code. The scanned axis is rows (dy = +-1). A chain that starts on the
// shard's entry row (row 0 for dy > 0, h - 1 for dy < 0) at column x takes
// prev[d] = carry_in[d, x - dx] where 0 <= x - dx < w, else 0 — the zero-filled
// carry shift the continuous scan applies at that row; chains that enter a
// diagonal through the side column start from zeros, as in K7, because their
// predecessor lies outside the image in the continuous scan too. The chain
// that ends on the exit row at column x writes its last L to carry_out[:, x]
// (exactly one chain ends on each exit-row pixel; diagonal chains that leave
// through the side column write nothing). The step arithmetic is K7's, so a
// split scan relayed through K10 equals one continuous K7 scan bit for bit.
// Bound: bytes, like K7's, plus the two [D, w] f32 carries.
//
// K8 is K7's ↑y scan (the vertical staging: a band of R columns, P rows a
// stage, the same ring) with the WTA in place of the write-back. The warps
// scan the stage and leave agg = acc + L (f32, never rounded to the volume
// type) in shared memory; after a barrier one thread per (row, column) of
// the stage runs WtaState (common.cuh, K9's) over its D costs, while the
// others take the right view: each (row, u) the band reaches gets the first
// minimum over its columns x of agg(x, x - u), as (f32 bits << 32) | d,
// and one global atomicMin into a u64 [H, W] buffer. Path costs are >= +0
// when p1, p2 >= 0, so the bits order as the values and the smallest d
// wins a tie, whatever order the blocks run in — the reference's first
// minimum. A plain read before each atomicMin skips candidates that cannot
// win (values only decrease, so a stale read is safe). The wrapper decodes
// the low word. Bound: the bytes of vol and acc read once, like a K7 launch
// without its output volume. What sets K8's pace on an H100 is the warps'
// serial step: taking the WTA off it (shuffle reductions a step, a division
// on the winner's lane) was the largest gain among the variants timed.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes through the runtime)

#include "common.cuh"

using namespace stepth;

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---- K6: the volume ------------------------------------------------------
//
// What bounds K6 on an H100: bytes. It writes D·H·W values (531 MB in f32
// at 1080x1920, D=64) and reads two images; its ~10 f32 operations per value
// at window 5 take a fraction of the stores' time. So the design keeps the
// store stream full and spends few instructions per value, with K1's cost
// front (common.cuh):
//
// - A block owns a BH x BX output tile and a range of disparities (the
//   wrapper splits D over blockIdx.z when the tiles alone would leave the
//   card idle, as at the 135x240 coarse level), walked in chunks of DC.
// - The left image (or its census planes) of the tile and its box halo is
//   loaded once into shared memory, the right image's slab for SD
//   disparities once per SD, both clamped to the image.
// - Vertical pass: one thread per (DW disparities, column of the tile plus
//   its halo) costs the column's cells from the tiles and forms their
//   vertical box sums in registers (vertical_walk), into the chunk's half of
//   a double buffer of sums, so one barrier a chunk suffices.
// - Horizontal pass: one thread per Q neighbouring outputs of a row reads
//   the Q + 2r sums it needs as float4s (a swizzled layout: no bank
//   conflicts), forms the horizontal sums in registers and writes them as
//   16-byte vectors with a streaming hint (st.global.cs), a warp two whole
//   512-byte row segments of one d-plane (scalar stores where w is not a
//   multiple of the vector or the tile is cut by the image).
//
// Windows 1..17 are compile-time instantiations (window 9 in the two-stage
// association); larger windows, and tiles of many census planes that would
// not fit in shared memory, run the same kernel with the radius at run
// time, which sums each output's costs from the images in global memory.

struct VolTile {
  static constexpr int BH = 8, BX = 128, Q = 8, DC = 4, DW = 2, SD = 32, NT = 128;
  static constexpr int TPR = BX / Q;  // threads a row of the horizontal pass
  static_assert(BH * TPR == NT && SD % DC == 0 && DC % DW == 0 && Q % 4 == 0, "tile");
};
constexpr int kVolFillBlocks = 132 * 8;  // blocks that keep every SM busy
constexpr size_t kMaxSmem = 232448;       // shared memory a block may use

// A K6 block's shared geometry at box radius r: NR cost rows, the left
// tile's TW columns, the right slab's SW, the sums' physical row stride RS.
struct VolGeo {
  int R, NR, TW, SW, RS;
  __host__ __device__ constexpr explicit VolGeo(int r)
      : R(r), NR(VolTile::BH + 2 * r), TW(VolTile::BX + 2 * r),
        SW(VolTile::BX + 2 * r + VolTile::SD - 1), RS(swz_width(VolTile::BX + 2 * r)) {}
  // words: the double buffer of sums [2][DC][BH][RS], the left tile
  // [P][NR][TW] and the right slab [P][NR][SW]
  __host__ __device__ constexpr size_t words(int planes) const {
    return (size_t)2 * VolTile::DC * VolTile::BH * RS + (size_t)planes * NR * (TW + SW);
  }
};

template <int R_>
struct VolFront {
  static constexpr int R = R_, BH = VolTile::BH;
  static constexpr int NR = VolGeo(R_).NR, TW = VolGeo(R_).TW, SW = VolGeo(R_).SW;
  static constexpr int RS = VolGeo(R_).RS;
  static constexpr int NV = (VolTile::Q + 2 * R + 3) / 4 * 4;  // sums a thread reads
};

struct VolArgs {
  const float* lg;
  const float* rg;
  const int* lc;
  const int* rc;
  int nplanes;
  void* vol;
  int h, w, D, dz, squared, g_row0, g_h, r, vec;
};

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// n <= Q values of one row of a d-plane at p: one or two 16-byte streaming
// stores when the run is whole and aligned (vec), else one by one.
__device__ __forceinline__ void store_run(float* p, const float (&z)[VolTile::Q], int n,
                                          bool vec) {
  if (vec && n == VolTile::Q) {
#pragma unroll
    for (int i = 0; i < VolTile::Q; i += 4) {
      __stcs(reinterpret_cast<float4*>(p + i), make_float4(z[i], z[i + 1], z[i + 2], z[i + 3]));
    }
  } else {
    for (int i = 0; i < n; ++i) p[i] = z[i];
  }
}
__device__ __forceinline__ void store_run(__nv_bfloat16* p, const float (&z)[VolTile::Q],
                                          int n, bool vec) {
  if (vec && n == VolTile::Q) {
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(bf16_pair(z[0], z[1]), bf16_pair(z[2], z[3]),
                                                   bf16_pair(z[4], z[5]), bf16_pair(z[6], z[7])));
  } else {
    for (int i = 0; i < n; ++i) p[i] = __float2bfloat16_rn(z[i]);
  }
}

// R >= 0: the box radius at compile time; R < 0: a.r at run time.
template <typename T, int R, bool NINE>
__global__ void __launch_bounds__(VolTile::NT, 4) sgm_volume_kernel(VolArgs a) {
  using TL = VolTile;
  constexpr bool RT = R < 0;
  const VolGeo geo(RT ? a.r : (R < 0 ? 0 : R));
  const int r = geo.R;
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);
  uint32_t* lt = reinterpret_cast<uint32_t*>(vs + 2 * TL::DC * TL::BH * geo.RS);
  const int planes = a.nplanes ? a.nplanes : 1;
  uint32_t* rt = lt + planes * geo.NR * geo.TW;

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TL::BX, y0 = blockIdx.y * TL::BH;
  const int dlo = blockIdx.z * a.dz, dhi = min(a.D, dlo + a.dz);
  // the cost rows that cost anything: inside [0, h) and the global [0, g_h)
  const int ylo = max(0, -a.g_row0), yhi = min(a.h, a.g_h - a.g_row0);
  const int klo = ylo - (y0 - r), khi = yhi - (y0 - r);
  uint32_t rowmask = 0;
  if (!RT) {
#pragma unroll
    for (int k = 0; k < geo.NR; ++k) {
      if (k >= klo && k < khi) rowmask |= 1u << k;
    }
  }
  if (!RT) load_tile<TL::NT>(lt, a.lg, a.lc, a.nplanes, a.h, a.w, y0 - r, x0 - r, geo.NR, geo.TW);

  const int j = tid / TL::TPR, g = tid % TL::TPR;  // horizontal pass: row, lane
  const int xg = x0 + g * TL::Q;
  const int nvalid = y0 + j < a.h ? min(TL::Q, a.w - xg) : 0;
  const size_t plane = (size_t)a.h * a.w;
  T* outp = static_cast<T*>(a.vol) + (size_t)(y0 + j) * a.w + xg;

  int buf = 0;
  for (int d0 = dlo; d0 < dhi; d0 += TL::DC, buf ^= 1) {
    const int dc = min(TL::DC, dhi - d0);
    const int ds = d0 - (d0 - dlo) % TL::SD;  // the slab's first disparity
    if (!RT && d0 == ds) {
      // the right slab of disparities [ds, ds + SD): column t holds right
      // column x0 - r - ds - (SD - 1) + t (column 0 where it is < 0); the
      // last chunk's walks read the old one before the last barrier
      load_tile<TL::NT>(rt, a.rg, a.rc, a.nplanes, a.h, a.w, y0 - r, x0 - r - ds - (TL::SD - 1),
                geo.NR, geo.SW);
      __syncthreads();  // tiles in place
    }
    float* vb = vs + buf * TL::DC * TL::BH * geo.RS;
    if (RT) {
      for (int e = tid; e < dc * geo.TW; e += TL::NT) {
        const int dd = e / geo.TW, col = e % geo.TW;
        const int x = x0 - r + col, xr = max(x - (d0 + dd), 0);
        const bool in = x >= 0 && x < a.w;
        float* out = vb + dd * TL::BH * geo.RS + swz(col);
        const int lo = in ? ylo : 0, hi = in ? yhi : 0;
        if (a.nplanes) {
          vertical_walk_image<kCensus>(a.lg, a.rg, a.lc, a.rc, planes, a.h, a.w, y0, x, xr,
                                       false, lo, hi, out, TL::BH, geo.RS, r);
        } else if (a.squared) {
          vertical_walk_image<kSsd>(a.lg, a.rg, a.lc, a.rc, 1, a.h, a.w, y0, x, xr, false, lo,
                                    hi, out, TL::BH, geo.RS, r);
        } else {
          vertical_walk_image<kSad>(a.lg, a.rg, a.lc, a.rc, 1, a.h, a.w, y0, x, xr, false, lo,
                                    hi, out, TL::BH, geo.RS, r);
        }
      }
    } else {
      using F = VolFront<(R < 0 ? 0 : R)>;
      // (a walk of the last chunk may run past dc: its sums are not read,
      // and its slab column exists)
      for (int e = tid; e < (dc + TL::DW - 1) / TL::DW * F::TW; e += TL::NT) {
        const int dd = e / F::TW * TL::DW, col = e % F::TW;
        const int x = x0 - F::R + col;
        const uint32_t mask = x >= 0 && x < a.w ? rowmask : 0u;
        float* out = vb + dd * TL::BH * F::RS + swz(col);
        const uint32_t* rcol = rt + col + TL::SD - 1 - (d0 + dd - ds);
        if (a.nplanes) {
          vertical_walk<F, TL::DW, NINE, kCensus, false>(lt + col, rcol, out, mask, planes, 0);
        } else if (a.squared) {
          vertical_walk<F, TL::DW, NINE, kSsd, false>(lt + col, rcol, out, mask, 1, 0);
        } else {
          vertical_walk<F, TL::DW, NINE, kSad, false>(lt + col, rcol, out, mask, 1, 0);
        }
      }
    }
    __syncthreads();  // the chunk's sums are in place (and the chunk before
                      // last's horizontal pass is done with this buffer)
    if (nvalid <= 0) continue;
#pragma unroll
    for (int dd = 0; dd < TL::DC; ++dd) {
      if (dd >= dc) break;
      const float* row = vb + (dd * TL::BH + j) * geo.RS;
      float z[TL::Q];
      if (RT) {
#pragma unroll
        for (int i = 0; i < TL::Q; ++i) {
          const int c = g * TL::Q + i + r;  // the output's sums column
          z[i] = box_rt([&](int t) { return row[swz(c + t)]; }, r);
        }
      } else {
        using F = VolFront<(R < 0 ? 0 : R)>;
        float v[F::NV];
#pragma unroll
        for (int m = 0; m < F::NV / 4; ++m) {
          const int f = g * (TL::Q / 4) + m;  // logical float4 of the row
          const float4 q = *reinterpret_cast<const float4*>(row + 4 * (f + (f >> 3)));
          v[4 * m] = q.x; v[4 * m + 1] = q.y; v[4 * m + 2] = q.z; v[4 * m + 3] = q.w;
        }
        box_run<F::R, NINE, 0>(v, z);
      }
      store_run(outp + (size_t)(d0 + dd) * plane, z, nvalid, a.vec);
    }
  }
}

// shared memory of a block: the sums, and the tiles unless R < 0
size_t volume_smem(const VolArgs& a, bool tiles) {
  return 4 * VolGeo(a.r).words(tiles ? (a.nplanes ? a.nplanes : 1) : 0);
}

template <typename T, int R, bool NINE>
int launch_volume(const VolArgs& a, dim3 grid, void* stream) {
  auto kern = sgm_volume_kernel<T, R, NINE>;
  STEPTH_LAUNCH(kern, grid, VolTile::NT, volume_smem(a, R >= 0), stream, a);
}

// Windows up to 17 whose tiles fit in shared memory run the compile-time
// radius; the others read the images from global memory.
template <typename T>
int launch_volume_window(const VolArgs& a, int win, dim3 grid, void* stream) {
  if (volume_smem(a, true) > kMaxSmem) return launch_volume<T, -1, false>(a, grid, stream);
  if (win == 9) return launch_volume<T, 4, true>(a, grid, stream);
  switch (a.r) {
    case 0: return launch_volume<T, 0, false>(a, grid, stream);
    case 1: return launch_volume<T, 1, false>(a, grid, stream);
    case 2: return launch_volume<T, 2, false>(a, grid, stream);
    case 3: return launch_volume<T, 3, false>(a, grid, stream);
    case 4: return launch_volume<T, 4, false>(a, grid, stream);
    case 5: return launch_volume<T, 5, false>(a, grid, stream);
    case 6: return launch_volume<T, 6, false>(a, grid, stream);
    case 7: return launch_volume<T, 7, false>(a, grid, stream);
    case 8: return launch_volume<T, 8, false>(a, grid, stream);
    default: return launch_volume<T, -1, false>(a, grid, stream);
  }
}

// ---- the scan recurrence, shared by K7, K8 and K10 -----------------------

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// One step: L from the predecessor path costs `prev` and the costs c.
template <int ND>
__device__ __forceinline__ void scan_step(const float (&prev)[ND], const float (&c)[ND],
                                          float (&L)[ND], int lane, float p1, float p2) {
  float m = prev[0];
#pragma unroll
  for (int j = 1; j < ND; ++j) m = fminf(m, prev[j]);
  m = warp_min(m);
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    // prev[d - 1]: lane - 1 of the same j, or lane 31 of j - 1; BIG at d = 0
    const float a = __shfl_up_sync(kFull, prev[j], 1);
    const float b = __shfl_sync(kFull, j > 0 ? prev[j > 0 ? j - 1 : 0] : kBig, 31);
    const float up = lane == 0 ? b : a;
    // prev[d + 1]: lane + 1 of the same j, or lane 0 of j + 1 (BIG past D)
    const float a2 = __shfl_down_sync(kFull, prev[j], 1);
    const float b2 = __shfl_sync(kFull, j + 1 < ND ? prev[j + 1 < ND ? j + 1 : 0] : kBig, 0);
    const float dn = lane == 31 ? b2 : a2;
    float cand = fminf(prev[j], fminf(up, dn) + p1);
    cand = fminf(cand, m + p2);
    L[j] = (c[j] + cand) - m;
  }
}

// ---- K7 and K10: one direction, staged through shared memory -------------

// Asynchronous 4-byte copies global -> shared, committed and awaited in groups.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tiling of a scan. A run is R elements of one (d, row) that lie next
// to each other in memory. Chains run across runs for
// dy = +-1 (a block owns R neighbouring chains; a stage is P steps, one run
// per step) and along them for dy = 0 (a block owns P rows; a stage is R
// steps, one run per row). A slot holds the [D][P] runs of a stage for vol
// and for acc (whose place the outputs take), DSTR words per d: odd, so the
// 32 lanes of a warp reading 32 d's of one (run, element) hit 32 banks.
// bf16 runs are copied as whole 4-byte words from the word that holds
// their first element, one word more than R / 2; `par` is where in its
// word an element starts.
template <typename T, int R_, int P_, int NST_, bool HORIZ>
struct ScanTile {
  static constexpr int EPW = 4 / (int)sizeof(T);   // elements per word
  static constexpr int R = R_;                     // elements per run
  static constexpr int P = P_;
  static constexpr int NST = NST_;                 // ring slots
  static constexpr int RUNW = R / EPW + (EPW > 1); // words copied per run
  static constexpr int NCH = HORIZ ? P : R;  // chains per block, one warp each
  static constexpr int S = HORIZ ? R : P;    // steps per stage
  static constexpr int DSTR = (P * RUNW) | 1;
  static constexpr int NT = 32 * NCH;
  static_assert(RUNW <= R && NT % (P * R) == 0, "thread mapping: one (run, word) a thread");
};

// The tiling each scan takes, chosen by timing variants on an H100 at 1080p
// (D=64) and at the 135x240 coarse level (D=16); a slot stays <= ~68 KB.
// The copies, not the recurrence, set the pace at 1080p, and longer runs
// cost DRAM less (64-byte runs against 32-byte ones). But a horizontal
// scan's 1,080 chains must all be resident at once, ~8 per SM, which caps
// R·P·NST there (L2 prefetches of later stages, tried instead of a longer
// ring, made it slower).
//   dy = +-1: R chains of a band, P steps a stage, a 3-slot ring;
//   dy = 0:   P rows, R steps a stage, a 2-slot ring.
template <typename T, int ND, bool HORIZ>
struct ScanPick {
  using type = typename std::conditional<
      HORIZ, ScanTile<T, ND == 1 ? 32 : 16, ND <= 4 ? 2 : 1, 2, true>,
      ScanTile<T, ND == 1 ? 8 : 16, ND == 1 ? 16 : ND == 2 ? 8 : ND <= 4 ? 4 : 2, 3,
               false>>::type;
};

// Element offset of `p + off` within its 4-byte word (0 for f32).
template <typename T>
__device__ __forceinline__ int par(const T* p, long off) {
  if (sizeof(T) == 4) return 0;
  return (int)(((size_t)p / sizeof(T) + (size_t)off) & 1);
}

// Where the block's chains are: for dy = +-1, chains are indexed by their
// intercept c = x - sl * y (sl = dx * dy), so at row r the band [c0, c0 +
// R) is the row segment starting at column c0 + sl * r, and the block's
// rows are those where the band meets the image (t-th step: row r_lo + t
// going down, r_hi - t going up). For dy = 0, chains are the rows [y0, y0
// + P) and a stage's columns one run per row.
struct ScanGeo {
  int h, w, dy, dx, sl, c0, r_lo, r_hi, n;

  __device__ __forceinline__ void init(int h_, int w_, int dy_, int dx_, int nch) {
    if (dy_ == 0) {
      h = h_; w = w_; dy = dy_; dx = dx_;
      sl = 0;
      c0 = blockIdx.x * nch;
      r_lo = 0; r_hi = 0;
      n = w;
      return;
    }
    band(h_, w_, dy_, dx_, (dx_ * dy_ > 0 ? -(h_ - 1) : 0) + (int)blockIdx.x * nch, nch);
  }
  // dy = +-1: the band of nch chains whose first intercept is c0_
  __device__ __forceinline__ void band(int h_, int w_, int dy_, int dx_, int c0_, int nch) {
    h = h_; w = w_; dy = dy_; dx = dx_;
    sl = dx * dy;
    c0 = c0_;
    if (sl == 0) {
      r_lo = 0; r_hi = h - 1;
    } else if (sl > 0) {  // x = c + r
      r_lo = max(0, -(c0 + nch - 1));
      r_hi = min(h - 1, w - 1 - c0);
    } else {  // x = c - r
      r_lo = max(0, c0 - w + 1);
      r_hi = min(h - 1, c0 + nch - 1);
    }
    n = r_hi - r_lo + 1;
  }
  __device__ __forceinline__ int row_of_step(int t) const {
    return dy > 0 ? r_lo + t : r_hi - t;
  }
};

// Run q of stage st: its row, the column of its element 0, the columns of
// it inside the image [xa, xb); `false` when it holds nothing.
template <int R, int S, bool HORIZ>
__device__ __forceinline__ bool run_of(const ScanGeo& g, int st, int q, int* row, int* xs,
                                       int* xa, int* xb) {
  if (HORIZ) {
    *row = g.c0 + q;
    *xs = g.dx > 0 ? st * S : g.w - (st + 1) * S;
    *xa = max(*xs, 0);
    *xb = min(*xs + S, g.w);
    return *row < g.h;
  }
  const int t = st * S + q;
  *row = g.row_of_step(t);
  *xs = g.c0 + g.sl * *row;
  *xa = max(*xs, 0);
  *xb = min(*xs + R, g.w);
  return t < g.n;
}

// Copy stage st of `src` into the slot region at shared address `dst`. A
// thread keeps one (run, word) and strides over d.
template <class G, bool HORIZ, typename T>
__device__ __forceinline__ void scan_copy(const T* src, uint32_t dst, const ScanGeo& g,
                                          int st, int D, long plane) {
  constexpr int U = G::P * G::R;
  const int q = (threadIdx.x % U) / G::R, i = threadIdx.x % G::R;
  int row, xs, xa, xb;
  if (i >= G::RUNW || !run_of<G::R, G::S, HORIZ>(g, st, q, &row, &xs, &xa, &xb)) return;
  for (int d = threadIdx.x / U; d < D; d += G::NT / U) {
    const long off = d * plane + (long)row * g.w + xs;
    const int p0 = par(src, off);
    const int col = xs - p0 + G::EPW * i;  // the word's first column
    // a word is copied when it holds a column of the image; the aligned
    // word around an element of the tensor lies in a mapped page
    if (col + G::EPW - 1 < xa || col >= xb) continue;
    cp_async4(dst + 4u * (d * G::DSTR + q * G::RUNW + i), src + off - p0 + G::EPW * i);
  }
}

// Write stage st's outputs from the slot's acc region (laid out as `lay`'s
// words) to `out`, element by element, runs of R consecutive addresses.
template <class G, bool HORIZ, typename T>
__device__ __forceinline__ void scan_write(T* out, const T* tile, const T* lay,
                                           const ScanGeo& g, int st, int D, long plane) {
  constexpr int U = G::P * G::R;
  const int q = (threadIdx.x % U) / G::R, e = threadIdx.x % G::R;
  int row, xs, xa, xb;
  if (!run_of<G::R, G::S, HORIZ>(g, st, q, &row, &xs, &xa, &xb)) return;
  if (xs + e < xa || xs + e >= xb) return;
  for (int d = threadIdx.x / U; d < D; d += G::NT / U) {
    const long off = d * plane + (long)row * g.w + xs;
    out[off + e] = tile[(d * G::DSTR + q * G::RUNW) * G::EPW + par(lay, off) + e];
  }
}

template <typename T, int ND, bool HORIZ, bool CARRY, class G>
__global__ void __launch_bounds__(G::NT) sgm_scan_kernel(
    const T* __restrict__ vol, const T* acc, T* out, const float* __restrict__ carry_in,
    float* __restrict__ carry_out, int D, int h, int w, int dy, int dx, float p1, float p2) {
  extern __shared__ uint32_t scan_smem[];
  const int k = threadIdx.x / 32;  // this warp's chain in the block
  const int lane = threadIdx.x & 31;
  ScanGeo g;
  g.init(h, w, dy, dx, G::NCH);
  const long plane = (long)h * w;
  const int slot_words = 2 * D * G::DSTR;  // vol region, then acc/out region
  const uint32_t smem_s = (uint32_t)__cvta_generic_to_shared(scan_smem);
  const T* lay = acc ? acc : vol;  // the layout of the outputs in a slot
  float prev[ND], c[ND], a[ND], L[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    prev[j] = lane + 32 * j < D ? 0.f : kBig;
    c[j] = 0.f;
    a[j] = 0.f;
  }
  // K10: a chain on the entry row continues the upstream scan
  const int xk_in = g.c0 + k + g.sl * (dy > 0 ? 0 : h - 1);
  if (CARRY && carry_in && xk_in >= 0 && xk_in < w && xk_in - dx >= 0 && xk_in - dx < w) {
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = lane + 32 * j;
      if (d < D) prev[j] = carry_in[(size_t)d * w + xk_in - dx];
    }
  }
  const int nst = (g.n + G::S - 1) / G::S;
  auto copy = [&](int st) {
    const uint32_t base = smem_s + 4u * (st % G::NST) * slot_words;
    scan_copy<G, HORIZ>(vol, base, g, st, D, plane);
    if (acc) scan_copy<G, HORIZ>(acc, base + 4u * D * G::DSTR, g, st, D, plane);
  };
#pragma unroll
  for (int st = 0; st < G::NST - 1; ++st) {
    if (st < nst) copy(st);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<G::NST - 2>();
    __syncthreads();  // stage st has landed; stage st - 1 is written back
    if (st + G::NST - 1 < nst) copy(st + G::NST - 1);
    cp_async_commit();
    uint32_t* slot = scan_smem + (st % G::NST) * slot_words;
    const T* tv = reinterpret_cast<const T*>(slot);
    T* ta = reinterpret_cast<T*>(slot + D * G::DSTR);
    for (int s = 0; s < G::S; ++s) {
      const int t = st * G::S + s;
      if (t >= g.n) break;
      int q, pos, row, xs;
      if (HORIZ) {
        row = g.c0 + k;
        if (row >= h) break;
        q = k;
        xs = dx > 0 ? st * G::S : w - (st + 1) * G::S;
        pos = dx > 0 ? s : G::S - 1 - s;
      } else {
        row = g.row_of_step(t);
        xs = g.c0 + g.sl * row;
        if (xs + k < 0 || xs + k >= w) continue;  // the chain is outside the image here
        q = s;
        pos = k;
      }
      const long roff = (long)row * w + xs;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int d = lane + 32 * j;
        if (d < D) {
          const long off = d * plane + roff;
          const int wi = (d * G::DSTR + q * G::RUNW) * G::EPW + pos;
          c[j] = to_f32(tv[wi + par(vol, off)]);
          if (acc) a[j] = to_f32(ta[wi + par(acc, off)]);
        }
      }
      scan_step<ND>(prev, c, L, lane, p1, p2);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int d = lane + 32 * j;
        if (d < D) {
          const long off = d * plane + roff;
          ta[(d * G::DSTR + q * G::RUNW) * G::EPW + pos + par(lay, off)] =
              from_f32<T>(acc ? a[j] + L[j] : L[j]);
          prev[j] = L[j];
        } else {
          prev[j] = kBig;
        }
      }
    }
    __syncthreads();  // every chain has scanned stage st
    scan_write<G, HORIZ>(out, ta, lay, g, st, D, plane);
  }
  // K10: the chain that ends on the exit row hands its last L downstream
  const int xk_out = g.c0 + k + g.sl * (dy > 0 ? h - 1 : 0);
  if (CARRY && xk_out >= 0 && xk_out < w) {
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = lane + 32 * j;
      if (d < D) carry_out[(size_t)d * w + xk_out] = prev[j];
    }
  }
}

// ---- K7 at D > 128, dy = +-1: a ring of step slots fed by TMA ------------
//
// A persistent block owns whole bands of R neighbouring chains (the bands
// the wrapper's schedule gives it) and streams their steps, band after band,
// through a ring of slots, each holding one step of one band: the [D] runs
// of vol (and of acc) at the step's row, one bulk tensor copy (TMA) each. A
// copy's box must start on a 16-byte boundary (an unaligned start is an
// illegal instruction on an H100), and a diagonal band's run starts on any
// column, so the box is [BW = R + EPC columns x 1 row x D] from the 16-byte
// boundary at or left of the run (EPC elements a 16-byte chunk); TMA
// zero-fills what lies outside the image. Its rows of BW·sizeof(T) bytes are
// an odd number of 16-byte chunks (80 bytes of f32, 48 of bf16), so the 8
// lanes that read one chunk of 8 neighbouring d's hit distinct banks. Three
// roles, joined by per-slot mbarriers only (no barrier spans the block):
// - scan warps (R / 4): each keeps 4 neighbouring chains, reads them per d
//   from the one or two 4-element groups they fall in, runs scan_step on
//   each chain in the image and leaves acc + L in place of its inputs, then
//   a proxy fence, so that these generic stores come before the bulk copy
//   that later refills the slot ("full" -> "done");
// - write warps: copy each finished step's run from the slot to `out`, a
//   16-byte chunk a lane where the chunk lies wholly in the run and the
//   image, element by element at the run's two ends ("done" -> "free");
// - lane 0 of the last warp: keeps the ring full, step i + NS into the slot
//   of step i once it is free ("free" -> "full").
// The stores set the pace on an H100, and a diagonal band's far more than a
// vertical one's: its run shares a 32-byte sector with each neighbour's at
// both ends, and a sector written in halves costs memory twice unless the
// L2 merges the halves first. So the schedule keeps the bands in step with
// one wavefront down the rows, and a diagonal band writes a row only once
// its running neighbours have written all but kRingLead rows before it
// (each band's progress in a word of the launch's own `prog`, which the
// launcher sets to kRingIdle first). The wrapper takes the ring only where
// the schedule needs no more blocks than the card has SMs, so all of them
// run at once with every slot the shared memory holds.
template <typename T, int R_>
struct RingTile {
  static constexpr int R = R_;                        // chains of a band
  static constexpr int EPC = 16 / (int)sizeof(T);     // elements a 16-byte chunk
  static constexpr int BW = R + EPC;                  // box columns
  static constexpr int PB = BW * (int)sizeof(T);      // bytes of one d of a step
  static constexpr int NQ = BW / EPC;                 // 16-byte chunks of it
  static constexpr int CW = 4;                        // chains a scan warp keeps
  static constexpr int NCW = R / CW;                  // scan warps
  static constexpr int NW = 2;                        // write warps
  static constexpr int NT = 32 * (NCW + NW + 1);      // + the copy warp
  static_assert(R % EPC == 0 && NQ % 2 == 1, "odd chunks a row: conflict-free groups");
};
constexpr int kRingBand = 16;      // chains a band (the wrapper's RING_BAND; 32 timed slower)
constexpr int kRingMaxStages = 8;  // slots a block keeps at most
constexpr int kRingLead = 1;       // rows a diagonal band may run ahead of a neighbour
constexpr int kRingPacePolls = 2048;  // then it writes anyway (~0.3 ms)
constexpr int kRingIdle = 0x7f7f7f7f;  // a band's progress while it does not run (bytes 0x7f)

// The bytes of one slot region ([D][BW] of one tensor), a multiple of the
// 128 bytes a bulk copy's destination is aligned to.
__host__ __device__ constexpr uint32_t ring_region(int D, int pb) {
  return ((uint32_t)D * pb + 127u) & ~127u;
}

// The 4-element groups g and g + 1 of row d of a region, as f32.
__device__ __forceinline__ void load_groups(const float* row, int g, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * g);
  const float4 b = *reinterpret_cast<const float4*>(row + 4 * g + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(u & 0xffffu)));
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(u >> 16)));
}
__device__ __forceinline__ void load_groups(const __nv_bfloat16* row, int g, float (&v)[8]) {
  const uint2 a = *reinterpret_cast<const uint2*>(row + 4 * g);
  const uint2 b = *reinterpret_cast<const uint2*>(row + 4 * g + 4);
  v[0] = bf16_lo(a.x); v[1] = bf16_hi(a.x); v[2] = bf16_lo(a.y); v[3] = bf16_hi(a.y);
  v[4] = bf16_lo(b.x); v[5] = bf16_hi(b.x); v[6] = bf16_lo(b.y); v[7] = bf16_hi(b.y);
}
// v[sub .. sub + 3] into o (sub is warp-uniform; selects keep the code
// short, which times better than a branch per sub)
__device__ __forceinline__ void pick4(const float (&v)[8], int sub, float (&o)[4]) {
#pragma unroll
  for (int ci = 0; ci < 4; ++ci) {
    o[ci] = sub == 0 ? v[ci] : sub == 1 ? v[ci + 1] : sub == 2 ? v[ci + 2] : v[ci + 3];
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
// Wait for the phase of parity `parity` to complete. A barrier that never
// completes (a fault of the pipeline) traps after ~10^7 polls, so the launch
// fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t ok;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    if (polls == (1u << 24)) __trap();
  }
}
// The box at (x, y, 0) of the map into shared memory at dst; x must be a
// multiple of 16 bytes (negative: zero-filled columns)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(0), "r"(bar)
      : "memory");
}
// The steps of a block's bands, in order: band bands[bi] (its first
// intercept), step t of it.
struct RingSteps {
  const int* bands;
  int bi, last, t, nch;
  ScanGeo g;

  __device__ __forceinline__ RingSteps(const int* b, int first, int last_, int h, int w, int dy,
                                       int dx, int nch_)
      : bands(b), bi(first), last(last_), t(0), nch(nch_) {
    g.h = h; g.w = w; g.dy = dy; g.dx = dx;
    enter();
  }
  __device__ __forceinline__ void enter() {  // the band at bi, skipping empty ones
    for (; bi < last; ++bi) {
      g.band(g.h, g.w, g.dy, g.dx, bands[bi], nch);
      if (g.n > 0) return;
    }
  }
  __device__ __forceinline__ bool valid() const { return bi < last; }
  __device__ __forceinline__ void next() {
    if (++t < g.n) return;
    t = 0;
    ++bi;
    enter();
  }
  __device__ __forceinline__ int row() const { return g.row_of_step(t); }
  __device__ __forceinline__ int x() const { return g.c0 + g.sl * row(); }  // column of chain 0
};

// sched: [nblocks + 1] offsets, then the bands' first intercepts; block b
// runs bands [sched[b], sched[b + 1]). prog: each band's progress, by band
// index, kRingIdle where the band is not running. has_acc == 0: out = L.
template <typename T, int ND, class G>
__global__ void __launch_bounds__(G::NT) sgm_scan_ring_kernel(
    __grid_constant__ const CUtensorMap map_vol, __grid_constant__ const CUtensorMap map_acc,
    T* __restrict__ out, const int* sched, int* prog, int nblocks, int has_acc, int ns, int D,
    int h, int w, int dy, int dx, float p1, float p2) {
  extern __shared__ __align__(128) uint8_t ring_smem[];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(ring_smem);
  const uint32_t pad = ((s0 + 127u) & ~127u) - s0;
  uint8_t* ring = ring_smem + pad;
  const uint32_t ring_s = s0 + pad;
  const uint32_t region = ring_region(D, G::PB);
  const uint32_t slot = region * (has_acc ? 2u : 1u);
  const uint32_t out_off = has_acc ? region : 0u;  // the region the outputs replace
  // per slot: "full" (copy -> scan), "done" (scan -> write), "free" (write -> copy)
  const uint32_t full = ring_s + (uint32_t)ns * slot, done = full + 8u * ns, free_ = done + 8u * ns;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full + 8u * s, 1);
      mbar_init(done + 8u * s, G::NCW);
      mbar_init(free_ + 8u * s, G::NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int first = sched[blockIdx.x], last = sched[blockIdx.x + 1];
  const int* bands = sched + nblocks + 1;
  RingSteps it(bands, first, last, h, w, dy, dx, G::R);

  if (warp == G::NCW + G::NW) {  // the copy warp
    if (lane != 0) return;
    const uint32_t bytes = (uint32_t)D * G::PB * (has_acc ? 2u : 1u);
    for (int i = 0; it.valid(); ++i, it.next()) {
      const uint32_t s = (uint32_t)(i % ns), dst = ring_s + s * slot;
      if (i >= ns) mbar_wait(free_ + 8u * s, (uint32_t)(i / ns - 1) & 1u);
      const int xa = it.x() & -G::EPC;  // the 16-byte boundary at or left of the run
      mbar_expect_tx(full + 8u * s, bytes);
      tma_load(dst, &map_vol, xa, it.row(), full + 8u * s);
      if (has_acc) tma_load(dst + region, &map_acc, xa, it.row(), full + 8u * s);
    }
    return;
  }

  if (warp >= G::NCW) {  // a write warp: 16-byte chunks (d, q), q fastest
    const long plane = (long)h * w;
    // a diagonal band's run shares a 32-byte sector with each neighbour's at
    // both ends: write a row only once the started neighbours have written
    // all but the last kRingLead rows before it, so that the L2 merges the
    // sector's two halves before it goes to memory
    const bool pace = dx != 0;
    const int c_lo = dx * dy > 0 ? -(h - 1) : 0;  // the first band's intercept
    for (int i = 0; it.valid(); ++i, it.next()) {
      const uint32_t s = (uint32_t)(i % ns);
      mbar_wait(done + 8u * s, (uint32_t)(i / ns) & 1u);
      const int x = it.x(), xa = x & -G::EPC;
      const int b = (it.g.c0 - c_lo) / G::R, now = dy > 0 ? it.row() : h - 1 - it.row();
      if (pace && lane == 0) {
        for (int nb = b - 1; nb <= b + 1; nb += 2) {
          if (nb < 0 || nb >= sched[nblocks]) continue;
          const volatile int* pn = prog + nb;
          for (int polls = 0; *pn < now - kRingLead && polls < kRingPacePolls; ++polls) {
            __nanosleep(128);
          }
        }
      }
      __syncwarp();
      const int lo = max(x, 0), hi = min(x + G::R, w);  // the run's columns in the image
      const uint8_t* src = ring + s * slot + out_off;
      T* dst = out + (long)it.row() * w + xa;
#pragma unroll 2
      for (int k = (warp - G::NCW) * 32 + lane; k < D * G::NQ; k += G::NW * 32) {
        const int d = k / G::NQ, q = k - d * G::NQ;
        const int c0 = xa + q * G::EPC;  // the chunk's first column
        if (c0 + G::EPC <= lo || c0 >= hi) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(src + d * G::PB + 16 * q);
        T* p = dst + d * plane + q * G::EPC;
        if (c0 >= lo && c0 + G::EPC <= hi) {
          *reinterpret_cast<uint4*>(p) = v;
        } else {
          const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
          for (int j = 0; j < G::EPC; ++j) {
            if (c0 + j >= lo && c0 + j < hi) p[j] = e[j];
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(free_ + 8u * s);
      if (pace) {
        asm volatile("bar.sync 1, %0;\n" ::"n"(32 * G::NW) : "memory");  // the write warps
        if (warp == G::NCW && lane == 0) {
          *(volatile int*)(prog + b) = it.t + 1 == it.g.n ? kRingIdle : now + 1;
        }
      }
    }
    return;
  }

  // a scan warp: chains CW·warp .. CW·warp + CW - 1 of each band
  const int e0 = G::CW * warp;
  float prev[G::CW][ND], c[G::CW][ND], a[G::CW][ND], L[ND];
#pragma unroll
  for (int ci = 0; ci < G::CW; ++ci) {
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      c[ci][j] = 0.f;
      a[ci][j] = 0.f;
    }
  }
  for (int i = 0; it.valid(); ++i, it.next()) {
    if (it.t == 0) {  // a band starts from zeros where its chains enter
#pragma unroll
      for (int ci = 0; ci < G::CW; ++ci) {
#pragma unroll
        for (int j = 0; j < ND; ++j) prev[ci][j] = lane + 32 * j < D ? 0.f : kBig;
      }
    }
    const uint32_t s = (uint32_t)(i % ns);
    mbar_wait(full + 8u * s, (uint32_t)(i / ns) & 1u);
    const int x = it.x();
    const int xs = x + e0;  // column of this warp's first chain
    if (xs + G::CW > 0 && xs < w) {
      const int col = x - (x & -G::EPC) + e0;  // its column in the box
      const T* tv = reinterpret_cast<const T*>(ring + s * slot);
      const T* ta = reinterpret_cast<const T*>(ring + s * slot + region);
      const int g = col >> 2, sub = col & 3;  // its 4-element group, its place there
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int d = lane + 32 * j;
        if (d < D) {
          float v[8], o[4];
          load_groups(tv + d * G::BW, g, v);
          pick4(v, sub, o);
#pragma unroll
          for (int ci = 0; ci < G::CW; ++ci) c[ci][j] = o[ci];
          if (has_acc) {
            load_groups(ta + d * G::BW, g, v);
            pick4(v, sub, o);
#pragma unroll
            for (int ci = 0; ci < G::CW; ++ci) a[ci][j] = o[ci];
          }
        }
      }
      T* to = reinterpret_cast<T*>(ring + s * slot + out_off);
#pragma unroll
      for (int ci = 0; ci < G::CW; ++ci) {
        if (xs + ci < 0 || xs + ci >= w) continue;  // this chain is outside the image here
        scan_step<ND>(prev[ci], c[ci], L, lane, p1, p2);
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const int d = lane + 32 * j;
          prev[ci][j] = d < D ? L[j] : kBig;
          if (d < D) to[d * G::BW + col + ci] = from_f32<T>(has_acc ? a[ci][j] + L[j] : L[j]);
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // stores before the next copy
    __syncwarp();
    if (lane == 0) mbar_arrive(done + 8u * s);
  }
}

// TMA's tensor-map encoder (cuTensorMapEncodeTiled), looked up through the
// runtime's entry-point query, so the library links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The map of a [D, h, w] volume at p whose box is [BW x 1 x D].
template <typename T, class G>
int ring_map(CUtensorMap* map, const void* p, int D, int h, int w) {
  const EncodeTiled enc = tensor_map_encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)D};
  const cuuint64_t strides[2] = {(cuuint64_t)w * sizeof(T), (cuuint64_t)h * w * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)G::BW, 1u, (cuuint32_t)D};
  const cuuint32_t one[3] = {1u, 1u, 1u};
  const CUresult r = enc(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         3, const_cast<void*>(p), dims, strides, box, one,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Bytes of a block's shared memory past its slots: the alignment and the
// barriers.
constexpr size_t kRingExtra = 128 + 3 * 8 * kRingMaxStages;

// As many slots as one block's shared memory holds (a block an SM): at
// least 2 at any D <= 256.
constexpr int ring_stages(uint32_t slot) {
  return (int)std::min<size_t>(kRingMaxStages, (kMaxSmem - kRingExtra) / slot);
}
static_assert(ring_stages(2 * ring_region(256, RingTile<float, kRingBand>::PB)) >= 2,
              "two slots of vol and acc at D = 256");

template <typename T, int ND>
struct RingLaunch {
  static int run(const void* vol, const void* acc, void* out, const int* sched, int* prog,
                 int nblocks, int D, int h, int w, int dy, int dx, float p1, float p2,
                 void* stream) {
    if constexpr (ND <= 4) {
      return (int)cudaErrorInvalidValue;  // D <= 128 keeps the staged kernel
    } else {
      using G = RingTile<T, kRingBand>;
      CUtensorMap mv, ma;
      int e = ring_map<T, G>(&mv, vol, D, h, w);
      if (!e) e = ring_map<T, G>(&ma, acc ? acc : vol, D, h, w);
      if (e) return e;
      const uint32_t slot = ring_region(D, G::PB) * (acc ? 2u : 1u);
      const int ns = ring_stages(slot);
      const size_t smem = kRingExtra + (size_t)ns * slot;
      if (dx != 0) {  // only the diagonals pace their bands
        const int nbands = (w + h - 1 + G::R - 1) / G::R;
        e = (int)cudaMemsetAsync(prog, 0x7f, sizeof(int) * (size_t)nbands, (cudaStream_t)stream);
        if (e) return e;
      }
      auto kern = sgm_scan_ring_kernel<T, ND, G>;
      STEPTH_LAUNCH(kern, nblocks, G::NT, smem, stream, mv, ma, (T*)out, sched, prog, nblocks,
                    acc ? 1 : 0, ns, D, h, w, dy, dx, p1, p2);
    }
  }
};

// ---- K8: the final up-scan with the WTA fused in -------------------------

// K7's vertical staging (dy = -1, dx = 0: a band of R neighbouring columns,
// P rows a stage, a ring of cp.async slots) with the WTA in place of the
// write-back. After the slots, the stage's agg [P][R][D + 1] (f32; the odd
// stride puts the R columns of one (row, d) in distinct banks).
__host__ __device__ constexpr int wta_stride(int D) { return D + 1; }

template <typename T, int ND, class G>
__global__ void __launch_bounds__(G::NT) sgm_scan_wta_kernel(
    const T* __restrict__ vol, const T* __restrict__ acc, float* __restrict__ disp,
    float* __restrict__ cbest, float* __restrict__ uok,
    unsigned long long* __restrict__ right, int D, int h, int w, float p1, float p2,
    int use_uniq, float uniq1p) {
  static_assert(G::P * G::R < G::NT, "threads left for the right view");
  extern __shared__ uint32_t scan_smem[];
  const int k = threadIdx.x / 32;  // this warp's column in the band
  const int lane = threadIdx.x & 31;
  ScanGeo g;
  g.init(h, w, -1, 0, G::NCH);
  const long plane = (long)h * w;
  const int slot_words = 2 * D * G::DSTR;  // vol region, then acc region
  const uint32_t smem_s = (uint32_t)__cvta_generic_to_shared(scan_smem);
  const int DS = wta_stride(D);
  float* stash = reinterpret_cast<float*>(scan_smem + G::NST * slot_words);
  const int x = g.c0 + k;
  float prev[ND], c[ND], a[ND], L[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    prev[j] = lane + 32 * j < D ? 0.f : kBig;
    c[j] = 0.f;
    a[j] = 0.f;
  }
  const int nst = (g.n + G::S - 1) / G::S;
  auto copy = [&](int st) {
    const uint32_t base = smem_s + 4u * (st % G::NST) * slot_words;
    scan_copy<G, false>(vol, base, g, st, D, plane);
    scan_copy<G, false>(acc, base + 4u * D * G::DSTR, g, st, D, plane);
  };
#pragma unroll
  for (int st = 0; st < G::NST - 1; ++st) {
    if (st < nst) copy(st);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<G::NST - 2>();
    __syncthreads();  // stage st has landed; stage st - 1's agg has been read
    if (st + G::NST - 1 < nst) copy(st + G::NST - 1);
    cp_async_commit();
    const uint32_t* slot = scan_smem + (st % G::NST) * slot_words;
    const T* tv = reinterpret_cast<const T*>(slot);
    const T* ta = reinterpret_cast<const T*>(slot + D * G::DSTR);
    for (int s = 0; s < G::S; ++s) {
      const int t = st * G::S + s;
      if (t >= g.n) break;
      if (x >= w) continue;  // this chain is outside the image
      const long roff = (long)g.row_of_step(t) * w + g.c0;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int d = lane + 32 * j;
        if (d < D) {
          const long off = d * plane + roff;
          const int wi = (d * G::DSTR + s * G::RUNW) * G::EPW + k;
          c[j] = to_f32(tv[wi + par(vol, off)]);
          a[j] = to_f32(ta[wi + par(acc, off)]);
        }
      }
      scan_step<ND>(prev, c, L, lane, p1, p2);
      // agg = acc + L in f32, never rounded to the volume type
      float* sk = stash + (s * G::R + k) * DS;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int d = lane + 32 * j;
        prev[j] = d < D ? L[j] : kBig;
        if (d < D) sk[d] = a[j] + L[j];
      }
    }
    __syncthreads();  // the stage's agg is in place
    if (threadIdx.x < G::P * G::R) {
      // the WTA of one (row, column) of the stage: WtaState, as K9's, over
      // its D costs in ascending d
      const int s = threadIdx.x / G::R, kk = threadIdx.x % G::R;
      const int t = st * G::S + s, xx = g.c0 + kk;
      if (t < g.n && xx < w) {
        const float* sk = stash + (s * G::R + kk) * DS;
        WtaState wst;
        wst.init();
        for (int d = 0; d < D; ++d) wst.update(sk[d], d, use_uniq);
        const size_t at = (size_t)g.row_of_step(t) * w + xx;
        disp[at] = wst.disp(D);
        cbest[at] = wst.cb;
        uok[at] = wst.valid(use_uniq, uniq1p);
      }
    } else {
      // right view: for each (row, u) the band reaches, the first minimum of
      // agg(x, x - u) over its columns x (ascending, so d ascends), by the
      // packed key (f32 bits << 32) | d; then one global atomicMin
      const int RB = G::R + D - 1;  // u in [c0 - D + 1, c0 + R)
      for (int i = threadIdx.x - G::P * G::R; i < G::P * RB; i += G::NT - G::P * G::R) {
        const int s = i / RB, u = g.c0 - D + 1 + (i - s * RB);
        if (st * G::S + s >= g.n || u < 0) continue;
        const int k_lo = max(0, u - g.c0), k_hi = min(min(G::R, w - g.c0), u - g.c0 + D);
        unsigned long long best = ~0ull;
        for (int kk = k_lo; kk < k_hi; ++kk) {
          const int d = g.c0 + kk - u;
          const unsigned long long key =
              ((unsigned long long)__float_as_uint(stash[(s * G::R + kk) * DS + d]) << 32) |
              (unsigned)d;
          best = key < best ? key : best;
        }
        if (best == ~0ull) continue;
        unsigned long long* gp = right + (size_t)g.row_of_step(st * G::S + s) * w + u;
        if (best < *gp) atomicMin(gp, best);
      }
    }
  }
}

// ---- K9: WTA from a volume -----------------------------------------------

constexpr int WNT = 256;  // threads (pixels of one row) per block

template <typename T>
__global__ void __launch_bounds__(WNT) sgm_wta_kernel(
    const T* __restrict__ vol, float* __restrict__ disp, float* __restrict__ dispr,
    float* __restrict__ cbest, float* __restrict__ uok, int D, int h, int w,
    int use_uniq, float uniq1p) {
  const int x = blockIdx.x * WNT + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const size_t plane = (size_t)h * w;
  const size_t o = (size_t)y * w + x;
  WtaState st;
  st.init();
  float bestr = kBig;
  int bestrd = 0;
  for (int d = 0; d < D; ++d) {
    st.update(to_f32(vol[d * plane + o]), d, use_uniq);
    // right view: costR(x, d) = cost(x + d, d), BIG past the right edge
    const float ar = x + d <= w - 1 ? to_f32(vol[d * plane + o + d]) : kBig;
    if (ar < bestr) { bestr = ar; bestrd = d; }
  }
  disp[o] = st.disp(D);
  dispr[o] = (float)bestrd;
  cbest[o] = st.cb;
  uok[o] = st.valid(use_uniq, uniq1p);
}

// ND = ceil(D / 32) is a template argument (registers, unrolled shuffles)
template <template <typename, int> class F, typename T, typename... Args>
int dispatch_nd(int D, Args... args) {
  switch ((D + 31) / 32) {
    case 1: return F<T, 1>::run(args...);
    case 2: return F<T, 2>::run(args...);
    case 3: return F<T, 3>::run(args...);
    case 4: return F<T, 4>::run(args...);
    case 5: return F<T, 5>::run(args...);
    case 6: return F<T, 6>::run(args...);
    case 7: return F<T, 7>::run(args...);
    case 8: return F<T, 8>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

// shared memory of a staged scan's ring at D disparities
template <class G>
constexpr size_t staged_smem(int D) {
  return sizeof(uint32_t) * G::NST * 2 * (size_t)D * G::DSTR;
}

// carry_out == NULL: K7; otherwise K10 (carry_in == NULL seeds zeros)
template <typename T, int ND, bool HORIZ, bool CARRY, class G = typename ScanPick<T, ND, HORIZ>::type>
int launch_scan(const void* vol, const void* acc, void* out, const float* carry_in,
                float* carry_out, int D, int h, int w, int dy, int dx, float p1, float p2,
                void* stream) {
  const int nchains = HORIZ ? h : dx == 0 ? w : w + h - 1;
  const int blocks = (nchains + G::NCH - 1) / G::NCH;
  const size_t smem = staged_smem<G>(D);
  auto kern = sgm_scan_kernel<T, ND, HORIZ, CARRY, G>;
  STEPTH_LAUNCH(kern, blocks, G::NT, smem, stream, (const T*)vol, (const T*)acc, (T*)out,
                carry_in, carry_out, D, h, w, dy, dx, p1, p2);
}

template <typename T, int ND>
struct ScanLaunch {
  static int run(const void* vol, const void* acc, void* out, const float* carry_in,
                 float* carry_out, int D, int h, int w, int dy, int dx, float p1, float p2,
                 void* stream) {
    if (carry_out) {
      return launch_scan<T, ND, false, true>(vol, acc, out, carry_in, carry_out, D, h, w,
                                             dy, dx, p1, p2, stream);
    }
    if (dy == 0) {
      return launch_scan<T, ND, true, false>(vol, acc, out, nullptr, nullptr, D, h, w, dy,
                                             dx, p1, p2, stream);
    }
    return launch_scan<T, ND, false, false>(vol, acc, out, nullptr, nullptr, D, h, w, dy, dx,
                                            p1, p2, stream);
  }
};

// ---- K7 at D > 256: the staged kernel on its deep tiling --------------------
//
// Past 256 disparities a lane keeps ND = 10, 12 or 16 path costs (D rounded
// up to 320, 384 or 512; lanes past D hold BIG, as below). The scans along
// rows keep their tile (a chain a block, 16-step runs, two slots: 139 KB at
// D = 512). The scans over rows cannot: three slots of two steps of 16
// chains take 3·2·D·33 words, over 227 KB from D = 294. Their deep tile
// keeps the band of 16 chains and three slots of one step each (209 KB at
// D = 512). Timed on an H100 at 1988x2880, D=290, f32, in place (ms a
// launch): these tiles 22.3 (→x), 20.1-23.9 (diagonals) and 13.5-14.6
// (↓y ↑y); against them, with acc read back from the slot, runs of 8
// steps along rows 27.0 and of 4 62.8 (16: 21.8), two slots over rows
// 23.2-23.9 and 13.0, bands of 8 chains 34.0 and 20.4. K10 stays at
// D <= 256 (its wrapper refuses more).
constexpr int kDeepMaxD = 512;

template <typename T, int ND, bool HORIZ>
using DeepTile = typename std::conditional<HORIZ, typename ScanPick<T, ND, true>::type,
                                           ScanTile<T, 16, 1, 3, false>>::type;
static_assert(staged_smem<DeepTile<float, 16, false>>(kDeepMaxD) <= kMaxSmem &&
                  staged_smem<DeepTile<float, 16, true>>(kDeepMaxD) <= kMaxSmem,
              "the deep tiles fit at D = 512");

template <typename T, int ND>
struct DeepLaunch {
  static int run(const void* vol, const void* acc, void* out, int D, int h, int w, int dy,
                 int dx, float p1, float p2, void* stream) {
    if (dy == 0) {
      return launch_scan<T, ND, true, false, DeepTile<T, ND, true>>(
          vol, acc, out, nullptr, nullptr, D, h, w, dy, dx, p1, p2, stream);
    }
    return launch_scan<T, ND, false, false, DeepTile<T, ND, false>>(
        vol, acc, out, nullptr, nullptr, D, h, w, dy, dx, p1, p2, stream);
  }
};

template <typename T>
int launch_deep(const void* vol, const void* acc, void* out, int D, int h, int w, int dy,
                int dx, float p1, float p2, void* stream) {
  if (D <= 320) return DeepLaunch<T, 10>::run(vol, acc, out, D, h, w, dy, dx, p1, p2, stream);
  if (D <= 384) return DeepLaunch<T, 12>::run(vol, acc, out, D, h, w, dy, dx, p1, p2, stream);
  return DeepLaunch<T, 16>::run(vol, acc, out, D, h, w, dy, dx, p1, p2, stream);
}

// K8's tiling: K7's vertical one, with a 2-slot ring where 3 slots and the
// stage's agg would not fit the 227 KB a block may use (f32 at D in 97-128
// and 225-256).
template <typename T, int ND, int NST>
using WtaTileN = ScanTile<T, ScanPick<T, ND, false>::type::R, ScanPick<T, ND, false>::type::P,
                          NST, false>;

template <class G>
constexpr size_t scan_wta_smem(int D) {
  return sizeof(uint32_t) * G::NST * 2 * (size_t)D * G::DSTR +
         sizeof(float) * (size_t)G::P * G::R * wta_stride(D);
}

template <typename T, int ND>
using WtaTile = typename std::conditional<(scan_wta_smem<WtaTileN<T, ND, 3>>(32 * ND) <=
                                           232448),
                                          WtaTileN<T, ND, 3>, WtaTileN<T, ND, 2>>::type;

template <typename T, int ND>
struct ScanWtaLaunch {
  static int run(const void* vol, const void* acc, float* disp, float* cbest, float* uok,
                 unsigned long long* right, int D, int h, int w, float p1, float p2,
                 int use_uniq, float uniq1p, void* stream) {
    using G = WtaTile<T, ND>;
    auto kern = sgm_scan_wta_kernel<T, ND, G>;
    STEPTH_LAUNCH(kern, (w + G::NCH - 1) / G::NCH, G::NT, scan_wta_smem<G>(D), stream,
                  (const T*)vol, (const T*)acc, disp, cbest, uok, right, D, h, w, p1, p2,
                  use_uniq, uniq1p);
  }
};

}  // namespace

// bf16 != 0 selects __nv_bfloat16 volumes, else f32.

// The volume's bytes are written with 16-byte vectors where `vol` is
// 16-byte aligned and w a multiple of the vector (4 f32, 8 bf16).
extern "C" int stepth_sgm_volume(const float* lg, const float* rg, const int* lc,
                                 const int* rc, int nplanes, void* vol, int bf16, int h,
                                 int w, int D, int win, int squared, int g_row0, int g_h,
                                 void* stream) {
  if (D < 1 || win < 1 || nplanes < 0 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const int gx = (w + VolTile::BX - 1) / VolTile::BX, gy = (h + VolTile::BH - 1) / VolTile::BH;
  const int nchunk = (D + VolTile::DC - 1) / VolTile::DC;
  const int nz = min(nchunk, max(1, (kVolFillBlocks + gx * gy - 1) / (gx * gy)));
  const int dz = (nchunk + nz - 1) / nz * VolTile::DC;
  const dim3 grid(gx, gy, (D + dz - 1) / dz);
  const bool aligned = ((uintptr_t)vol & 15) == 0 && w % (bf16 ? 8 : 4) == 0;
  const VolArgs a{lg, rg, lc, rc, nplanes, vol, h, w, D, dz, squared, g_row0, g_h, win / 2,
                  (int)aligned};
  if (bf16) return launch_volume_window<__nv_bfloat16>(a, win, grid, stream);
  return launch_volume_window<float>(a, win, grid, stream);
}

// acc == NULL: the first direction (out = L); otherwise out = acc + L, and
// out may be acc itself (in place). sched == NULL: the staged kernel (on its
// deep tiling for 256 < D <= 512); otherwise the ring over the wrapper's
// schedule for `nblocks` blocks of bands of kRingBand chains, with `prog`
// one int a band of scratch (dy = +-1, 128 < D <= 256, w·sizeof(T) and
// every pointer a multiple of 16 bytes).
extern "C" int stepth_sgm_scan(const void* vol, const void* acc, void* out, int bf16, int D,
                               int h, int w, int dy, int dx, float p1, float p2,
                               const int* sched, int nblocks, int* prog, void* stream) {
  if (D > 256) {
    if (D > kDeepMaxD || sched) return (int)cudaErrorInvalidValue;
    if (bf16) return launch_deep<__nv_bfloat16>(vol, acc, out, D, h, w, dy, dx, p1, p2, stream);
    return launch_deep<float>(vol, acc, out, D, h, w, dy, dx, p1, p2, stream);
  }
  if (sched) {
    const int elem = bf16 ? 2 : 4;
    const bool aligned = ((uintptr_t)vol | (uintptr_t)acc | (uintptr_t)out) % 16 == 0;
    if (dy == 0 || D <= 128 || D > 256 || (w * elem) % 16 || !aligned || nblocks < 1 ||
        !prog) {
      return (int)cudaErrorInvalidValue;
    }
    if (bf16) {
      return dispatch_nd<RingLaunch, __nv_bfloat16>(D, vol, acc, out, sched, prog, nblocks, D,
                                                     h, w, dy, dx, p1, p2, stream);
    }
    return dispatch_nd<RingLaunch, float>(D, vol, acc, out, sched, prog, nblocks, D, h, w, dy,
                                          dx, p1, p2, stream);
  }
  if (bf16) {
    return dispatch_nd<ScanLaunch, __nv_bfloat16>(D, vol, acc, out, (const float*)nullptr,
                                                   (float*)nullptr, D, h, w, dy, dx, p1, p2,
                                                   stream);
  }
  return dispatch_nd<ScanLaunch, float>(D, vol, acc, out, (const float*)nullptr,
                                        (float*)nullptr, D, h, w, dy, dx, p1, p2, stream);
}

// K10: a vertical or diagonal scan (dy = +-1) of one row shard, seeded from
// carry_in (f32 [D, w]; NULL: zeros) and writing its final carry to
// carry_out (f32 [D, w], not NULL). acc and out as in stepth_sgm_scan.
extern "C" int stepth_sgm_scan_carry(const void* vol, const void* acc, void* out,
                                     const float* carry_in, float* carry_out, int bf16,
                                     int D, int h, int w, int dy, int dx, float p1, float p2,
                                     void* stream) {
  if (dy == 0 || !carry_out) return (int)cudaErrorInvalidValue;
  if (bf16) {
    return dispatch_nd<ScanLaunch, __nv_bfloat16>(D, vol, acc, out, carry_in, carry_out, D,
                                                   h, w, dy, dx, p1, p2, stream);
  }
  return dispatch_nd<ScanLaunch, float>(D, vol, acc, out, carry_in, carry_out, D, h, w, dy,
                                        dx, p1, p2, stream);
}

// `right` must hold all ones (u64 max) on entry.
extern "C" int stepth_sgm_scan_wta(const void* vol, const void* acc, int bf16, float* disp,
                                   float* cbest, float* uok, unsigned long long* right,
                                   int D, int h, int w, float p1, float p2, int use_uniq,
                                   float uniq1p, void* stream) {
  if (bf16) {
    return dispatch_nd<ScanWtaLaunch, __nv_bfloat16>(D, vol, acc, disp, cbest, uok, right,
                                                      D, h, w, p1, p2, use_uniq, uniq1p,
                                                      stream);
  }
  return dispatch_nd<ScanWtaLaunch, float>(D, vol, acc, disp, cbest, uok, right, D, h, w,
                                           p1, p2, use_uniq, uniq1p, stream);
}

extern "C" int stepth_sgm_wta(const void* vol, int bf16, float* disp, float* dispr,
                              float* cbest, float* uok, int D, int h, int w, int use_uniq,
                              float uniq1p, void* stream) {
  const dim3 grid((w + WNT - 1) / WNT, h);
  if (bf16) {
    auto kern = sgm_wta_kernel<__nv_bfloat16>;
    STEPTH_LAUNCH(kern, grid, WNT, 0, stream, (const __nv_bfloat16*)vol, disp, dispr, cbest,
                  uok, D, h, w, use_uniq, uniq1p);
  }
  auto kern = sgm_wta_kernel<float>;
  STEPTH_LAUNCH(kern, grid, WNT, 0, stream, (const float*)vol, disp, dispr, cbest, uok, D, h,
                w, use_uniq, uniq1p);
}
