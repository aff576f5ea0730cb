// K1 — fused exhaustive stereo matcher.
//
// Replaces: stepth_tpu/match/pallas_dense.py, `_kernel` (called through
// `raw_match`). Same output contract: per pixel, over all d < D, the SAD/SSD
// cost against the right image sampled at x-d (edge-replicated for x-d < 0)
// or, with nplanes > 0, the census Hamming distance sum_p popc(l ^ r) of
// int32 descriptor planes [P, H, W] (column 0's descriptor for x-d < 0),
// zero outside the image and on rows outside [0, g_h) of a halo-extended
// shard, a zero-padded win x win box sum in the reference's association
// (common.cuh), a first-minimum WTA (strict <, ascending d) with parabolic
// subpixel for best in [1, D-2], the optional uniqueness test against the
// best cost outside +-1, and the right-view WTA costR(x, d) = costL(x+d, d)
// (BIG where x+d > W-1, first minimum). The reference's in-kernel LR sweep
// reads the right-view disparity of every column of the row, which a block
// does not hold: the wrapper runs K4 after this kernel. Hamming costs are
// integers <= 32 P, so their box sums are exact in f32.
//
// What bounds it on an H100: instructions and their latency. The [H, W, D]
// cost volume never leaves the SM and the inputs are a few MB, so the
// bytes are negligible; each (pixel, d) needs a cost, 8 adds of window-9
// box sums and a WTA update, ~20-30 instructions. The design spends as few
// more as it can:
//
// - A block owns a BH x BX output tile and walks d in chunks of DC, with
//   three barriers a chunk. No division by a runtime value anywhere.
// - The left image (or its census planes) of the tile and its box halo is
//   loaded once into shared memory, the right image's slab for SD
//   disparities once per SD, both clamped to the image (the costs mask).
// - Vertical pass: one thread per (two disparities of the chunk, column of
//   the tile plus its 2r halo) walks the BH + 2r cost rows from shared
//   memory, costing each cell once (one left load for both), and forms the
//   vertical box sums in registers (window 9: the 3-sums y(k) once per
//   cell, then z = (y(k) + y(k-3)) + y(k+3)); it stores the BH sums
//   V[d][row][col] in shared memory.
// - Horizontal pass: one thread per Q neighbouring output pixels of a row
//   reads the Q + 2r sums it needs (float4, a swizzled layout so that a
//   quarter-warp's loads hit distinct banks), forms the horizontal sums the
//   same way and updates its pixels' WtaState (common.cuh) in registers.
// - Right view: no columns beyond the tile are costed. Pixel x at d offers
//   costL(x, d) to u = x - d. A thread keeps the first minimum of each u its
//   pixels reach in a chunk in registers, takes its right neighbour's minima
//   of the u's they share by a shuffle, and writes those of its own u's into
//   a shared ring of per-row u64 minima (f32 bits << 32) | d, one writer a
//   slot and chunk. The u's that no later chunk reaches leave the ring
//   after each chunk by one global atomicMin per (row, u) into a buffer that
//   the wrapper fills with (bits(BIG) << 32) | 0 and decodes (low word).
//   Costs are >= +0, so the bits order as the values and the smaller d wins
//   a tie: the reference's first minimum, in any order of blocks. A
//   candidate >= BIG never beats the start value, as in the reference's
//   running minimum from BIG.
//
// Windows 1..17: the box sums are unrolled at compile time (window 9 as
// above, the others left to right), so the kernel is a template on the
// radius (and, for window 9, on the uniqueness test); larger windows, and
// census descriptors of more than 4 planes, are refused
// (cudaErrorInvalidValue).

#include <cstdint>

#include "common.cuh"

using namespace stepth;

namespace {

constexpr int kMaxRadius = 8;  // windows up to 17
constexpr int kMaxPlanes = 4;  // census descriptors up to 128 bits (windows up to 11)

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// A block's tiling: BH x BX output pixels, NT threads, DC disparities a
// chunk, SD a right-image slab, DW disparities a vertical walk: 8 x 120
// tiles of four warps, four blocks a SM at 128 registers a thread (2,160
// blocks at 1080x1920, 34 at the 135x240 coarse level), chosen by timing
// variants on an H100: 16-row tiles (two blocks a SM), three blocks a SM
// without spills and walks of one or four disparities were slower at
// 1080p, narrower or shorter tiles no faster at 135x240. In the
// horizontal pass an output row is a lane segment of TPRP threads (a power
// of two), of which the first TPR take Q neighbouring pixels each. The
// right-view ring holds RW slots a row (a power of two >= BX + DC - 1, so
// that u & (RW - 1) is u's slot), stored RWS u64 apart with one spare u64
// after every 8 slots: threads 8 slots apart then hit distinct banks.
struct Tile {
  static constexpr int BH = 8, BX = 120, Q = 8, DC = 4, SD = 32, NT = 128;
  static constexpr int DW = 2;  // disparities a vertical walk
  static constexpr int TPR = BX / Q;
  static constexpr int TPRP = pow2_at_least(TPR);
  static constexpr int RW = pow2_at_least(BX + DC);
  static constexpr int RWS = RW + RW / 8 + 1;
  static constexpr int NU = Q + DC - 1;  // u's a thread's pixels reach in a chunk
  static constexpr int DB = 2;           // bits of a chunk's dd
  static_assert(BX % Q == 0 && Q % 4 == 0 && BH * TPRP == NT && TPRP <= 32 &&
                SD % DC == 0 && DC % DW == 0 && DC <= 1 << DB && NU * DB <= 32, "tile");
};

__device__ __forceinline__ int ring_at(int slot) { return slot + (slot >> 3); }

// The shared layout of a block, in 4-byte words: the vertical sums V
// [DC][BH][RS] (each row padded to a float4 multiple, every 32 floats
// followed by 4 spare ones, so that the 8 threads of a quarter-warp,
// reading float4s 32 bytes apart, hit distinct banks); the right-view ring
// [BH][RWS] u64; the left image (or its census planes) [P][NR][TW] and the
// right-image slab of SD disparities [P][NR][SW], both as loaded (clamped
// to the image; the cost masks them).
template <int R_>
struct DenseLayout {
  static constexpr int R = R_, BH = Tile::BH;
  static constexpr int NR = Tile::BH + 2 * R;               // cost rows
  static constexpr int TW = Tile::BX + 2 * R;               // columns of costs and sums
  static constexpr int SW = TW + Tile::SD - 1;              // right-slab columns
  static constexpr int RS = swz_width(TW);                  // physical row stride of V
  static constexpr int NV = (Tile::Q + 2 * R + 3) / 4 * 4;  // sums a thread reads
  static constexpr int V_WORDS = Tile::DC * Tile::BH * RS;
  static constexpr int RING_WORDS = 2 * Tile::BH * Tile::RWS;
  static_assert(NR <= 32, "a row mask of the cost rows");
  static __host__ __device__ constexpr size_t bytes(int planes) {
    return 4 * ((size_t)V_WORDS + RING_WORDS + (size_t)planes * NR * (TW + SW));
  }
};

struct DenseArgs {
  const float* lg;
  const float* rg;
  const int* lc;
  const int* rc;
  int nplanes;
  float* disp;
  unsigned long long* right;
  float* cbest;
  float* valid;
  int h, w, D, squared, use_uniq;
  float uniq1p;
  int g_row0, g_h;
};

// Horizontal pass and WTA of a chunk (disparities d0 + [0, dc)) for a
// thread's Q pixels of output row j, columns xg + [0, Q) (g: its place in
// the row's lane segment; g >= TPR holds no pixel but joins the shuffles);
// then the chunk's right-view candidates. Pixel i at d offers costL to u =
// xg + i - d: the thread keeps one first minimum per u it reaches (NU of
// them, their dd packed DB bits each in one register), takes the right
// neighbour's minima of the DC - 1 u's they share (the neighbour's
// candidates there have larger d, so they win only when strictly smaller),
// and writes the minima of its own u's, [xg - d0, xg - d0 + Q) (thread 0:
// from xg - d0 - DC + 1), into the ring, which no other thread of the chunk
// touches there.
template <int R, bool NINE, bool UNIQ>
__device__ __forceinline__ void horizontal_wta(const float* vs, unsigned long long* ring,
                                               WtaState (&st)[Tile::Q], int j, int g, int xg,
                                               int nvalid, int d0, int dc) {
  using L = DenseLayout<R>;
  constexpr int NU = Tile::NU, DB = Tile::DB;
  const float big = kBig;
  const int gl = min(g, Tile::TPR - 1);  // the V columns an idle lane reads
  float pv[NU];
  uint32_t pdd = 0;
#pragma unroll
  for (int m = 0; m < NU; ++m) pv[m] = big;
#pragma unroll
  for (int dd = 0; dd < Tile::DC; ++dd) {
    if (dd < dc) {
      const int d = d0 + dd;
      const float* row = vs + (dd * Tile::BH + j) * L::RS;
      float v[L::NV];
#pragma unroll
      for (int m = 0; m < L::NV / 4; ++m) {
        const int f = gl * (Tile::Q / 4) + m;  // logical float4 of the row
        const float4 q = *reinterpret_cast<const float4*>(row + 4 * (f + (f >> 3)));
        v[4 * m] = q.x; v[4 * m + 1] = q.y; v[4 * m + 2] = q.z; v[4 * m + 3] = q.w;
      }
      float z[Tile::Q];
      box_run<R, NINE, 0>(v, z);
#pragma unroll
      for (int i = 0; i < Tile::Q; ++i) {
        st[i].update(z[i], d, UNIQ);
        // pixels outside the image offer BIG, which is never kept
        const float zr = i < nvalid ? z[i] : big;
        const int m = i - dd + Tile::DC - 1;
        if (zr < pv[m]) {  // ascending d: the first minimum
          pv[m] = zr;
          pdd = (pdd & ~(((1u << DB) - 1) << (DB * m))) | ((uint32_t)dd << (DB * m));
        }
      }
    }
  }
  // the right neighbour's first DC - 1 minima are this thread's last ones
  const uint32_t npdd = __shfl_down_sync(0xffffffffu, pdd, 1, Tile::TPRP);
#pragma unroll
  for (int m = 0; m < Tile::DC - 1; ++m) {
    const float nv = __shfl_down_sync(0xffffffffu, pv[m], 1, Tile::TPRP);
    const int mm = m + Tile::Q;
    if (g + 1 < Tile::TPR && nv < pv[mm]) {
      pv[mm] = nv;
      pdd = (pdd & ~(((1u << DB) - 1) << (DB * mm))) |
            (((npdd >> (DB * m)) & ((1u << DB) - 1)) << (DB * mm));
    }
  }
#pragma unroll
  for (int m = 0; m < NU; ++m) {
    if ((m >= Tile::DC - 1 || g == 0) && pv[m] < big) {
      const int slot = (xg - d0 + m - (Tile::DC - 1)) & (Tile::RW - 1);
      unsigned long long* p = ring + j * Tile::RWS + ring_at(slot);
      const unsigned d = d0 + ((pdd >> (DB * m)) & ((1u << DB) - 1));
      const unsigned long long key = ((unsigned long long)__float_as_uint(pv[m]) << 32) | d;
      if (key < *p) *p = key;
    }
  }
}

template <int R, bool NINE, int UQ>  // UQ: 0 off, 1 on, 2 a.use_uniq
__global__ void __launch_bounds__(Tile::NT, 4) fused_dense_kernel(DenseArgs a) {
  using L = DenseLayout<R>;
  extern __shared__ float4 smem4[];
  float* vs = reinterpret_cast<float*>(smem4);
  unsigned long long* ring = reinterpret_cast<unsigned long long*>(vs + L::V_WORDS);
  uint32_t* lt = reinterpret_cast<uint32_t*>(vs + L::V_WORDS + L::RING_WORDS);
  const int planes = a.nplanes ? a.nplanes : 1;
  uint32_t* rt = lt + planes * L::NR * L::TW;

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * Tile::BX;
  const int y0 = blockIdx.y * Tile::BH;
  // the cost rows that cost anything: inside [0, h) and the global [0, g_h)
  const int ylo = max(0, -a.g_row0), yhi = min(a.h, a.g_h - a.g_row0);
  uint32_t rowmask = 0;
#pragma unroll
  for (int k = 0; k < L::NR; ++k) {
    if (y0 - R + k >= ylo && y0 - R + k < yhi) rowmask |= 1u << k;
  }
  const unsigned long long init = (unsigned long long)__float_as_uint(kBig) << 32;
  for (int e = tid; e < Tile::BH * Tile::RWS; e += Tile::NT) ring[e] = init;
  load_tile<Tile::NT>(lt, a.lg, a.lc, a.nplanes, a.h, a.w, y0 - R, x0 - R, L::NR, L::TW);

  const int j = tid / Tile::TPRP, g = tid % Tile::TPRP;  // horizontal pass: row, lane
  const int xg = x0 + g * Tile::Q;
  const int nvalid = g < Tile::TPR && y0 + j < a.h ? min(Tile::Q, a.w - xg) : 0;
  const bool uniq = UQ == 1 || (UQ == 2 && a.use_uniq);
  WtaState st[Tile::Q];
#pragma unroll
  for (int i = 0; i < Tile::Q; ++i) st[i].init();

  for (int d0 = 0; d0 < a.D; d0 += Tile::DC) {
    const int dc = min(Tile::DC, a.D - d0);
    const int ds = d0 - d0 % Tile::SD;  // the slab's first disparity
    if (d0 == ds) {
      // the right slab of disparities [ds, ds + SD): column t holds right
      // column x0 - R - ds - (SD - 1) + t (column 0 where it is < 0)
      load_tile<Tile::NT>(rt, a.rg, a.rc, a.nplanes, a.h, a.w, y0 - R, x0 - R - ds - (Tile::SD - 1),
                L::NR, L::SW);
    }
    __syncthreads();  // tiles in place; the last chunk's walks and flush done
    // (a walk of the last chunk may run past dc: its sums are not read, and
    // its slab columns exist)
    for (int e = tid; e < (dc + Tile::DW - 1) / Tile::DW * L::TW; e += Tile::NT) {
      const int dd = e / L::TW * Tile::DW, col = e % L::TW;
      const int x = x0 - R + col;
      const uint32_t mask = x >= 0 && x < a.w ? rowmask : 0u;
      float* out = vs + dd * Tile::BH * L::RS + swz(col);
      const uint32_t* rcol = rt + col + Tile::SD - 1 - (d0 + dd - ds);
      if (a.nplanes) {
        vertical_walk<L, Tile::DW, NINE, kCensus, false>(lt + col, rcol, out, mask, planes, 0);
      } else if (a.squared) {
        vertical_walk<L, Tile::DW, NINE, kSsd, false>(lt + col, rcol, out, mask, 1, 0);
      } else {
        vertical_walk<L, Tile::DW, NINE, kSad, false>(lt + col, rcol, out, mask, 1, 0);
      }
    }
    __syncthreads();  // the chunk's sums are in place
    if (uniq) {
      horizontal_wta<R, NINE, UQ != 0>(vs, ring, st, j, g, xg, nvalid, d0, dc);
    } else {
      horizontal_wta<R, NINE, false>(vs, ring, st, j, g, xg, nvalid, d0, dc);
    }
    __syncthreads();  // every offer of the chunk is in the ring
    // flush the u's no later chunk reaches (all that are left after the
    // last): later chunks offer u <= x0 + BX - 1 - (d0 + dc)
    const int u_hi = x0 + Tile::BX - d0;
    const int u_lo = d0 + dc >= a.D ? x0 - d0 - dc + 1 : u_hi - dc;
    for (int jj = 0; jj < Tile::BH; ++jj) {
      for (int u = u_lo + tid; u < u_hi; u += Tile::NT) {
        unsigned long long* p = ring + jj * Tile::RWS + ring_at(u & (Tile::RW - 1));
        const unsigned long long v = *p;
        *p = init;
        if (v != init && y0 + jj < a.h && u >= 0 && u < a.w) {
          atomicMin(a.right + (size_t)(y0 + jj) * a.w + u, v);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < Tile::Q; ++i) {
    if (i >= nvalid) continue;
    const size_t o = (size_t)(y0 + j) * a.w + xg + i;
    a.disp[o] = st[i].disp(a.D);
    a.cbest[o] = st[i].cb;
    a.valid[o] = st[i].valid(uniq, a.uniq1p);
  }
}

template <int R, bool NINE, int UQ>
int launch(const DenseArgs& a, void* stream) {
  using L = DenseLayout<R>;
  const size_t smem = L::bytes(a.nplanes ? a.nplanes : 1);
  const dim3 grid((a.w + Tile::BX - 1) / Tile::BX, (a.h + Tile::BH - 1) / Tile::BH);
  auto kern = fused_dense_kernel<R, NINE, UQ>;
  STEPTH_LAUNCH(kern, grid, Tile::NT, smem, stream, a);
}

int launch_window(const DenseArgs& a, int win, void* stream) {
  if (win == 9) return a.use_uniq ? launch<4, true, 1>(a, stream)
                                  : launch<4, true, 0>(a, stream);
  switch (win / 2) {
    case 0: return launch<0, false, 2>(a, stream);
    case 1: return launch<1, false, 2>(a, stream);
    case 2: return launch<2, false, 2>(a, stream);
    case 3: return launch<3, false, 2>(a, stream);
    case 4: return launch<4, false, 2>(a, stream);
    case 5: return launch<5, false, 2>(a, stream);
    case 6: return launch<6, false, 2>(a, stream);
    case 7: return launch<7, false, 2>(a, stream);
    case 8: return launch<8, false, 2>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// `right` (u64 [h, w]) must hold (bits(1e30f) << 32) on entry; it returns
// (f32 bits << 32) | d of each right-view winner.
extern "C" int stepth_fused_dense(
    const float* lg, const float* rg, const int* lc, const int* rc, int nplanes,
    float* disp, unsigned long long* right, float* cbest, float* valid, int h, int w, int D,
    int win, int squared, int use_uniq, float uniq1p, int g_row0, int g_h, void* stream) {
  if (D < 1 || win < 1 || win / 2 > kMaxRadius || nplanes < 0 || nplanes > kMaxPlanes ||
      h < 1 || w < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const DenseArgs a{lg, rg, lc, rc, nplanes, disp, right, cbest, valid, h, w, D,
                    squared, use_uniq, uniq1p, g_row0, g_h};
  return launch_window(a, win, stream);
}

extern "C" const char* stepth_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
