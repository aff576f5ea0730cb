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
// What bounds it on an H100: arithmetic and barriers, not bytes. Each block
// reads its (8 + 2r) x (128 + 2r) left/right footprint per candidate from
// L1/L2 (a 1080p level reads ~16 MB of images in all), and the work is
// (2R+1) x nw candidates of cost + box sums per pixel; the right view
// doubles the columns costed and adds one atomic per pixel and window.
//
// Design: one block per 8-row band of one 128-column plan tile (bands never
// straddle plan tiles because tile_rows is a multiple of 8), so the block
// reads its window bases once and its loop bounds are uniform. Per
// candidate, all 256 threads (1) write the masked cost of the band plus its
// box halo into shared memory, (2) take the vertical box sums, then (3) each
// thread finishes the horizontal sums of its four pixels and updates their
// WTA state in registers. No TPU mechanics carry over: no rolls, no 128-lane
// padding, no aligned right-image blocks; the bases come from the same
// integer plan (tile_windows_from_prior) that the reference builds.

#include "common.cuh"

using namespace stepth;

namespace {

constexpr int BH = 8;     // output rows per block
constexpr int TW = 128;   // plan tile width (part of the output contract)
constexpr int CW = 256;   // the reference's cost-region width (right view)
constexpr int NT = 256;   // threads per block
constexpr int PPT = BH * TW / NT;  // pixels per thread
constexpr int RPT = BH * CW / NT;  // right-view targets per thread
static_assert(NT == CW, "thread t owns right-view region column t");

// box_ordered over a row of CW values taken circularly (the reference's
// pltpu.roll over the cost region), same association.
__device__ __forceinline__ float box_circular(const float* row, int q, int win) {
  auto c = [&](int j) { return row[(q + j) & (CW - 1)]; };
  if (win == 9) {
    const float y0 = (c(0) + c(-1)) + c(1);
    const float ym = (c(-3) + c(-4)) + c(-2);
    const float yp = (c(3) + c(2)) + c(4);
    return (y0 + ym) + yp;
  }
  const int r = win / 2;
  float z = c(-r);
  for (int j = -r + 1; j <= r; ++j) z = z + c(j);
  return z;
}

template <bool LR>
__global__ void __launch_bounds__(NT) fused_refine_kernel(
    const float* __restrict__ lg, const float* __restrict__ rg,
    const int* __restrict__ lc, const int* __restrict__ rc, int nplanes,
    const int* __restrict__ bases, const int* __restrict__ nw,
    float* __restrict__ disp, unsigned long long* __restrict__ rbuf, int h,
    int w, int nc, int K, int tile_rows, int R, int win, int M, int squared,
    int g_row0, int g_h) {
  extern __shared__ float smem[];
  const int r = win / 2;
  const int off = LR ? M : r;          // real column x0 - off is cost column 0
  const int Q = LR ? CW : TW + 2 * r;  // cost columns
  const int SR = BH + 2 * r;  // cost rows incl. the vertical box halo
  float* C = smem;            // [SR][Q] masked cost
  float* V = C + SR * Q;      // [BH][Q] vertical box sums
  float* A = V + BH * Q;      // [BH][CW] circular horizontal sums (LR only)

  const int jc = blockIdx.x;
  const int y0 = blockIdx.y * BH;
  const int tile = (y0 / tile_rows) * nc + jc;
  const int x0 = jc * TW;
  const int xo = x0 - off;
  const int tid = threadIdx.x;
  const int t = tid % TW;
  const size_t plane = (size_t)h * w;
  int nwt = nw[tile];
  nwt = nwt < 1 ? 1 : (nwt > K ? K : nwt);  // the reference always runs window 0

  float best[PPT], cm1[PPT], cb[PPT], cp1[PPT], prev[PPT];
  int bests[PPT], oi[PPT], wbest[PPT];
  float rbest[LR ? RPT : 1];
  int roff[LR ? RPT : 1];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    best[j] = kBig; cm1[j] = 0.f; cb[j] = kBig; cp1[j] = kBig;
    bests[j] = 0; oi[j] = -2; wbest[j] = -1;
  }

  for (int wi = 0; wi < nwt; ++wi) {
    const int base = bases[tile * K + wi];
#pragma unroll
    for (int j = 0; j < PPT; ++j) prev[j] = 0.f;
    if (LR) {
#pragma unroll
      for (int j = 0; j < RPT; ++j) { rbest[j] = kBig; roff[j] = -1; }
    }
    for (int o = -R; o <= R; ++o) {
      const int s = base + o;
      // (1) masked cost
      for (int e = tid; e < SR * Q; e += NT) {
        const int k = e / Q, q = e - (e / Q) * Q;
        const int y = y0 - r + k, x = xo + q;
        float c = 0.f;
        if (row_in_image(y, h, g_row0, g_h) && x >= 0 && x < w) {
          const int xs = x - s;
          if (xs < 0 || xs >= w) {
            c = 1e6f;
          } else if (nplanes) {
            c = (float)hamming(lc, rc, nplanes, plane, (size_t)y * w, x, xs);
          } else {
            const float diff = lg[(size_t)y * w + x] - rg[(size_t)y * w + xs];
            c = squared ? diff * diff : fabsf(diff);
          }
        }
        C[e] = c;
      }
      __syncthreads();
      // (2) vertical box sums
      for (int e = tid; e < BH * Q; e += NT) {
        const int k = e / Q, q = e - (e / Q) * Q;
        V[e] = box_ordered(&C[(k + r) * Q + q], Q, win);
      }
      __syncthreads();
      if (LR) {
        // (2b) horizontal sums of the whole region, circular
        for (int e = tid; e < BH * CW; e += NT) {
          const int k = e / CW, q = e - (e / CW) * CW;
          A[e] = box_circular(&V[k * CW], q, win);
        }
        __syncthreads();
      }
      // (3) horizontal box sums + WTA (the next candidate's writes of C, V
      // and A sit behind the next barriers)
      const int oc = o + R;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int kk = tid / TW + j * (NT / TW);
        const float a = LR ? A[kk * CW + t + M] : box_ordered(&V[kk * Q + t + r], 1, win);
        const bool upd = a < best[j];
        const bool is_next = !upd && wbest[j] == wi && oi[j] == oc - 1;
        if (upd) {
          cm1[j] = prev[j]; cb[j] = a; best[j] = a;
          bests[j] = s; oi[j] = oc; wbest[j] = wi;
        }
        if (is_next) cp1[j] = a;
        prev[j] = a;
      }
      if (LR && tid >= 2 * R) {
        // (4) right view: target q = tid takes region column q' = q - R + o,
        // which costs right column u = x(q') - s = xo + q - R - base
        const int qp = tid - R + o;
        const int xc = xo + qp, u = xc - s;
        if (xc >= 0 && xc < w && u >= 0 && u < w) {
#pragma unroll
          for (int j = 0; j < RPT; ++j) {
            const float a = A[j * CW + qp];
            if (a < rbest[j]) { rbest[j] = a; roff[j] = oc; }
          }
        }
      }
    }
    if (LR) {
      const int u = xo + tid - R - base;
      const unsigned key = (unsigned)((jc * K + wi) * (2 * R + 1));
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int y = y0 + j;
        if (roff[j] < 0 || y >= h) continue;
        const unsigned long long packed =
            ((unsigned long long)__float_as_uint(rbest[j]) << 32) | (key + roff[j]);
        atomicMin(&rbuf[(size_t)y * w + u], packed);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int y = y0 + tid / TW + j * (NT / TW);
    const int x = x0 + t;
    if (y >= h || x >= w) continue;
    const float denom = cm1[j] - 2.0f * cb[j] + cp1[j];
    float delta = fabsf(denom) > 1e-6f ? (cm1[j] - cp1[j]) / (2.0f * denom) : 0.f;
    delta = fminf(fmaxf(delta, -0.5f), 0.5f);
    const bool interior = oi[j] >= 1 && oi[j] <= 2 * R - 1;
    float dv = (float)bests[j];
    if (interior) dv = dv + delta;
    disp[(size_t)y * w + x] = fminf(fmaxf(dv, 0.f), (float)(w - 1));
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

}  // namespace

extern "C" int stepth_fused_refine(
    const float* lg, const float* rg, const int* lc, const int* rc, int nplanes,
    const int* bases, const int* nw, float* disp, unsigned long long* rbuf,
    int h, int w, int nc, int K, int tile_rows, int R, int win, int M,
    int squared, int g_row0, int g_h, int lr, void* stream) {
  const int r = win / 2;
  const int Q = lr ? CW : TW + 2 * r;
  const size_t smem =
      sizeof(float) * ((size_t)(BH + 2 * r) * Q + BH * Q + (lr ? BH * CW : 0));
  const dim3 grid(nc, (h + BH - 1) / BH);
  if (lr) {
    STEPTH_LAUNCH(fused_refine_kernel<true>, grid, NT, smem, stream, lg, rg, lc,
                  rc, nplanes, bases, nw, disp, rbuf, h, w, nc, K, tile_rows, R,
                  win, M, squared, g_row0, g_h);
  }
  STEPTH_LAUNCH(fused_refine_kernel<false>, grid, NT, smem, stream, lg, rg, lc,
                rc, nplanes, bases, nw, disp, rbuf, h, w, nc, K, tile_rows, R,
                win, M, squared, g_row0, g_h);
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
