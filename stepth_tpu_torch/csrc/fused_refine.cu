// K2 — tile-base refine kernel (one pyramid level, no right view).
//
// Replaces: stepth_tpu/match/pallas_refine.py, `_refine_kernel` (called
// through `refine_level`, lr=False mode). Same output contract: per
// (tile_rows x 128-column) plan tile, up to nw[i, jc] base windows in plan
// order, candidates s = base + o for o = -R..R ascending (s may be negative);
// cost |L(x) - R(x-s)| (or squared), 1e6 where x-s falls outside [0, W),
// zeroed outside the image before a zero-padded win x win box sum; a
// strict-< WTA merged across windows; subpixel pairs only within one window
// and only for offset index in [1, 2R-1]; result clipped to [0, W-1].
//
// What bounds it on an H100: arithmetic and barriers, not bytes. Each block
// reads its (8 + 2r) x (128 + 2r) left/right footprint per candidate from
// L1/L2 (a 1080p level reads ~16 MB of images in all), and the work is
// (2R+1) x nw candidates of cost + box sums per pixel. Smooth content plans
// nw = 1, so most tiles run 2R+1 = 5 candidates.
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
constexpr int NT = 256;   // threads per block
constexpr int PPT = BH * TW / NT;  // pixels per thread

__global__ void __launch_bounds__(NT) fused_refine_kernel(
    const float* __restrict__ lg, const float* __restrict__ rg,
    const int* __restrict__ bases, const int* __restrict__ nw,
    float* __restrict__ disp, int h, int w, int nc, int K, int tile_rows,
    int R, int win, int squared, int g_row0, int g_h) {
  extern __shared__ float smem[];
  const int r = win / 2;
  const int Q = TW + 2 * r;   // cost columns incl. the horizontal box halo
  const int SR = BH + 2 * r;  // cost rows incl. the vertical box halo
  float* C = smem;            // [SR][Q] masked cost
  float* V = C + SR * Q;      // [BH][Q] vertical box sums

  const int jc = blockIdx.x;
  const int y0 = blockIdx.y * BH;
  const int tile = (y0 / tile_rows) * nc + jc;
  const int x0 = jc * TW;
  const int tid = threadIdx.x;
  const int t = tid % TW;
  int nwt = nw[tile];
  nwt = nwt < 1 ? 1 : (nwt > K ? K : nwt);  // the reference always runs window 0

  float best[PPT], cm1[PPT], cb[PPT], cp1[PPT], prev[PPT];
  int bests[PPT], oi[PPT], wbest[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    best[j] = kBig; cm1[j] = 0.f; cb[j] = kBig; cp1[j] = kBig;
    bests[j] = 0; oi[j] = -2; wbest[j] = -1;
  }

  for (int wi = 0; wi < nwt; ++wi) {
    const int base = bases[tile * K + wi];
#pragma unroll
    for (int j = 0; j < PPT; ++j) prev[j] = 0.f;
    for (int o = -R; o <= R; ++o) {
      const int s = base + o;
      // (1) masked cost
      for (int e = tid; e < SR * Q; e += NT) {
        const int k = e / Q, q = e - (e / Q) * Q;
        const int y = y0 - r + k, x = x0 - r + q;
        float c = 0.f;
        if (row_in_image(y, h, g_row0, g_h) && x >= 0 && x < w) {
          const int xs = x - s;
          if (xs < 0 || xs >= w) {
            c = 1e6f;
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
      // (3) horizontal box sums + WTA (the next candidate's writes of C and
      // V sit behind the next two barriers)
      const int oc = o + R;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int kk = tid / TW + j * (NT / TW);
        const float a = box_ordered(&V[kk * Q + t + r], 1, win);
        const bool upd = a < best[j];
        const bool is_next = !upd && wbest[j] == wi && oi[j] == oc - 1;
        if (upd) {
          cm1[j] = prev[j]; cb[j] = a; best[j] = a;
          bests[j] = s; oi[j] = oc; wbest[j] = wi;
        }
        if (is_next) cp1[j] = a;
        prev[j] = a;
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

}  // namespace

extern "C" int stepth_fused_refine(
    const float* lg, const float* rg, const int* bases, const int* nw,
    float* disp, int h, int w, int nc, int K, int tile_rows, int R, int win,
    int squared, int g_row0, int g_h, void* stream) {
  const int r = win / 2;
  const int Q = TW + 2 * r;
  const size_t smem = sizeof(float) * ((size_t)(BH + 2 * r) * Q + BH * Q);
  const dim3 grid(nc, (h + BH - 1) / BH);
  STEPTH_LAUNCH(fused_refine_kernel, grid, NT, smem, stream, lg, rg, bases, nw,
                disp, h, w, nc, K, tile_rows, R, win, squared, g_row0, g_h);
}
