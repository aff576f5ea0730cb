// K1 — fused exhaustive stereo matcher.
//
// Replaces: stepth_tpu/match/pallas_dense.py, `_kernel` (called through
// `raw_match`). Same output contract: per pixel, over all d < D, the SAD/SSD
// cost against the right image sampled at x-d (edge-replicated for x-d < 0)
// or, with nplanes > 0, the census Hamming distance sum_p popc(l ^ r) of
// int32 descriptor planes [P, H, W] (column 0's descriptor for x-d < 0),
// a zero-padded win x win box sum, a first-minimum WTA (strict <, ascending d)
// with parabolic subpixel for best in [1, D-2], the optional uniqueness test
// against the best cost outside +-1, and the right-view WTA
// costR(x, d) = costL(x+d, d) (BIG where x+d > W-1). The reference's
// in-kernel LR sweep reads the right-view disparity of every column of the
// row, which a block does not hold: the wrapper runs K4 after this kernel.
// Hamming costs are integers <= 32 P, so their box sums are exact in f32.
//
// What bounds it on an H100: not memory — the [H, W, D] cost volume never
// leaves the SM, and each input pixel is read from L1/L2 once per d. It is
// bound by the box-sum adds and __syncthreads between the four stages per d.
// On the main path it runs once per frame at the coarsest level (135x240,
// D=16), where the whole problem is ~64 blocks: launch- and latency-bound.
//
// Design: one block per 8-row x 128-column output tile, 256 threads, four
// pixels per thread. Per d, the block (1) writes the masked cost of the tile
// plus its box halo into shared memory, (2) takes the vertical box sums,
// (3) the horizontal box sums, over E = 128 + D - 1 columns so that the
// right-view WTA of every output column finds costL(x+d, d) in the block,
// and (4) updates the WTA state held in registers. The sums follow the
// reference's association (common.cuh), so results match the plain version.

#include "common.cuh"

using namespace stepth;

namespace {

constexpr int BH = 8;     // output rows per block
constexpr int BX = 128;   // output columns per block
constexpr int NT = 256;   // threads per block
constexpr int PPT = BH * BX / NT;  // pixels per thread

__global__ void __launch_bounds__(NT) fused_dense_kernel(
    const float* __restrict__ lg, const float* __restrict__ rg,
    const int* __restrict__ lc, const int* __restrict__ rc, int nplanes,
    float* __restrict__ disp, float* __restrict__ dispr,
    float* __restrict__ cbest, float* __restrict__ valid,
    int h, int w, int D, int win, int squared, int use_uniq, float uniq1p,
    int g_row0, int g_h) {
  extern __shared__ float smem[];
  const int r = win / 2;
  const int E = BX + D - 1;   // columns whose aggregated cost the block needs
  const int QC = E + 2 * r;   // cost columns incl. the horizontal box halo
  const int SR = BH + 2 * r;  // cost rows incl. the vertical box halo
  float* C = smem;            // [SR][QC] masked cost
  float* V = C + SR * QC;     // [BH][QC] vertical box sums
  float* A = V + BH * QC;     // [BH][E]  aggregated cost

  const int x0 = blockIdx.x * BX;
  const int y0 = blockIdx.y * BH;
  const int tid = threadIdx.x;
  const int t = tid % BX;

  float best[PPT], cm1[PPT], cb[PPT], cp1[PPT], prev[PPT];
  float bestr[PPT], runlag2[PPT], second[PPT];
  int bestd[PPT], bestrd[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    best[j] = kBig; cm1[j] = 0.f; cb[j] = kBig; cp1[j] = kBig; prev[j] = 0.f;
    bestr[j] = kBig; runlag2[j] = kBig; second[j] = kBig;
    bestd[j] = 0; bestrd[j] = 0;
  }

  for (int d = 0; d < D; ++d) {
    // (1) masked cost: 0 outside the image (zero-padded box sums)
    for (int e = tid; e < SR * QC; e += NT) {
      const int k = e / QC, q = e - (e / QC) * QC;
      const int y = y0 - r + k, x = x0 - r + q;
      float c = 0.f;
      if (row_in_image(y, h, g_row0, g_h) && x >= 0 && x < w) {
        const int xs = x - d < 0 ? 0 : x - d;
        if (nplanes) {
          c = (float)hamming(lc, rc, nplanes, (size_t)h * w, (size_t)y * w,
                             x, xs);
        } else {
          const float diff = lg[(size_t)y * w + x] - rg[(size_t)y * w + xs];
          c = squared ? diff * diff : fabsf(diff);
        }
      }
      C[e] = c;
    }
    __syncthreads();
    // (2) vertical box sums for the BH output rows
    for (int e = tid; e < BH * QC; e += NT) {
      const int k = e / QC, q = e - (e / QC) * QC;
      V[e] = box_ordered(&C[(k + r) * QC + q], QC, win);
    }
    __syncthreads();
    // (3) horizontal box sums
    for (int e = tid; e < BH * E; e += NT) {
      const int k = e / E, x = e - (e / E) * E;
      A[e] = box_ordered(&V[k * QC + x + r], 1, win);
    }
    __syncthreads();
    // (4) WTA updates (the stages above are separated by barriers, so the
    // next d's writes of C and V cannot overtake these reads of A)
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int kk = tid / BX + j * (NT / BX);
      const float a = A[kk * E + t];
      const bool upd = a < best[j];
      const bool is_next = !upd && bestd[j] == d - 1;
      if (upd) { cm1[j] = prev[j]; cb[j] = a; }
      if (is_next) cp1[j] = a;
      if (use_uniq) {
        // second best outside the +-1 zone: restart from min over [0, d-2]
        // on a new best, else accumulate costs with d > bestd + 1
        const bool far = !upd && d > bestd[j] + 1;
        if (upd) second[j] = runlag2[j];
        if (far) second[j] = fminf(second[j], a);
        runlag2[j] = fminf(runlag2[j], prev[j] + (d < 1 ? kBig : 0.f));
      }
      if (upd) { best[j] = a; bestd[j] = d; }
      // right view: costR(x, d) = costL(x + d, d)
      const float ar = (x0 + t + d <= w - 1) ? A[kk * E + t + d] : kBig;
      if (ar < bestr[j]) { bestr[j] = ar; bestrd[j] = d; }
      prev[j] = a;
    }
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int y = y0 + tid / BX + j * (NT / BX);
    const int x = x0 + t;
    if (y >= h || x >= w) continue;
    const float denom = cm1[j] - 2.0f * cb[j] + cp1[j];
    float delta = fabsf(denom) > 1e-6f ? (cm1[j] - cp1[j]) / (2.0f * denom) : 0.f;
    delta = fminf(fmaxf(delta, -0.5f), 0.5f);
    const bool interior = bestd[j] >= 1 && bestd[j] <= D - 2;
    const float bd = (float)bestd[j];
    const size_t o = (size_t)y * w + x;
    disp[o] = interior ? bd + delta : bd;
    dispr[o] = (float)bestrd[j];
    cbest[o] = cb[j];
    valid[o] = (!use_uniq || cb[j] * uniq1p <= second[j]) ? 1.f : 0.f;
  }
}

}  // namespace

extern "C" int stepth_fused_dense(
    const float* lg, const float* rg, const int* lc, const int* rc, int nplanes,
    float* disp, float* dispr, float* cbest, float* valid, int h, int w, int D,
    int win, int squared, int use_uniq, float uniq1p, int g_row0, int g_h,
    void* stream) {
  const int r = win / 2;
  const int E = BX + D - 1;
  const int QC = E + 2 * r;
  const size_t smem = sizeof(float) * ((size_t)(BH + 2 * r) * QC + BH * QC + BH * E);
  const dim3 grid((w + BX - 1) / BX, (h + BH - 1) / BH);
  STEPTH_LAUNCH(fused_dense_kernel, grid, NT, smem, stream, lg, rg, lc, rc,
                nplanes, disp, dispr, cbest, valid, h, w, D, win, squared,
                use_uniq, uniq1p, g_row0, g_h);
}

extern "C" const char* stepth_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
