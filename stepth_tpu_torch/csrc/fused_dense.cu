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
// and (4) updates the WTA state held in registers. Stages (1)-(2) and the WTA
// update are common.cuh's, shared with K6 and K9; the sums follow the
// reference's association, so results match the plain version.

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

  WtaState st[PPT];
  float bestr[PPT];
  int bestrd[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    st[j].init();
    bestr[j] = kBig;
    bestrd[j] = 0;
  }

  for (int d = 0; d < D; ++d) {
    // (1) masked cost, (2) vertical box sums (common.cuh)
    cost_front_vertical<BH, NT>(C, V, lg, rg, lc, rc, nplanes, h, w, x0, y0, QC, d,
                                win, squared, g_row0, g_h);
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
      st[j].update(A[kk * E + t], d, use_uniq);
      // right view: costR(x, d) = costL(x + d, d)
      const float ar = (x0 + t + d <= w - 1) ? A[kk * E + t + d] : kBig;
      if (ar < bestr[j]) { bestr[j] = ar; bestrd[j] = d; }
    }
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int y = y0 + tid / BX + j * (NT / BX);
    const int x = x0 + t;
    if (y >= h || x >= w) continue;
    const size_t o = (size_t)y * w + x;
    disp[o] = st[j].disp(D);
    dispr[o] = (float)bestrd[j];
    cbest[o] = st[j].cb;
    valid[o] = st[j].valid(use_uniq, uniq1p);
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
