// Census descriptors of both views of a stereo pair, in one launch.
//
// Replaces: no Pallas kernel. It stands for the XLA glue of
// stepth_tpu/match/dense.py:57 `census_transform`, whose uint32 planes the
// reference's kernels read; the port's plain version is
// match/dense.py `census_planes` (a stack of shifted views, a compare, a
// weight multiply and an int32 sum, eight neighbours an op). Output
// contract, bit for bit that plain version: for view v (0 left, 1 right)
// of gray f32 [h, w], int32 planes out[v][p][y][x]; bit i of plane p is
// neighbour 32p + i of the (2R + 1)^2 - 1 neighbours in (dy, dx) row-major
// order with the centre skipped, set where gray(y, x) > gray(clamp(y + dy),
// clamp(x + dx)) in f32 (an IEEE compare: NaN is never greater nor less,
// -0 equals +0). Clamped coordinates are the plain version's edge
// replication, so an image smaller than the window (a row shard, one row,
// one pixel) takes no other path. The bits are the reference's uint32
// bits stored in int32: bit 31 is the sign bit.
//
// What bounds it on an H100: bytes. A view reads 4 B a pixel and writes
// 4P B: census 7 (P = 2) at 1080x1920 moves 2 x 8.3 MB in and 4 x 8.3 MB
// out, 49.8 MB or 14.9 us at 3.35 TB/s. Close behind come the instructions:
// a compare and a predicated OR a bit, 96 a pixel at census 7 (~20 us at
// 1080p if the card issued nothing else), and the shared-memory reads of
// the neighbours. The design:
//
// - A block of 32 x 4 threads owns a 32-column x 16-row tile of one view
//   (blockIdx.z). It stages the tile and its R-wide halo of gray in shared
//   memory, the coordinates clamped to the image, every load of a thread
//   issued before the first store, so that their latencies overlap.
// - A thread owns one column and 4 consecutive rows. For each dx it reads
//   the 4 + 2R values of its column strip at x + dx into registers once and
//   sets the bits of every dy and every one of its rows from them:
//   (4 + 2R)(2R + 1) / 4 shared reads a pixel (17.5 at census 7) instead of
//   (2R + 1)^2 - 1. A warp reads 32 consecutive words of a row: no bank
//   conflict. A bit is one compare and one OR under its predicate.
// - The P words of each of its 4 pixels stay in registers; a warp stores
//   each plane's row as 128 contiguous bytes.
//
// The tile's shape was chosen by timing variants on an H100 at the four
// levels of the 1080p pyramid, census 7: against 32 x 64 tiles of 8-row
// strips (and the same with 64 columns, 32 or 64 rows, 4- or 16-row
// strips), 16-row tiles of 4-row strips were fastest at 1080x1920,
// 270x480 and 135x240 and within 5% of the fastest at 540x960, and the
// predicated OR took a third off a bit set by shifting the compare's
// result (or by set.gt and an AND).
//
// R is a template parameter, 1 to 7 (census windows 2-15, 1 to 7 planes:
// the widest that K2 and K6 take), so every loop unrolls and each bit's
// word and position are constants. The wrapper (match/dense.py
// census_pair) refuses other windows; here they reach no instantiation,
// and they and empty images return cudaErrorInvalidValue.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBX = 32;        // columns of a tile: one a thread
constexpr int kBY = 4;         // thread rows of a block
constexpr int kRY = 4;         // rows a thread
constexpr int kTH = kBY * kRY;  // rows of a tile
constexpr int kNT = kBX * kBY;  // threads of a block

template <int R>
__global__ void __launch_bounds__(kNT)
    census_pair_kernel(const float* __restrict__ left, const float* __restrict__ right,
                       int* __restrict__ out, int h, int w) {
  constexpr int K = 2 * R + 1;
  constexpr int N = K * K - 1;  // neighbours
  constexpr int P = (N + 31) / 32;
  constexpr int SH = kTH + 2 * R, SW = kBX + 2 * R;
  constexpr int LOADS = (SH * SW + kNT - 1) / kNT;  // a thread's share of the tile
  __shared__ float tile[SH * SW];

  const float* __restrict__ g = blockIdx.z ? right : left;
  const int x0 = blockIdx.x * kBX, y0 = blockIdx.y * kTH;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  float staged[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int e = tid + i * kNT;
    if (e < SH * SW) {
      const int y = min(max(y0 + e / SW - R, 0), h - 1);
      const int x = min(max(x0 + e % SW - R, 0), w - 1);
      staged[i] = g[(size_t)y * w + x];
    }
  }
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    if (tid + i * kNT < SH * SW) tile[tid + i * kNT] = staged[i];
  }
  __syncthreads();

  const int tx = threadIdx.x, ty = threadIdx.y * kRY;  // the strip's first row in the tile
  float centre[kRY];
#pragma unroll
  for (int j = 0; j < kRY; ++j) centre[j] = tile[(ty + j + R) * SW + tx + R];
  uint32_t words[kRY][P];
#pragma unroll
  for (int j = 0; j < kRY; ++j) {
#pragma unroll
    for (int p = 0; p < P; ++p) words[j][p] = 0u;
  }
#pragma unroll
  for (int dx = -R; dx <= R; ++dx) {
    float col[kRY + 2 * R];  // the strip's column at x + dx, rows -R .. kRY - 1 + R
#pragma unroll
    for (int k = 0; k < kRY + 2 * R; ++k) col[k] = tile[(ty + k) * SW + tx + R + dx];
#pragma unroll
    for (int dy = -R; dy <= R; ++dy) {
      if (dy == 0 && dx == 0) continue;
      const int idx = (dy + R) * K + (dx + R);
      const int n = idx < N / 2 ? idx : idx - 1;  // the centre, idx N / 2, is skipped
#pragma unroll
      for (int j = 0; j < kRY; ++j) {
        if (centre[j] > col[j + dy + R]) words[j][n / 32] |= 1u << (n % 32);
      }
    }
  }

  const int x = x0 + tx;
  if (x >= w) return;
  const size_t plane = (size_t)h * w;
  int* o = out + blockIdx.z * (P * plane) + x;
#pragma unroll
  for (int j = 0; j < kRY; ++j) {
    const int y = y0 + ty + j;
    if (y < h) {
#pragma unroll
      for (int p = 0; p < P; ++p) o[p * plane + (size_t)y * w] = (int)words[j][p];
    }
  }
}

template <int R>
int launch_census(const float* left, const float* right, int* out, int h, int w,
                  void* stream) {
  const dim3 grid((w + kBX - 1) / kBX, (h + kTH - 1) / kTH, 2);
  STEPTH_LAUNCH(census_pair_kernel<R>, grid, dim3(kBX, kBY), 0, stream, left, right, out, h,
                w);
}

}  // namespace

// `out` (int32 [2, P, h, w], P = ceil(((2 radius + 1)^2 - 1) / 32)) receives
// the planes of `left` then of `right` (f32 [h, w] each).
extern "C" int stepth_census_pair(const float* left, const float* right, int* out, int h,
                                  int w, int radius, void* stream) {
  if (h < 1 || w < 1 || (h + kTH - 1) / kTH > 65535) return (int)cudaErrorInvalidValue;
  switch (radius) {
    case 1: return launch_census<1>(left, right, out, h, w, stream);
    case 2: return launch_census<2>(left, right, out, h, w, stream);
    case 3: return launch_census<3>(left, right, out, h, w, stream);
    case 4: return launch_census<4>(left, right, out, h, w, stream);
    case 5: return launch_census<5>(left, right, out, h, w, stream);
    case 6: return launch_census<6>(left, right, out, h, w, stream);
    case 7: return launch_census<7>(left, right, out, h, w, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
