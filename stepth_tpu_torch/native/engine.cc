// Native host engine: the reference pipeline's hot loops in C++ (the port's
// copy of stepth_tpu/native/engine.cc; the same source, built apart).
//
// The reference implements its whole pipeline natively (Rust + rayon,
// reference src/depth_image.rs:91-136, src/helpers.rs:9-54); this module is the
// framework's host-side native equivalent: disage-style subdivision
// (docs/SEMANTICS.md §2) and the exact expanding ring search (§3, quirks
// Q1/Q2/Q8) with a std::thread pool playing rayon's role. It serves as
//   * a CPU engine a caller names explicitly (`depth --backend native`,
//     DepthFrame method "native"), and
//   * an independent implementation the NumPy oracle is cross-checked with.
//
// Exported C ABI (ctypes-friendly):
//   stepth_native_version() -> int
//   stepth_raw_disparity(...) -> 0 on success; fills out_raw[h*w] with the
//     per-pixel matched distance wrapped to u8 (quirk Q2), BEFORE
//     max-normalization and Gaussian resize (both applied by the Python
//     caller so the exact Q15 resampler is shared with the oracle).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Level {
  std::vector<int64_t> rb, cb;     // row/col boundaries (with terminal)
  std::vector<int32_t> row_id, col_id;  // per-pixel block ids
};

// Distinct level-k boundaries of [0, n): unique floor(i*n/2^k), i=0..2^k.
static std::vector<int64_t> axis_boundaries(int64_t n, int k) {
  std::vector<int64_t> out;
  if (k >= 21 || (int64_t(1) << k) >= n) {
    out.reserve(n + 1);
    for (int64_t v = 0; v <= n; ++v) out.push_back(v);
    return out;
  }
  const int64_t m = int64_t(1) << k;
  out.reserve(m + 1);
  int64_t prev = -1;
  for (int64_t i = 0; i <= m; ++i) {
    int64_t b = (i * n) >> k;  // floor(i*n/2^k)
    if (b != prev) { out.push_back(b); prev = b; }
  }
  return out;
}

static void fill_ids(const std::vector<int64_t>& b, std::vector<int32_t>* ids,
                     int64_t n) {
  ids->assign(n, 0);
  for (size_t blk = 0; blk + 1 < b.size(); ++blk)
    for (int64_t p = b[blk]; p < b[blk + 1]; ++p) (*ids)[p] = int32_t(blk);
}

static Level level_geometry(int h, int w, int d, bool width_first) {
  int kr = width_first ? d / 2 : (d + 1) / 2;
  int kc = width_first ? (d + 1) / 2 : d / 2;
  Level lv;
  lv.rb = axis_boundaries(h, kr);
  lv.cb = axis_boundaries(w, kc);
  fill_ids(lv.rb, &lv.row_id, h);
  fill_ids(lv.cb, &lv.col_id, w);
  return lv;
}

struct Block {
  int32_t value[3];
  int32_t seed_x, seed_y;
  int32_t x0, y0, bw, bh;
};

// Exact ring search: scan order row y+r, row y−r, col x+r, col x−r, each
// ascending (quirk Q8; reference src/helpers.rs:26-48). Returns trunc(sqrt(d²))
// or 0 on exhaustion (src/depth_image.rs:120).
static uint32_t ring_search(const uint8_t* add, int ah, int aw,
                            const int32_t value[3], const int32_t prec[3],
                            int x, int y, int max_radius) {
  auto match = [&](int py, int px) -> bool {
    const uint8_t* p = add + (int64_t(py) * aw + px) * 3;
    for (int c = 0; c < 3; ++c) {
      int32_t diff = int32_t(p[c]) - value[c];
      if (diff < 0) diff = -diff;
      if (diff >= prec[c]) return false;
    }
    return true;
  };
  auto dist = [&](int py, int px) -> uint32_t {
    int64_t dx = x - px, dy = y - py;
    return uint32_t(std::sqrt(double(dx * dx + dy * dy)));
  };
  for (int r = 0; r < max_radius; ++r) {
    bool any_inb = false;
    // row y+r then row y−r, x−r..x+r
    for (int pass = 0; pass < 2; ++pass) {
      int py = pass == 0 ? y + r : y - r;
      if (py < 0 || py >= ah) continue;
      for (int px = x - r; px <= x + r; ++px) {
        if (px < 0 || px >= aw) continue;
        any_inb = true;
        if (match(py, px)) return dist(py, px);
      }
    }
    // col x+r then col x−r, y−r..y+r
    for (int pass = 0; pass < 2; ++pass) {
      int px = pass == 0 ? x + r : x - r;
      if (px < 0 || px >= aw) continue;
      for (int py = y - r; py <= y + r; ++py) {
        if (py < 0 || py >= ah) continue;
        any_inb = true;
        if (match(py, px)) return dist(py, px);
      }
    }
    if (!any_inb) break;  // whole ring out of bounds (src/helpers.rs:49-51)
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Multithreaded hierarchical matcher — a CPU baseline.
//
// The pipeline of the hierarchical backends (coarse dense SAD + per-level
// refinement around the upsampled prior, box-window aggregation, WTA), written
// the way a performance-minded CPU implementation would be: sliding-window box
// sums (O(1) per pixel), per-disparity cost planes that never materialize the
// full volume, and a std::thread row-band pool in rayon's role (the reference
// fans out 8 ways, src/depth_image.rs:111-123).
// ---------------------------------------------------------------------------

// Run fn(t) on n_threads threads (fn receives the thread index).
template <typename F>
static void run_threads(int n_threads, F fn) {
  std::vector<std::thread> pool;
  for (int t = 1; t < n_threads; ++t) pool.emplace_back(fn, t);
  fn(0);
  for (auto& th : pool) th.join();
}

// Separable box sum with zero-outside clipping (matches dense.box_aggregate):
// horizontal pass rows-parallel, vertical pass column-band-parallel.
static void box_sum_plane(const float* in, float* tmp, float* out, int h, int w,
                          int r, int n_threads) {
  run_threads(n_threads, [&](int t) {
    for (int y = t; y < h; y += n_threads) {
      const float* row = in + size_t(y) * w;
      float* orow = tmp + size_t(y) * w;
      double s = 0;
      for (int x = 0; x < r && x < w; ++x) s += row[x];
      for (int x = 0; x < w; ++x) {
        if (x + r < w) s += row[x + r];
        orow[x] = float(s);
        if (x - r >= 0) s -= row[x - r];
      }
    }
  });
  const int band = (w + n_threads - 1) / n_threads;
  run_threads(n_threads, [&](int t) {
    const int x0 = t * band, x1 = x0 + band < w ? x0 + band : w;
    if (x0 >= x1) return;
    std::vector<double> s(x1 - x0, 0.0);
    for (int y = 0; y < r && y < h; ++y)
      for (int x = x0; x < x1; ++x) s[x - x0] += tmp[size_t(y) * w + x];
    for (int y = 0; y < h; ++y) {
      if (y + r < h)
        for (int x = x0; x < x1; ++x) s[x - x0] += tmp[size_t(y + r) * w + x];
      float* orow = out + size_t(y) * w;
      for (int x = x0; x < x1; ++x) orow[x] = float(s[x - x0]);
      if (y - r >= 0)
        for (int x = x0; x < x1; ++x) s[x - x0] -= tmp[size_t(y - r) * w + x];
    }
  });
}

}  // namespace

extern "C" {

int stepth_native_version() { return 1; }

// Hierarchical coarse-to-fine disparity (the bench.py pipeline) on f32 gray
// images. out_disp[h*w] receives the full-resolution disparity. 0 on success.
int stepth_hier_disparity(const float* left, const float* right, int h, int w,
                          int levels, int coarse_disp, int radius, int window,
                          int n_threads, float* out_disp) {
  if (h <= 0 || w <= 0 || levels < 1) return 1;
  if (n_threads <= 0) n_threads = 8;
  const int r = window / 2;

  // pyramid (2x2 mean pooling)
  std::vector<std::vector<float>> ls(levels), rs(levels);
  std::vector<int> hs(levels), ws(levels);
  hs[0] = h; ws[0] = w;
  ls[0].assign(left, left + size_t(h) * w);
  rs[0].assign(right, right + size_t(h) * w);
  for (int l = 1; l < levels; ++l) {
    const int ph = hs[l - 1], pw = ws[l - 1];
    hs[l] = ph / 2; ws[l] = pw / 2;
    ls[l].resize(size_t(hs[l]) * ws[l]);
    rs[l].resize(size_t(hs[l]) * ws[l]);
    for (int img = 0; img < 2; ++img) {
      const float* src = img ? rs[l - 1].data() : ls[l - 1].data();
      float* dst = img ? rs[l].data() : ls[l].data();
      run_threads(n_threads, [&](int t) {
        for (int y = t; y < hs[l]; y += n_threads)
          for (int x = 0; x < ws[l]; ++x)
            dst[size_t(y) * ws[l] + x] =
                0.25f * (src[size_t(2 * y) * pw + 2 * x] +
                         src[size_t(2 * y) * pw + 2 * x + 1] +
                         src[size_t(2 * y + 1) * pw + 2 * x] +
                         src[size_t(2 * y + 1) * pw + 2 * x + 1]);
      });
    }
  }

  // coarse dense SAD over coarse_disp shifts
  const int ch = hs[levels - 1], cw = ws[levels - 1];
  const size_t cn = size_t(ch) * cw;
  std::vector<float> cost(cn), tmp(cn), agg(cn), best(cn, 1e30f);
  std::vector<float> disp(cn);
  for (int d = 0; d < coarse_disp; ++d) {
    const float* L = ls[levels - 1].data();
    const float* R = rs[levels - 1].data();
    run_threads(n_threads, [&](int t) {
      for (int y = t; y < ch; y += n_threads)
        for (int x = 0; x < cw; ++x) {
          int xs = x - d; if (xs < 0) xs = 0;  // edge replicate
          cost[size_t(y) * cw + x] =
              std::fabs(L[size_t(y) * cw + x] - R[size_t(y) * cw + xs]);
        }
    });
    box_sum_plane(cost.data(), tmp.data(), agg.data(), ch, cw, r, n_threads);
    run_threads(n_threads, [&](int t) {
      for (size_t p = t; p < cn; p += size_t(n_threads))
        if (agg[p] < best[p]) { best[p] = agg[p]; disp[p] = float(d); }
    });
  }

  // refine levels: candidates base+o around the upsampled prior
  for (int l = levels - 2; l >= 0; --l) {
    const int lh = hs[l], lw = ws[l];
    const size_t ln = size_t(lh) * lw;
    std::vector<float> prior(ln);
    run_threads(n_threads, [&](int t) {
      for (int y = t; y < lh; y += n_threads)
        for (int x = 0; x < lw; ++x) {
          int py = y / 2; if (py >= hs[l + 1]) py = hs[l + 1] - 1;
          int px = x / 2; if (px >= ws[l + 1]) px = ws[l + 1] - 1;
          prior[size_t(y) * lw + x] = 2.0f * disp[size_t(py) * ws[l + 1] + px];
        }
    });
    cost.resize(ln); tmp.resize(ln); agg.resize(ln);
    std::vector<float> lbest(ln, 1e30f), ldisp(ln);
    const float* L = ls[l].data();
    const float* R = rs[l].data();
    for (int o = -radius; o <= radius; ++o) {
      run_threads(n_threads, [&](int t) {
        for (int y = t; y < lh; y += n_threads)
          for (int x = 0; x < lw; ++x) {
            const size_t p = size_t(y) * lw + x;
            const int s = int(std::lround(prior[p])) + o;
            const int xs = x - s;
            cost[p] = (xs < 0 || xs >= lw)
                          ? 1e6f
                          : std::fabs(L[p] - R[size_t(y) * lw + xs]);
          }
      });
      box_sum_plane(cost.data(), tmp.data(), agg.data(), lh, lw, r, n_threads);
      run_threads(n_threads, [&](int t) {
        for (size_t p = t; p < ln; p += size_t(n_threads))
          if (agg[p] < lbest[p]) {
            lbest[p] = agg[p];
            float dv = float(int(std::lround(prior[p])) + o);
            if (dv < 0.f) dv = 0.f;
            if (dv > float(lw - 1)) dv = float(lw - 1);
            ldisp[p] = dv;
          }
      });
    }
    disp.swap(ldisp);
  }

  std::memcpy(out_disp, disp.data(), size_t(h) * w * sizeof(float));
  return 0;
}

// Subdivide main_rgb, ring-search each leaf block in add_rgb, paint each leaf's
// wrapped distance across its extent. Returns 0 on success.
int stepth_raw_disparity(const uint8_t* main_rgb, const uint8_t* add_rgb,
                         int h, int w, int ah, int aw,
                         const int32_t* precision, int min_splits,
                         int max_splits, int max_radius, int n_threads,
                         uint8_t* out_raw) {
  if (h <= 0 || w <= 0 || ah <= 0 || aw <= 0) return 1;
  if (max_splits <= 0)
    max_splits = int(std::ceil(std::log2(double(int64_t(h) * w))));
  int eff_min = min_splits < max_splits ? min_splits : max_splits;
  bool width_first = w >= h;
  const int64_t npix = int64_t(h) * w;

  // ---- per-pixel leaf level (docs/SEMANTICS.md §2) -------------------------
  std::vector<int32_t> level(npix, -1);
  std::vector<Level> levels;
  levels.reserve(max_splits - eff_min + 1);
  for (int d = eff_min; d <= max_splits; ++d) {
    Level lv = level_geometry(h, w, d, width_first);
    const size_t nr = lv.rb.size() - 1, nc = lv.cb.size() - 1;
    // per-block channel min/max
    std::vector<int32_t> bmin(nr * nc * 3, 255), bmax(nr * nc * 3, 0);
    for (int y = 0; y < h; ++y) {
      const int32_t bi = lv.row_id[y];
      const uint8_t* row = main_rgb + int64_t(y) * w * 3;
      for (int x = 0; x < w; ++x) {
        const int32_t bj = lv.col_id[x];
        int32_t* mn = &bmin[(size_t(bi) * nc + bj) * 3];
        int32_t* mx = &bmax[(size_t(bi) * nc + bj) * 3];
        for (int c = 0; c < 3; ++c) {
          int32_t v = row[x * 3 + c];
          if (v < mn[c]) mn[c] = v;
          if (v > mx[c]) mx[c] = v;
        }
      }
    }
    for (int y = 0; y < h; ++y) {
      const int32_t bi = lv.row_id[y];
      for (int x = 0; x < w; ++x) {
        int64_t p = int64_t(y) * w + x;
        if (level[p] >= 0) continue;
        const int32_t bj = lv.col_id[x];
        const int32_t* mn = &bmin[(size_t(bi) * nc + bj) * 3];
        const int32_t* mx = &bmax[(size_t(bi) * nc + bj) * 3];
        bool homog = true;
        for (int c = 0; c < 3; ++c)
          if (mx[c] - mn[c] > precision[c]) { homog = false; break; }
        if (homog || d == max_splits) level[p] = d;
      }
    }
    levels.push_back(std::move(lv));
  }

  // ---- integral image for exact block means --------------------------------
  std::vector<int64_t> integ(size_t(h + 1) * (w + 1) * 3, 0);
  const size_t istride = size_t(w + 1) * 3;
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = main_rgb + int64_t(y) * w * 3;
    int64_t rsum[3] = {0, 0, 0};
    for (int x = 0; x < w; ++x) {
      for (int c = 0; c < 3; ++c) {
        rsum[c] += row[x * 3 + c];
        integ[(y + 1) * istride + (x + 1) * 3 + c] =
            integ[y * istride + (x + 1) * 3 + c] + rsum[c];
      }
    }
  }

  // ---- collect unique leaf blocks (top-left pixel owns the block) ----------
  std::vector<Block> blocks;
  std::vector<int64_t> block_of(npix, -1);  // per-pixel block index
  for (int d = eff_min; d <= max_splits; ++d) {
    const Level& lv = levels[d - eff_min];
    for (size_t bi = 0; bi + 1 < lv.rb.size(); ++bi) {
      const int64_t y0 = lv.rb[bi], y1 = lv.rb[bi + 1];
      for (size_t bj = 0; bj + 1 < lv.cb.size(); ++bj) {
        const int64_t x0 = lv.cb[bj], x1 = lv.cb[bj + 1];
        if (level[y0 * w + x0] != d) continue;
        if (block_of[y0 * w + x0] >= 0) continue;  // painted by a coarser level
        Block b;
        b.x0 = int32_t(x0); b.y0 = int32_t(y0);
        b.bw = int32_t(x1 - x0); b.bh = int32_t(y1 - y0);
        const int64_t area = int64_t(b.bw) * b.bh;
        for (int c = 0; c < 3; ++c) {
          int64_t s = integ[y1 * istride + x1 * 3 + c] -
                      integ[y0 * istride + x1 * 3 + c] -
                      integ[y1 * istride + x0 * 3 + c] +
                      integ[y0 * istride + x0 * 3 + c];
          b.value[c] = int32_t(s / area);  // floor mean (MeanBrightnessHasher)
        }
        // quirk Q1 seed (reference src/depth_image.rs:114-117)
        b.seed_x = int32_t((x0 + b.bw) / 2);
        b.seed_y = int32_t((y0 + b.bh) / 2);
        int64_t id = int64_t(blocks.size());
        blocks.push_back(b);
        for (int64_t y = y0; y < y1; ++y)
          for (int64_t x = x0; x < x1; ++x) block_of[y * w + x] = id;
      }
    }
  }

  // ---- parallel ring search over blocks (rayon par_chunks equivalent) ------
  std::vector<uint8_t> dists(blocks.size(), 0);
  if (n_threads <= 0) n_threads = 8;  // reference chunks into 8 (src/depth_image.rs:111)
  std::atomic<size_t> cursor{0};
  auto worker = [&]() {
    const size_t CHUNK = 64;
    for (;;) {
      size_t begin = cursor.fetch_add(CHUNK);
      if (begin >= blocks.size()) break;
      size_t end = begin + CHUNK < blocks.size() ? begin + CHUNK : blocks.size();
      for (size_t i = begin; i < end; ++i) {
        const Block& b = blocks[i];
        uint32_t d32 = ring_search(add_rgb, ah, aw, b.value, precision,
                                   b.seed_x, b.seed_y, max_radius);
        dists[i] = uint8_t(d32 & 0xFF);  // quirk Q2 wrap
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads - 1; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();

  for (int64_t p = 0; p < npix; ++p) out_raw[p] = dists[size_t(block_of[p])];
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Semi-global matching (the accuracy backend's CPU baseline; the same
// pipeline as the plain sgm backend, match/sgm.py). On u8-valued gray
// inputs every intermediate is an exact small integer in f32 (costs <= 255,
// box sums <= 255*window^2, path costs bounded by the min-normalized
// recurrence), so outputs are BIT-IDENTICAL to the sgm backend's.
// Threading: horizontal scans rows-parallel, vertical scans
// column-band-parallel (columns independent at shift 0); the 8-dir mode's
// diagonal scans carry state across columns and run single-threaded.
// ---------------------------------------------------------------------------

namespace {

// One SGM recurrence step for a [w, D] carry row against cost row c.
// prev_row: carry at the predecessor scan position (already the previous
// step's L); lateral shift handled by the caller via prev indexing.
static inline void sgm_step_row(const float* prev, const float* c, float* out,
                                int wlen, int D, float p1, float p2,
                                int shift) {
  for (int t = 0; t < wlen; ++t) {
    const float* pr = nullptr;
    const int ts = t - shift;  // dir_step: shifted-in positions start fresh
    bool fresh = (ts < 0 || ts >= wlen);
    if (!fresh) pr = prev + size_t(ts) * D;
    float min_l = 0.0f;
    if (!fresh) {
      min_l = pr[0];
      for (int d = 1; d < D; ++d)
        if (pr[d] < min_l) min_l = pr[d];
    }
    const float* cr = c + size_t(t) * D;
    float* o = out + size_t(t) * D;
    if (fresh) {  // zero carry: min(0, p1, p2) - 0 = 0 => L = C
      for (int d = 0; d < D; ++d) o[d] = cr[d];
      continue;
    }
    for (int d = 0; d < D; ++d) {
      float cand = pr[d];
      if (d > 0 && pr[d - 1] + p1 < cand) cand = pr[d - 1] + p1;
      if (d + 1 < D && pr[d + 1] + p1 < cand) cand = pr[d + 1] + p1;
      if (min_l + p2 < cand) cand = min_l + p2;
      o[d] = cr[d] + cand - min_l;
    }
  }
}

}  // namespace

extern "C" {

// Full SGM disparity on f32 gray images (layout [h][w], vol/agg [h][w][D]).
// p1/p2 are the per-pixel-cost penalties (scaled by window^2 internally when
// window > 1, mirroring match_pair_sgm). directions in {2, 4, 8};
// lr_threshold < 0 disables the LR check. out_disp f32[h*w]; out_valid
// u8[h*w]. Returns 0 on success.
int stepth_sgm_disparity(const float* left, const float* right, int h, int w,
                         int D, int window, float p1, float p2, int directions,
                         float lr_threshold, int subpixel, int n_threads,
                         float* out_disp, uint8_t* out_valid) {
  if (h <= 0 || w <= 0 || D <= 0) return 1;
  if (directions != 2 && directions != 4 && directions != 8) return 2;
  if (n_threads <= 0) n_threads = 8;
  const int r = window / 2;
  const float scale = window > 1 ? float(window) * float(window) : 1.0f;
  const float p1s = p1 * scale, p2s = p2 * scale;
  const size_t n = size_t(h) * w;

  // cost volume, box-aggregated per disparity plane ([h][w][D], D innermost)
  std::vector<float> vol(n * D), plane(n), tmp(n), aggp(n);
  for (int d = 0; d < D; ++d) {
    run_threads(n_threads, [&](int t) {
      for (int y = t; y < h; y += n_threads)
        for (int x = 0; x < w; ++x) {
          int xs = x - d; if (xs < 0) xs = 0;  // edge replicate (dense._shift_right_image)
          plane[size_t(y) * w + x] =
              std::fabs(left[size_t(y) * w + x] - right[size_t(y) * w + xs]);
        }
    });
    const float* src = plane.data();
    if (window > 1) {
      box_sum_plane(plane.data(), tmp.data(), aggp.data(), h, w, r, n_threads);
      src = aggp.data();
    }
    run_threads(n_threads, [&](int t) {
      for (size_t p = t; p < n; p += size_t(n_threads)) vol[p * D + d] = src[p];
    });
  }

  std::vector<float> agg(n * D, 0.0f);
  std::vector<float> carry(size_t(std::max(h, w)) * D);
  std::vector<float> next(size_t(std::max(h, w)) * D);

  // horizontal scans: per-row [D] carries, rows fully parallel
  for (int rev = 0; rev < 2; ++rev) {
    run_threads(n_threads, [&](int t) {
      std::vector<float> cr(D), nx(D);
      for (int y = t; y < h; y += n_threads) {
        bool first = true;
        for (int i = 0; i < w; ++i) {
          const int x = rev ? (w - 1 - i) : i;
          const float* c = &vol[(size_t(y) * w + x) * D];
          float* L = &agg[(size_t(y) * w + x) * D];
          if (first) {
            for (int d = 0; d < D; ++d) { nx[d] = c[d]; L[d] += c[d]; }
            first = false;
          } else {
            sgm_step_row(cr.data(), c, nx.data(), 1, D, p1s, p2s, 0);
            for (int d = 0; d < D; ++d) L[d] += nx[d];
          }
          cr.swap(nx);
        }
      }
    });
  }

  // vertical scans: [w][D] carry rows; columns independent -> band-parallel
  if (directions >= 4) {
    const int band = (w + n_threads - 1) / n_threads;
    for (int rev = 0; rev < 2; ++rev) {
      run_threads(n_threads, [&](int t) {
        const int x0 = t * band, x1 = x0 + band < w ? x0 + band : w;
        if (x0 >= x1) return;
        std::vector<float> cr(size_t(x1 - x0) * D), nx(size_t(x1 - x0) * D);
        bool first = true;
        for (int i = 0; i < h; ++i) {
          const int y = rev ? (h - 1 - i) : i;
          const float* c = &vol[(size_t(y) * w + x0) * D];
          float* L = &agg[(size_t(y) * w + x0) * D];
          if (first) {
            for (size_t k = 0; k < size_t(x1 - x0) * D; ++k) {
              nx[k] = c[k]; L[k] += c[k];
            }
            first = false;
          } else {
            sgm_step_row(cr.data(), c, nx.data(), x1 - x0, D, p1s, p2s, 0);
            for (size_t k = 0; k < size_t(x1 - x0) * D; ++k) L[k] += nx[k];
          }
          cr.swap(nx);
        }
      });
    }
  }

  // diagonal scans (8-dir): carry shifts one column per row-step; serial
  if (directions == 8) {
    for (int pass = 0; pass < 4; ++pass) {
      const bool rev = pass >= 2;                    // the sgm backend's order: ++, +-, -+, --
      const int shift = (pass % 2 == 0) ? 1 : -1;
      bool first = true;
      for (int i = 0; i < h; ++i) {
        const int y = rev ? (h - 1 - i) : i;
        const float* c = &vol[size_t(y) * w * D];
        float* L = &agg[size_t(y) * w * D];
        if (first) {
          for (size_t k = 0; k < size_t(w) * D; ++k) { next[k] = c[k]; L[k] += c[k]; }
          first = false;
        } else {
          sgm_step_row(carry.data(), c, next.data(), w, D, p1s, p2s, shift);
          for (size_t k = 0; k < size_t(w) * D; ++k) L[k] += next[k];
        }
        carry.swap(next);
      }
    }
  }

  // WTA + parabolic subpixel (dense.wta), right-view WTA + LR + fill + median
  std::vector<float> disp(n), dr;
  std::vector<uint8_t> valid(n, 1);
  run_threads(n_threads, [&](int t) {
    for (size_t p = t; p < n; p += size_t(n_threads)) {
      const float* a = &agg[p * D];
      int best = 0;
      for (int d = 1; d < D; ++d)
        if (a[d] < a[best]) best = d;  // first minimum, like jnp.argmin
      float dv = float(best);
      if (subpixel && D >= 3) {
        int bm = best < 1 ? 1 : (best > D - 2 ? D - 2 : best);
        const float cm1 = a[bm - 1], c0 = a[bm], cp1 = a[bm + 1];
        const float denom = cm1 - 2.0f * c0 + cp1;
        float delta = std::fabs(denom) > 1e-6f ? (cm1 - cp1) / (2.0f * denom) : 0.0f;
        if (delta < -0.5f) delta = -0.5f;
        if (delta > 0.5f) delta = 0.5f;
        if (best >= 1 && best <= D - 2) dv = float(bm) + delta;
      }
      disp[p] = dv;
    }
  });

  if (lr_threshold >= 0.0f) {
    dr.resize(n);
    run_threads(n_threads, [&](int t) {
      for (int y = t; y < h; y += n_threads)
        for (int x = 0; x < w; ++x) {
          int best = 0; float bc = 1e30f; bool any = false;
          for (int d = 0; d < D; ++d) {
            if (x + d >= w) continue;  // inf-padded in the sgm backend
            const float c = agg[(size_t(y) * w + x + d) * D + d];
            if (!any || c < bc) { bc = c; best = d; any = true; }
          }
          dr[size_t(y) * w + x] = float(best);  // argmin of all-inf row is 0
        }
    });
    run_threads(n_threads, [&](int t) {
      for (int y = t; y < h; y += n_threads)
        for (int x = 0; x < w; ++x) {
          const size_t p = size_t(y) * w + x;
          const float dl = disp[p];
          float xr = std::nearbyintf(float(x) - dl);  // round-half-even
          if (xr < 0.0f) xr = 0.0f;
          if (xr > float(w - 1)) xr = float(w - 1);
          bool ok = false;
          for (int s = 0; s < D && !ok; ++s) {
            float xs = float(x - s);
            if (xs < 0.0f) xs = 0.0f;
            if (xs > float(w - 1)) xs = float(w - 1);
            if (xr != xs) continue;
            const int col = x - s < 0 ? 0 : x - s;  // edge pad on the left
            if (std::fabs(dl - dr[size_t(y) * w + col]) <= lr_threshold) ok = true;
          }
          valid[p] = ok ? 1 : 0;
        }
    });
  }

  // occlusion fill: nearer (smaller) of nearest valid left/right per scanline
  std::vector<float> filled(disp);
  run_threads(n_threads, [&](int t) {
    std::vector<float> lf(w), rf(w);
    for (int y = t; y < h; y += n_threads) {
      const size_t row = size_t(y) * w;
      float last = 1e30f; bool has = false;
      for (int x = 0; x < w; ++x) {
        if (valid[row + x]) { last = disp[row + x]; has = true; }
        lf[x] = has ? last : 1e30f;
      }
      last = 1e30f; has = false;
      for (int x = w - 1; x >= 0; --x) {
        if (valid[row + x]) { last = disp[row + x]; has = true; }
        rf[x] = has ? last : 1e30f;
      }
      for (int x = 0; x < w; ++x) {
        if (valid[row + x]) continue;
        float f = lf[x] < rf[x] ? lf[x] : rf[x];
        filled[row + x] = f < 1e30f ? f : 0.0f;
      }
    }
  });

  // 3x3 median, edge-padded
  run_threads(n_threads, [&](int t) {
    float win[9];
    for (int y = t; y < h; y += n_threads)
      for (int x = 0; x < w; ++x) {
        int k = 0;
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx) {
            int yy = y + dy; if (yy < 0) yy = 0; if (yy >= h) yy = h - 1;
            int xx = x + dx; if (xx < 0) xx = 0; if (xx >= w) xx = w - 1;
            win[k++] = filled[size_t(yy) * w + xx];
          }
        std::nth_element(win, win + 4, win + 9);
        out_disp[size_t(y) * w + x] = win[4];
      }
  });
  std::memcpy(out_valid, valid.data(), n);
  return 0;
}

}  // extern "C"
