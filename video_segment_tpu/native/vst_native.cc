// Native host kernels for the streaming runtime.
//
// The device owns the numeric path; these are the host-side hot loops the
// reference implements in C++ and that NumPy cannot express efficiently:
//  - multi_label_cc: per-frame N4 connected components of a multi-label
//    image (one union-find pass), the core of the spatial-connectedness
//    enforcement (reference tube analysis,
//    dense_segmentation_graph.h:666-904).
//  - rle_encode_rows: run-length extraction of a label image.
//
// Built as a plain shared library, bound via ctypes (no pybind11 in this
// image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// Union-find with path halving.
inline int32_t find(std::vector<int32_t>& parent, int32_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];
    x = parent[x];
  }
  return x;
}

inline void unite(std::vector<int32_t>& parent, int32_t a, int32_t b) {
  a = find(parent, a);
  b = find(parent, b);
  if (a != b) parent[b < a ? a : b] = (b < a ? b : a);
}

}  // namespace

extern "C" {

// labels: (h, w) int32 region labels.  comp out: (h, w) int32 component ids,
// compacted to [0, n_components), components never span different labels.
// Returns n_components.
int32_t multi_label_cc(const int32_t* labels, int32_t h, int32_t w,
                       int32_t* comp) {
  const int64_t n = static_cast<int64_t>(h) * w;
  std::vector<int32_t> parent(n);
  for (int64_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);

  for (int32_t y = 0; y < h; ++y) {
    const int32_t* row = labels + static_cast<int64_t>(y) * w;
    const int64_t base = static_cast<int64_t>(y) * w;
    for (int32_t x = 1; x < w; ++x) {
      if (row[x] == row[x - 1]) {
        unite(parent, static_cast<int32_t>(base + x),
              static_cast<int32_t>(base + x - 1));
      }
    }
    if (y > 0) {
      const int32_t* prev = labels + static_cast<int64_t>(y - 1) * w;
      for (int32_t x = 0; x < w; ++x) {
        if (row[x] == prev[x]) {
          unite(parent, static_cast<int32_t>(base + x),
                static_cast<int32_t>(base + x - w));
        }
      }
    }
  }

  // Compact roots to dense component ids.
  int32_t next = 0;
  std::vector<int32_t> comp_of(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t r = find(parent, static_cast<int32_t>(i));
    if (comp_of[r] < 0) comp_of[r] = next++;
    comp[i] = comp_of[r];
  }
  return next;
}

// Run-length encode a label image: for each run emit (label, y, left, right).
// out must have capacity 4 * max_runs int64; returns the number of runs, or
// -1 if capacity was insufficient.
int64_t rle_encode_rows(const int64_t* labels, int32_t h, int32_t w,
                        int64_t* out, int64_t max_runs) {
  int64_t runs = 0;
  for (int32_t y = 0; y < h; ++y) {
    const int64_t* row = labels + static_cast<int64_t>(y) * w;
    int32_t x = 0;
    while (x < w) {
      const int64_t v = row[x];
      int32_t start = x;
      while (x < w && row[x] == v) ++x;
      if (runs == max_runs) return -1;
      int64_t* rec = out + runs * 4;
      rec[0] = v;
      rec[1] = y;
      rec[2] = start;
      rec[3] = x - 1;
      ++runs;
    }
  }
  return runs;
}

// Trilinearly interpolated Lab color histograms per (window, region)
// (the reference's AddPixelInterpolated fill, histograms.cpp:142-199 /
// WindowedAppearanceDescriptor gains, region_descriptor.cpp:149-205).
//
// labels: (t*hw) int32 in [0, rcap); lab: (t*hw*3) uint8 Lab;
// gains: (t*3) float multipliers (nullptr-equivalent: pass all 1.0);
// win_slot: (t) int32 window slot per frame in [0, wcap).
// out: (wcap*rcap*nbins) float32, nbins = lum_bins*color_bins^2, zeroed by
// the caller.  Threads own disjoint label ranges, so all writes are
// race-free and the result is deterministic.
void accumulate_lab_hist(const int32_t* labels, const uint8_t* lab,
                         int32_t t, int64_t hw, int32_t rcap,
                         int32_t lum_bins, int32_t color_bins,
                         const float* gains, const int32_t* win_slot,
                         int32_t n_threads, float* out) {
  const int32_t nbins = lum_bins * color_bins * color_bins;
  const float sl = (lum_bins - 1) / 255.0f;
  const float sc = (color_bins - 1) / 255.0f;
  n_threads = std::max(1, std::min(n_threads, rcap));

  auto worker = [&](int32_t k) {
    const int32_t lo = static_cast<int32_t>(
        static_cast<int64_t>(rcap) * k / n_threads);
    const int32_t hi = static_cast<int32_t>(
        static_cast<int64_t>(rcap) * (k + 1) / n_threads);
    for (int32_t f = 0; f < t; ++f) {
      const float g0 = gains[f * 3 + 0], g1 = gains[f * 3 + 1],
                  g2 = gains[f * 3 + 2];
      const int64_t wbase =
          static_cast<int64_t>(win_slot[f]) * rcap * nbins;
      const int32_t* lrow = labels + static_cast<int64_t>(f) * hw;
      const uint8_t* crow = lab + static_cast<int64_t>(f) * hw * 3;
      for (int64_t i = 0; i < hw; ++i) {
        const int32_t r = lrow[i];
        if (r < lo || r >= hi) continue;
        const float l = std::min(255.0f, crow[i * 3 + 0] * g0) * sl;
        const float a = std::min(255.0f, crow[i * 3 + 1] * g1) * sc;
        const float b = std::min(255.0f, crow[i * 3 + 2] * g2) * sc;
        const int32_t l0 = static_cast<int32_t>(l), a0 =
            static_cast<int32_t>(a), b0 = static_cast<int32_t>(b);
        const float dl = l - l0, da = a - a0, db = b - b0;
        const int32_t l1 = l0 + (dl >= 1e-6f), a1 = a0 + (da >= 1e-6f),
                      b1 = b0 + (db >= 1e-6f);
        float* row = out + wbase + static_cast<int64_t>(r) * nbins;
        const float wl[2] = {1.0f - dl, dl};
        const float wa[2] = {1.0f - da, da};
        const float wb[2] = {1.0f - db, db};
        const int32_t li[2] = {l0, l1}, ai[2] = {a0, a1}, bi[2] = {b0, b1};
        for (int x = 0; x < 2; ++x)
          for (int y = 0; y < 2; ++y)
            for (int z = 0; z < 2; ++z)
              row[(li[x] * color_bins + ai[y]) * color_bins + bi[z]] +=
                  wl[x] * wa[y] * wb[z];
      }
    }
  };

  std::vector<std::thread> threads;
  for (int32_t k = 0; k < n_threads; ++k) threads.emplace_back(worker, k);
  for (auto& th : threads) th.join();
}

// Generic race-free weighted bincount: out[keys[i]] += weights[i].
// Threads own disjoint key ranges.  keys in [0, m).
void weighted_bincount(const int64_t* keys, const float* weights, int64_t n,
                       int64_t m, int32_t n_threads, float* out) {
  n_threads = std::max<int32_t>(
      1, static_cast<int32_t>(std::min<int64_t>(n_threads, m)));
  auto worker = [&](int32_t k) {
    const int64_t lo = m * k / n_threads;
    const int64_t hi = m * (k + 1) / n_threads;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t key = keys[i];
      if (key >= lo && key < hi) out[key] += weights[i];
    }
  };
  std::vector<std::thread> threads;
  for (int32_t k = 0; k < n_threads; ++k) threads.emplace_back(worker, k);
  for (auto& th : threads) th.join();
}

// Tube matching for spatial-connectedness enforcement
// (dense_segmentation_graph.h:735-742 semantics): link per-frame region
// components into tubes by centroid distance + area ratio against the
// previous frame's open tubes of the same region.
//
// Inputs are concatenated per-frame component tables (frame f's
// components occupy [offsets[f], offsets[f+1])): region id, area, raw
// centroid (cx, cy) and flow-advected match centroid (mx, my).
// Outputs: tube_of per component, and per-tube (region, area, count)
// tables (capacity = n_comps).  Returns the tube count.
int64_t link_tubes(const int64_t* region, const double* area,
                   const double* cx, const double* cy, const double* mx,
                   const double* my, const int64_t* offsets,
                   int32_t n_frames, double diag_thresh,
                   int64_t* tube_of, int64_t* tube_region,
                   double* tube_area, int64_t* tube_count) {
  struct Open {
    int64_t tube;
    double x, y, a;
  };
  // Open tubes of the previous frame, bucketed by region id.
  std::unordered_map<int64_t, std::vector<Open>> prev_tab, now_tab;
  int64_t n_tubes = 0;
  for (int32_t f = 0; f < n_frames; ++f) {
    now_tab.clear();
    for (int64_t ci = offsets[f]; ci < offsets[f + 1]; ++ci) {
      const int64_t r = region[ci];
      if (r < 0) {
        tube_of[ci] = -1;
        continue;
      }
      int64_t best = -1;
      double best_d = diag_thresh;
      auto it = prev_tab.find(r);
      if (it != prev_tab.end()) {
        for (const Open& o : it->second) {
          const double dx = mx[ci] - o.x, dy = my[ci] - o.y;
          const double d = std::sqrt(dx * dx + dy * dy);
          const double lo = std::min(area[ci], o.a);
          const double hi = std::max(std::max(area[ci], o.a), 1.0);
          if (d < best_d && lo / hi > 0.75) {
            best = o.tube;
            best_d = d;
          }
        }
      }
      if (best < 0) {
        best = n_tubes++;
        tube_region[best] = r;
        tube_area[best] = 0.0;
        tube_count[best] = 0;
      }
      tube_of[ci] = best;
      tube_area[best] += area[ci];
      tube_count[best] += 1;
      now_tab[r].push_back(Open{best, cx[ci], cy[ci], area[ci]});
    }
    std::swap(prev_tab, now_tab);
  }
  return n_tubes;
}

// Unique adjacent (a,b) region pairs (a<b) over a (t,h,w) int32 label
// volume: spatial N8 forward offsets within frames plus temporal identity
// — the same adjacency set as ops/rle.neighbor_pairs (the dominant subset
// of the reference's replayed edge set, segmentation_graph.h:466-496),
// fused into one pass instead of five full-volume NumPy traversals.
// Threads own disjoint frame ranges (temporal seam pairs belong to the
// earlier frame's thread); per-thread key vectors are locally
// deduplicated, merged, and globally deduplicated.  Writes packed
// (lo << 32 | hi) keys to out (capacity max_pairs); returns the unique
// pair count, or -1 if it exceeds max_pairs.
int64_t neighbor_pairs(const int32_t* labels, int32_t t, int32_t h,
                       int32_t w, int32_t n_threads, int64_t* out,
                       int64_t max_pairs) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  n_threads = std::max(1, std::min(n_threads, t));
  std::vector<std::vector<int64_t>> parts(n_threads);

  auto pack = [](int32_t a, int32_t b) -> int64_t {
    const int64_t lo = a < b ? a : b;
    const int64_t hi = a < b ? b : a;
    return (lo << 32) | hi;
  };

  auto worker = [&](int32_t k) {
    const int32_t f_lo = static_cast<int32_t>(
        static_cast<int64_t>(t) * k / n_threads);
    const int32_t f_hi = static_cast<int32_t>(
        static_cast<int64_t>(t) * (k + 1) / n_threads);
    std::vector<int64_t>& keys = parts[k];
    for (int32_t f = f_lo; f < f_hi; ++f) {
      const int32_t* fr = labels + f * hw;
      const int32_t* nxt = (f + 1 < t) ? fr + hw : nullptr;
      for (int32_t y = 0; y < h; ++y) {
        const int32_t* row = fr + static_cast<int64_t>(y) * w;
        const int32_t* below =
            (y + 1 < h) ? row + w : nullptr;
        const int32_t* trow =
            nxt ? nxt + static_cast<int64_t>(y) * w : nullptr;
        for (int32_t x = 0; x < w; ++x) {
          const int32_t c = row[x];
          if (x + 1 < w && row[x + 1] != c) keys.push_back(pack(c, row[x + 1]));
          if (below) {
            if (below[x] != c) keys.push_back(pack(c, below[x]));
            if (x + 1 < w && below[x + 1] != c)
              keys.push_back(pack(c, below[x + 1]));
            if (x > 0 && below[x - 1] != c)
              keys.push_back(pack(c, below[x - 1]));
          }
          if (trow && trow[x] != c) keys.push_back(pack(c, trow[x]));
        }
      }
    }
    std::sort(keys.begin(), keys.end());
    keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  };

  std::vector<std::thread> threads;
  for (int32_t k = 1; k < n_threads; ++k) threads.emplace_back(worker, k);
  worker(0);
  for (auto& th : threads) th.join();

  size_t total = 0;
  for (const auto& p : parts) total += p.size();
  std::vector<int64_t> merged;
  merged.reserve(total);
  for (const auto& p : parts) merged.insert(merged.end(), p.begin(), p.end());
  std::sort(merged.begin(), merged.end());
  merged.erase(std::unique(merged.begin(), merged.end()), merged.end());
  if (static_cast<int64_t>(merged.size()) > max_pairs) return -1;
  std::copy(merged.begin(), merged.end(), out);
  return static_cast<int64_t>(merged.size());
}

}  // extern "C"
