// Native host-runtime helpers for graphembedding.
//
// The device compute path is JAX/XLA/Pallas; these routines cover the
// host-side preprocessing hot spots (SURVEY.md §3.2's "delegated native
// components" table): per-row alias-table construction over a CSR and the
// struc2vec DTW ground-distance DP. Plain C ABI, consumed via ctypes.

#include <algorithm>
#include <deque>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Walker alias-method construction for every CSR row at once.
// row_ptr: [n_rows+1]; weights: [row_ptr[n_rows]] (unnormalized).
// Outputs accept (float32) and alias (int32, local slot ids), flat-aligned
// with `weights`.
void build_row_alias(const int64_t* row_ptr, int64_t n_rows,
                     const double* weights, float* accept, int32_t* alias) {
  std::vector<double> area;
  std::vector<int32_t> small_stack, large_stack;
  for (int64_t v = 0; v < n_rows; ++v) {
    const int64_t s = row_ptr[v], e = row_ptr[v + 1];
    const int64_t n = e - s;
    if (n <= 0) continue;
    double total = 0.0;
    for (int64_t i = s; i < e; ++i) total += weights[i];
    area.resize(n);
    if (total <= 0.0) {
      std::fill(area.begin(), area.end(), 1.0);
    } else {
      const double scale = static_cast<double>(n) / total;
      for (int64_t i = 0; i < n; ++i) area[i] = weights[s + i] * scale;
    }
    small_stack.clear();
    large_stack.clear();
    for (int64_t i = 0; i < n; ++i) {
      if (area[i] < 1.0)
        small_stack.push_back(static_cast<int32_t>(i));
      else
        large_stack.push_back(static_cast<int32_t>(i));
      accept[s + i] = 1.0f;
      alias[s + i] = 0;
    }
    while (!small_stack.empty() && !large_stack.empty()) {
      const int32_t sm = small_stack.back();
      small_stack.pop_back();
      const int32_t lg = large_stack.back();
      large_stack.pop_back();
      accept[s + sm] = static_cast<float>(area[sm]);
      alias[s + sm] = lg;
      area[lg] -= (1.0 - area[sm]);
      if (area[lg] < 1.0)
        small_stack.push_back(lg);
      else
        large_stack.push_back(lg);
    }
    // leftovers (numerical) keep accept = 1.0
  }
}

// Exact DTW with the struc2vec ground cost.
// opt1 != 0: sequences are flattened (degree, count) pairs, length = 2*n,
//   cost = (max/min - 1) * max(count_a, count_b)   [reference cost_max]
// opt1 == 0: plain degree sequences, cost = max/min - 1.
double dtw_rle(const double* a, int64_t na, const double* b, int64_t nb,
               int32_t opt1) {
  const int64_t n = opt1 ? na / 2 : na;
  const int64_t m = opt1 ? nb / 2 : nb;
  if (n == 0 || m == 0) return 0.0;
  const double INF = 1e300;
  std::vector<double> prev(m + 1, INF), cur(m + 1, INF);
  prev[0] = 0.0;
  for (int64_t i = 1; i <= n; ++i) {
    cur[0] = INF;
    const double ad = opt1 ? a[2 * (i - 1)] : a[i - 1];
    const double ac = opt1 ? a[2 * (i - 1) + 1] : 1.0;
    for (int64_t j = 1; j <= m; ++j) {
      const double bd = opt1 ? b[2 * (j - 1)] : b[j - 1];
      const double bc = opt1 ? b[2 * (j - 1) + 1] : 1.0;
      const double mx = std::max(ad, bd);
      const double mn = std::max(std::min(ad, bd), 1e-12);
      double c = mx / mn - 1.0;
      if (opt1) c *= std::max(ac, bc);
      const double best =
          std::min(prev[j], std::min(cur[j - 1], prev[j - 1]));
      cur[j] = c + best;
    }
    std::swap(prev, cur);
  }
  return prev[m];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Struc2Vec context-graph pipeline: BFS ring degree lists (opt1 RLE) +
// cumulative DTW structural distances for a given pair list.
// Reference counterpart: `ge/models/struc2vec.py —
// _compute_ordered_degreelist / _compute_structural_distance [U]`,
// which the Python fallback reproduces; this native path makes
// wiki-scale struc2vec preprocessing seconds instead of hours.
// ---------------------------------------------------------------------------

namespace {

// Per-node BFS producing, per layer, run-length-encoded sorted degree
// sequences: pairs (degree, count).
struct DegreeLists {
  // flat storage: for node v, layer k: rle pairs in
  // data[offsets[v][k] .. offsets[v][k+1])  (even = degree, odd = count)
  std::vector<std::vector<std::vector<double>>> per_node;  // [V][layers][2m]
};

double dtw_rle_pairs(const double* a, int64_t na2, const double* b,
                     int64_t nb2) {
  const int64_t n = na2 / 2, m = nb2 / 2;
  if (n == 0 || m == 0) return 0.0;
  const double INF = 1e300;
  std::vector<double> prev(m + 1, INF), cur(m + 1, INF);
  prev[0] = 0.0;
  for (int64_t i = 1; i <= n; ++i) {
    cur[0] = INF;
    const double ad = a[2 * (i - 1)], ac = a[2 * (i - 1) + 1];
    for (int64_t j = 1; j <= m; ++j) {
      const double bd = b[2 * (j - 1)], bc = b[2 * (j - 1) + 1];
      const double mx = std::max(ad, bd);
      const double mn = std::max(std::min(ad, bd), 1e-12);
      const double c = (mx / mn - 1.0) * std::max(ac, bc);
      cur[j] = c + std::min(prev[j], std::min(cur[j - 1], prev[j - 1]));
    }
    std::swap(prev, cur);
  }
  return prev[m];
}

// ---------------------------------------------------------------------------
// fastdtw (Salvador & Chan 2007) over RLE (degree, count) sequences — the
// approximation the reference ACTUALLY computes
// (`ge/models/struc2vec.py — fastdtw(..., radius=1, dist=cost_max) [U]`).
// Recursion: componentwise half-reduction (odd tail dropped, matching the
// pip package's __reduce_by_half), solve coarse, expand the coarse warp
// path by `radius` and double it into a per-row window, solve fine DTW
// constrained to the window. O(max(n, m) * radius) per level.
// ---------------------------------------------------------------------------

struct Band {
  int64_t lo, hi;  // inclusive 1-based j range for one row
};

double cost_rle(double ad, double ac, double bd, double bc) {
  const double mx = std::max(ad, bd);
  const double mn = std::max(std::min(ad, bd), 1e-12);
  return (mx / mn - 1.0) * std::max(ac, bc);
}

// DTW restricted to per-row windows; optionally emits the warp path.
// Scratch is THREAD_LOCAL flat storage reused across calls: the first
// nested-vector form paid ~n heap allocations per call, and at 3.3M
// pairs x 9 layers x recursion levels the allocator — not the DP —
// dominated the 100k-node build.
double dtw_windowed(const double* a, int64_t n, const double* b, int64_t m,
                    const std::vector<Band>& band,
                    std::vector<std::pair<int64_t, int64_t>>* path_out) {
  const double INF = 1e300;
  thread_local std::vector<double> vals;   // rows packed back to back
  thread_local std::vector<int64_t> off;   // row i values start
  thread_local std::vector<Band> bd;
  bd.assign(1, Band{0, 0});
  bd.insert(bd.end(), band.begin(), band.end());
  off.assign(n + 2, 0);
  off[1] = 1;
  for (int64_t i = 1; i <= n; ++i)
    off[i + 1] = off[i] + (bd[i].hi - bd[i].lo + 1);
  vals.assign(off[n + 1], INF);
  vals[0] = 0.0;
  auto get = [&](int64_t i, int64_t j) -> double {
    if (i < 0 || j < bd[i].lo || j > bd[i].hi) return INF;
    return vals[off[i] + (j - bd[i].lo)];
  };
  for (int64_t i = 1; i <= n; ++i) {
    const double ad = a[2 * (i - 1)], ac = a[2 * (i - 1) + 1];
    for (int64_t j = std::max<int64_t>(bd[i].lo, 1); j <= bd[i].hi; ++j) {
      const double best = std::min(
          get(i - 1, j), std::min(get(i, j - 1), get(i - 1, j - 1)));
      if (best < INF)
        vals[off[i] + (j - bd[i].lo)] =
            cost_rle(ad, ac, b[2 * (j - 1)], b[2 * (j - 1) + 1]) + best;
    }
  }
  const double res = get(n, m);
  if (path_out) {
    path_out->clear();
    int64_t i = n, j = m;
    while (i >= 1 && j >= 1) {
      path_out->push_back({i, j});
      if (i == 1 && j == 1) break;
      const double d0 = get(i - 1, j - 1);
      const double d1 = get(i - 1, j);
      const double d2 = get(i, j - 1);
      if (d0 <= d1 && d0 <= d2) {
        --i;
        --j;
      } else if (d1 <= d2) {
        --i;
      } else {
        --j;
      }
    }
    std::reverse(path_out->begin(), path_out->end());
  }
  return res;
}

// Per-recursion-level scratch reused across ALL calls on a thread:
// the naive form allocated ~5 vectors per level per call, and at 3.3M
// pairs x 9 layers the allocator dominated the whole 100k-node build.
struct FastDtwScratch {
  std::vector<double> ha, hb;
  std::vector<std::pair<int64_t, int64_t>> cpath;
  std::vector<Band> coarse, band;
};

double fastdtw_rec(const double* a, int64_t n, const double* b, int64_t m,
                   int64_t radius,
                   std::vector<std::pair<int64_t, int64_t>>* path_out,
                   int depth) {
  if (n == 0 || m == 0) return 0.0;
  // deque: growth by a DEEPER recursive call must not invalidate this
  // frame's reference (vector::resize would)
  thread_local std::deque<FastDtwScratch> pool;
  while (static_cast<int>(pool.size()) <= depth) pool.emplace_back();
  FastDtwScratch& S = pool[depth];
  if (n <= radius + 2 || m <= radius + 2) {
    S.band.assign(n, Band{1, m});
    return dtw_windowed(a, n, b, m, S.band, path_out);
  }
  S.ha.clear();
  S.hb.clear();
  for (int64_t i = 0; 2 * i + 1 < n; ++i) {
    S.ha.push_back((a[4 * i] + a[4 * i + 2]) / 2.0);
    S.ha.push_back((a[4 * i + 1] + a[4 * i + 3]) / 2.0);
  }
  for (int64_t j = 0; 2 * j + 1 < m; ++j) {
    S.hb.push_back((b[4 * j] + b[4 * j + 2]) / 2.0);
    S.hb.push_back((b[4 * j + 1] + b[4 * j + 3]) / 2.0);
  }
  const int64_t cn = static_cast<int64_t>(S.ha.size()) / 2;
  const int64_t cm = static_cast<int64_t>(S.hb.size()) / 2;
  fastdtw_rec(S.ha.data(), cn, S.hb.data(), cm, radius, &S.cpath,
              depth + 1);
  // coarse path (+radius) -> per-coarse-row j ranges -> doubled fine bands
  S.coarse.assign(cn, Band{cm + 1, 0});  // empty
  for (const auto& ij : S.cpath) {
    const int64_t rlo = std::max<int64_t>(ij.first - radius, 1);
    const int64_t rhi = std::min<int64_t>(ij.first + radius, cn);
    for (int64_t i = rlo; i <= rhi; ++i) {
      Band& c = S.coarse[i - 1];
      const int64_t jlo = std::max<int64_t>(ij.second - radius, 1);
      const int64_t jhi = std::min<int64_t>(ij.second + radius, cm);
      if (c.lo > c.hi) {
        c = {jlo, jhi};
      } else {
        c.lo = std::min(c.lo, jlo);
        c.hi = std::max(c.hi, jhi);
      }
    }
  }
  S.band.resize(n);
  for (int64_t i = 1; i <= n; ++i) {
    const int64_t ci = std::min((i + 1) / 2, cn);  // owning coarse row
    const Band& c = S.coarse[ci - 1];
    S.band[i - 1] = {std::max<int64_t>(2 * c.lo - 1, 1),
                     std::min<int64_t>(2 * c.hi, m)};
  }
  // repair connectivity the odd-tail drop / rounding can break:
  // row 1 reachable from (0,0); (n, m) reachable; consecutive rows
  // overlap enough for the {down, right, diag} moves. Widening only.
  S.band[0].lo = 1;
  S.band[n - 1].hi = m;
  for (int64_t i = 1; i < n; ++i) {
    if (S.band[i].lo > S.band[i - 1].hi + 1)
      S.band[i].lo = S.band[i - 1].hi + 1;
    if (S.band[i].hi < S.band[i - 1].hi) S.band[i].hi = S.band[i - 1].hi;
  }
  return dtw_windowed(a, n, b, m, S.band, path_out);
}

double fastdtw_rle_pairs(const double* a, int64_t na2, const double* b,
                         int64_t nb2, int64_t radius) {
  return fastdtw_rec(a, na2 / 2, b, nb2 / 2, radius, nullptr, 0);
}

}  // namespace

extern "C" {

// fastdtw (radius r) over flattened RLE (degree, count) pairs — the
// struc2vec cost; standalone export for oracle tests against dtw_rle.
double fastdtw_rle(const double* a, int64_t na2, const double* b,
                   int64_t nb2, int64_t radius) {
  return fastdtw_rle_pairs(a, na2, b, nb2, radius);
}

// Compute cumulative struc2vec distances for `n_pairs` (u, v) pairs.
// CSR must be the SYMMETRIZED adjacency. Writes, for each pair, the
// cumulative layer distances into out_dist[p * max_layers + k]
// (untouched layers stay at -1) and the number of common layers into
// out_nlayers[p]. opt1 (RLE) semantics always on (reference default).
// n_threads: worker threads for the (independent) per-root BFS and
// per-pair DTW loops; <= 1 runs single-threaded. This is where the
// reference's `workers=N` lands (its joblib pool did the same job).
// dtw_mode: 0 = exact O(nm) DP; 1 = fastdtw radius=1 (the reference's
// actual computation — `fastdtw(..., radius=1) [U]`; O(n) banded).
// early_stop: stop a pair's (cumulative, non-decreasing) layer loop
// once acc >= early_stop — its context-edge weights exp(-f) are
// already below f32 resolution for every deeper layer, and the deep
// layers are exactly where rings are big and DTW expensive. <= 0
// disables.
void struc2vec_distances(const int64_t* row_ptr, const int64_t* col_idx,
                         int64_t num_nodes, const int64_t* pu,
                         const int64_t* pv, int64_t n_pairs,
                         int64_t max_layers, double* out_dist,
                         int64_t* out_nlayers, int64_t n_threads,
                         int32_t dtw_mode, double early_stop) {
  // degrees
  std::vector<int64_t> deg(num_nodes);
  for (int64_t v = 0; v < num_nodes; ++v)
    deg[v] = row_ptr[v + 1] - row_ptr[v];

  if (n_threads < 1) n_threads = 1;
  const int64_t nt_bfs =
      std::min<int64_t>(n_threads, std::max<int64_t>(num_nodes, 1));

  // BFS degree lists for every node, roots striped across threads.
  // `visited[x] == root` marks x visited in the current BFS (epoch
  // trick, no per-root reset); each thread owns its scratch vectors.
  //
  // Storage is a per-node FLAT uint32 arena, not nested vectors:
  // [n_layers][len0][d,c,d,c,...][len1][...] — lengths in RLE *pairs*.
  // At 100k nodes full depth the nested double form peaked ~3 GB of
  // host RSS (host RAM, not device memory, was the struc2vec scale
  // ceiling); uint32 + one allocation per node is ~3-4x smaller
  // (degrees and counts are < 2^32 by construction: bounded by V).
  std::vector<std::vector<uint32_t>> lists(num_nodes);
  int64_t max_deg = 0;
  for (int64_t v = 0; v < num_nodes; ++v) max_deg = std::max(max_deg, deg[v]);
  auto bfs_range = [&](int64_t lo, int64_t hi) {
    std::vector<int64_t> frontier, next;
    std::vector<int64_t> visited(num_nodes, -1);
    std::vector<uint32_t> buf;
    // ring -> sorted RLE via a degree HISTOGRAM with sparse reset:
    // O(ring + distinct log distinct) per ring instead of sorting the
    // whole ring (full-depth rings sum to ~V elements per ROOT, so
    // std::sort was ~V log V * V total — measured as the dominant cost
    // of the 100k-node build, not the DTW)
    std::vector<int64_t> hist(max_deg + 1, 0);
    std::vector<int64_t> touched;
    for (int64_t root = lo; root < hi; ++root) {
      frontier.assign(1, root);
      visited[root] = root;
      buf.assign(1, 0);  // [0] = layer count, patched at the end
      uint32_t n_layers = 0;
      for (int64_t layer = 0; layer < max_layers && !frontier.empty();
           ++layer) {
        touched.clear();
        for (int64_t v : frontier) {
          if (hist[deg[v]]++ == 0) touched.push_back(deg[v]);
        }
        std::sort(touched.begin(), touched.end());
        const size_t len_slot = buf.size();
        buf.push_back(0);
        for (int64_t d : touched) {
          buf.push_back(static_cast<uint32_t>(d));
          buf.push_back(static_cast<uint32_t>(hist[d]));
          hist[d] = 0;
        }
        buf[len_slot] = static_cast<uint32_t>(touched.size());
        ++n_layers;
        next.clear();
        for (int64_t v : frontier) {
          for (int64_t e = row_ptr[v]; e < row_ptr[v + 1]; ++e) {
            const int64_t u = col_idx[e];
            if (visited[u] != root) {
              visited[u] = root;
              next.push_back(u);
            }
          }
        }
        frontier.swap(next);
      }
      buf[0] = n_layers;
      lists[root].assign(buf.begin(), buf.end());
      lists[root].shrink_to_fit();
    }
  };
  if (nt_bfs <= 1) {
    bfs_range(0, num_nodes);
  } else {
    std::vector<std::thread> ts;
    const int64_t chunk = (num_nodes + nt_bfs - 1) / nt_bfs;
    for (int64_t t = 0; t < nt_bfs; ++t) {
      const int64_t lo = t * chunk;
      const int64_t hi = std::min(num_nodes, lo + chunk);
      if (lo < hi) ts.emplace_back(bfs_range, lo, hi);
    }
    for (auto& th : ts) th.join();
  }

  // pair distances, cumulative over layers; pairs striped across
  // threads (each pair writes disjoint output rows). Arena layers are
  // converted to the DTW kernels' double layout in per-thread scratch
  // (O(len) copy vs the DTW's O(len * band) work).
  auto pair_range = [&](int64_t lo, int64_t hi) {
    std::vector<double> sa, sb;
    for (int64_t p = lo; p < hi; ++p) {
      const uint32_t* au = lists[pu[p]].data();
      const uint32_t* av = lists[pv[p]].data();
      const int64_t common = std::min<int64_t>(
          std::min<int64_t>(au[0], av[0]), max_layers);
      out_nlayers[p] = common;
      double acc = 0.0;
      const uint32_t* cu = au + 1;
      const uint32_t* cv = av + 1;
      for (int64_t k = 0; k < common; ++k) {
        if (early_stop > 0.0 && acc >= early_stop) {
          out_nlayers[p] = k;
          break;
        }
        const int64_t nu2 = 2 * static_cast<int64_t>(*cu++);
        const int64_t nv2 = 2 * static_cast<int64_t>(*cv++);
        sa.assign(cu, cu + nu2);
        sb.assign(cv, cv + nv2);
        cu += nu2;
        cv += nv2;
        const double d =
            dtw_mode == 1
                ? fastdtw_rle_pairs(sa.data(), nu2, sb.data(), nv2,
                                    /*radius=*/1)
                : dtw_rle_pairs(sa.data(), nu2, sb.data(), nv2);
        acc += d;
        out_dist[p * max_layers + k] = acc;
      }
    }
  };
  const int64_t nt_pair =
      std::min<int64_t>(n_threads, std::max<int64_t>(n_pairs, 1));
  if (nt_pair <= 1) {
    pair_range(0, n_pairs);
  } else {
    std::vector<std::thread> ts;
    const int64_t chunk = (n_pairs + nt_pair - 1) / nt_pair;
    for (int64_t t = 0; t < nt_pair; ++t) {
      const int64_t lo = t * chunk;
      const int64_t hi = std::min(n_pairs, lo + chunk);
      if (lo < hi) ts.emplace_back(pair_range, lo, hi);
    }
    for (auto& th : ts) th.join();
  }
}

}  // extern "C"
