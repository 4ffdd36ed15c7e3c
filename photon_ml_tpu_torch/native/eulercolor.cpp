// Euler-split edge coloring for regular bipartite multigraphs.
//
// Used by photon_ml_tpu_torch/ops/routing.py to route static permutations through
// a radix-128 Clos/Benes network: a proper deg-edge-coloring of the
// (src-row, dst-row) incidence multigraph assigns each element an
// intermediate lane such that the permutation factors into
// (within-row shuffle) o (per-lane row movement) o (within-row shuffle).
//
// The reference framework has no analog (Spark shuffles move data by hash);
// this is TPU-native machinery: it turns arbitrary static gathers/scatters
// into dense lane-shuffle stages the VPU executes at vector speed.
//
// Algorithm: classic Euler-split halving. A multigraph where every node has
// even degree decomposes its edges into two halves, each regular of half
// degree: pair consecutive edges at every node (complete, since degrees are
// even), walk the resulting 2-regular "partner" cycles alternating between
// src-pairings and dst-pairings, and 2-color edges alternately along each
// cycle. Recursing log2(deg) times yields a proper deg-coloring. O(E log deg).
//
// Memory layout notes: edges are processed as contiguous class segments of
// one permuted id array (radix-sort style, no per-class allocations); all
// id arrays are int32 to halve the cache footprint of the pointer-chasing
// cycle walk, which is the runtime bottleneck.
//
// C ABI only (ctypes-friendly); no exceptions across the boundary.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Pair consecutive edges of ids[0..m) grouped by key (node id per edge).
// partner[e] = the other edge of e's pair at this node side. counts/order
// are caller-provided scratch (counts sized n_nodes+1, order sized >= m).
void pair_by_node(const int32_t* ids, int64_t m, const int32_t* key,
                  int32_t n_nodes, int64_t* counts, int32_t* order,
                  int32_t* partner) {
  std::memset(counts, 0, sizeof(int64_t) * (static_cast<size_t>(n_nodes) + 1));
  for (int64_t i = 0; i < m; ++i) counts[key[ids[i]] + 1]++;
  for (int32_t n = 0; n < n_nodes; ++n) counts[n + 1] += counts[n];
  for (int64_t i = 0; i < m; ++i) order[counts[key[ids[i]]]++] = ids[i];
  // Runs have even length, so consecutive pairs never cross a node boundary.
  for (int64_t i = 0; i < m; i += 2) {
    partner[order[i]] = order[i + 1];
    partner[order[i + 1]] = order[i];
  }
}

// One class segment at one level: pair on both sides, 2-color along the
// partner cycles, then stable-partition into next_ids at [lo, lo+m/2) /
// [lo+m/2, hi). Segments touch disjoint edge ids and disjoint output
// ranges, so segments at one level run on different threads with no
// synchronization beyond per-thread counts/order scratch. The coloring is
// deterministic regardless of thread schedule (each cycle walk starts from
// the lowest-position unvisited edge of its own segment).
void process_segment(const int32_t* seg, int64_t m, int64_t lo,
                     const int32_t* src, const int32_t* dst, int32_t n_src,
                     int32_t n_dst, int32_t cbit, int64_t* counts,
                     int32_t* order, int32_t* partner_src,
                     int32_t* partner_dst, uint8_t* state, int32_t* color,
                     int32_t* next_ids) {
  pair_by_node(seg, m, src, n_src, counts, order, partner_src);
  pair_by_node(seg, m, dst, n_dst, counts, order, partner_dst);
  for (int64_t i = 0; i < m; ++i) state[seg[i]] = 0;
  for (int64_t i = 0; i < m; ++i) {
    const int32_t e0 = seg[i];
    if (state[e0] & 1) continue;
    int32_t e = e0;
    uint8_t b = 0;
    bool via_src = true;
    do {
      state[e] = static_cast<uint8_t>(1 | (b << 1));
      e = via_src ? partner_src[e] : partner_dst[e];
      via_src = !via_src;
      b ^= 1;
    } while (e != e0);
  }
  // Alternating 2-coloring along even cycles puts exactly half each way.
  int64_t h0 = lo, h1 = lo + m / 2;
  for (int64_t i = 0; i < m; ++i) {
    const int32_t e = seg[i];
    if (state[e] & 2) {
      color[e] |= cbit;
      next_ids[h1++] = e;
    } else {
      next_ids[h0++] = e;
    }
  }
}

}  // namespace

extern "C" {

// Proper `deg`-edge-coloring of a bipartite multigraph in which every src
// node and every dst node has exactly `deg` incident edges. `deg` must be a
// power of two. Writes color[e] in [0, deg). Returns 0 on success.
int euler_color(int64_t n_edges, int32_t deg, const int32_t* src,
                const int32_t* dst, int32_t n_src, int32_t n_dst,
                int32_t* color) {
  if (deg <= 0 || (deg & (deg - 1)) != 0) return 1;
  if (n_edges != static_cast<int64_t>(n_src) * deg ||
      n_edges != static_cast<int64_t>(n_dst) * deg)
    return 2;
  if (n_edges > INT32_MAX) return 3;
  std::memset(color, 0, sizeof(int32_t) * static_cast<size_t>(n_edges));
  if (deg == 1) return 0;

  int32_t levels = 0;
  for (int32_t d = deg; d > 1; d >>= 1) levels++;

  const int32_t n_nodes_max = n_src > n_dst ? n_src : n_dst;
  std::vector<int32_t> ids(n_edges), next_ids(n_edges);
  std::vector<int32_t> partner_src(n_edges), partner_dst(n_edges);
  std::vector<uint8_t> state(n_edges);  // bit 0: visited, bit 1: color bit
  std::vector<int64_t> seg_starts{0}, next_starts;

  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  const size_t max_threads = n_edges >= (1 << 20) ? hw : 1;

  // Scratch for the sequential path, shared across levels/segments.
  std::vector<int64_t> counts(static_cast<size_t>(n_nodes_max) + 1);
  std::vector<int32_t> order(n_edges);

  for (int64_t e = 0; e < n_edges; ++e) ids[e] = static_cast<int32_t>(e);
  seg_starts.push_back(n_edges);

  for (int32_t level = 0; level < levels; ++level) {
    const size_t n_segs = seg_starts.size() - 1;
    const int32_t cbit = 1 << (levels - 1 - level);
    const size_t n_threads =
        n_segs < max_threads ? n_segs : max_threads;
    if (n_threads <= 1) {
      for (size_t s = 0; s < n_segs; ++s) {
        const int64_t lo = seg_starts[s], hi = seg_starts[s + 1];
        process_segment(ids.data() + lo, hi - lo, lo, src, dst, n_src, n_dst,
                        cbit, counts.data(), order.data(), partner_src.data(),
                        partner_dst.data(), state.data(), color,
                        next_ids.data());
      }
    } else {
      // Segments are independent (disjoint edges, disjoint output ranges):
      // farm them out with per-thread counts/order scratch.
      int64_t max_m = 0;
      for (size_t s = 0; s < n_segs; ++s) {
        const int64_t m = seg_starts[s + 1] - seg_starts[s];
        if (m > max_m) max_m = m;
      }
      std::atomic<size_t> next_seg{0};
      std::vector<std::thread> workers;
      workers.reserve(n_threads);
      for (size_t t = 0; t < n_threads; ++t) {
        workers.emplace_back([&]() {
          std::vector<int64_t> counts(static_cast<size_t>(n_nodes_max) + 1);
          std::vector<int32_t> order(static_cast<size_t>(max_m));
          for (;;) {
            const size_t s = next_seg.fetch_add(1);
            if (s >= n_segs) break;
            const int64_t lo = seg_starts[s], hi = seg_starts[s + 1];
            process_segment(ids.data() + lo, hi - lo, lo, src, dst, n_src,
                            n_dst, cbit, counts.data(), order.data(),
                            partner_src.data(), partner_dst.data(),
                            state.data(), color, next_ids.data());
          }
        });
      }
      for (auto& w : workers) w.join();
    }
    next_starts.clear();
    next_starts.reserve(2 * n_segs + 1);
    next_starts.push_back(0);
    for (size_t s = 0; s < n_segs; ++s) {
      const int64_t lo = seg_starts[s], hi = seg_starts[s + 1];
      next_starts.push_back(lo + (hi - lo) / 2);
      next_starts.push_back(hi);
    }
    ids.swap(next_ids);
    seg_starts.swap(next_starts);
  }
  return 0;
}

}  // extern "C"
