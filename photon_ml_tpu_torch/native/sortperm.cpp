// Threaded stable LSD radix argsort for non-negative int64 key pairs.
//
// The routing/tiling data prep (ops/sparse_perm.py, parallel/
// grid_features.py, data/random_effect.py) is dominated by np.lexsort over
// COO index pairs at 1e7-1e9 entries; numpy's lexsort is single-threaded
// comparison-ish sort. This is the native replacement: byte-wise LSD radix
// over only the bytes the key range actually uses, parallel histogram +
// stable per-thread scatter, sorting an index permutation (argsort) so the
// Python side can reorder any number of payload arrays.
//
// Contract (see photon_ml_tpu_torch/utils/nativesort.py):
//   argsort_pairs(n, hi, lo, out, n_threads) -> 0 on success
//   - keys must be non-negative; sort order = (hi, lo) lexicographic,
//     stable w.r.t. input order (ties keep original positions).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// One stable counting pass over 8-bit digits of key[idx_in[i]] >> shift.
void radix_pass(int64_t n, const int64_t* key, int shift,
                const int64_t* idx_in, int64_t* idx_out, int n_threads) {
  const int RADIX = 256;
  std::vector<std::vector<int64_t>> hist(
      (size_t)n_threads, std::vector<int64_t>(RADIX, 0));
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;

  for (int t = 0; t < n_threads; ++t) {
    ts.emplace_back([&, t]() {
      int64_t lo = t * chunk, hi2 = std::min(n, lo + chunk);
      auto& h = hist[(size_t)t];
      for (int64_t i = lo; i < hi2; ++i) {
        h[(key[idx_in[i]] >> shift) & 0xFF]++;
      }
    });
  }
  for (auto& th : ts) th.join();
  ts.clear();

  // exclusive prefix over (digit, thread): all smaller digits first, then
  // earlier threads of the same digit -> stable scatter
  std::vector<std::vector<int64_t>> offs(
      (size_t)n_threads, std::vector<int64_t>(RADIX, 0));
  int64_t run = 0;
  for (int d = 0; d < RADIX; ++d) {
    for (int t = 0; t < n_threads; ++t) {
      offs[(size_t)t][d] = run;
      run += hist[(size_t)t][d];
    }
  }

  for (int t = 0; t < n_threads; ++t) {
    ts.emplace_back([&, t]() {
      int64_t lo = t * chunk, hi2 = std::min(n, lo + chunk);
      auto& o = offs[(size_t)t];
      for (int64_t i = lo; i < hi2; ++i) {
        int64_t v = idx_in[i];
        int d = (int)((key[v] >> shift) & 0xFF);
        idx_out[o[d]++] = v;
      }
    });
  }
  for (auto& th : ts) th.join();
}

int significant_bytes(int64_t n, const int64_t* key, int n_threads) {
  std::vector<int64_t> maxes((size_t)n_threads, 0);
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    ts.emplace_back([&, t]() {
      int64_t lo = t * chunk, hi2 = std::min(n, lo + chunk), m = 0;
      for (int64_t i = lo; i < hi2; ++i)
        if (key[i] > m) m = key[i];
      maxes[(size_t)t] = m;
    });
  }
  for (auto& th : ts) th.join();
  int64_t m = 0;
  for (auto v : maxes)
    if (v > m) m = v;
  int bytes = 0;
  while (m > 0) {
    ++bytes;
    m >>= 8;
  }
  return bytes;
}

}  // namespace

namespace {

int significant_bits(int64_t n, const int64_t* key, int n_threads) {
  int bytes = significant_bytes(n, key, n_threads);
  return 8 * bytes;  // byte granularity is enough for pass counting below
}

// One stable pass over 8-bit digits of packed keys, carrying (key, idx)
// together: sequential reads, no random gather through the permutation.
void packed_pass(int64_t n, const uint64_t* key_in, const int64_t* idx_in,
                 uint64_t* key_out, int64_t* idx_out, int shift,
                 int n_threads) {
  const int RADIX = 256;
  std::vector<std::vector<int64_t>> hist(
      (size_t)n_threads, std::vector<int64_t>(RADIX, 0));
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;

  for (int t = 0; t < n_threads; ++t) {
    ts.emplace_back([&, t]() {
      int64_t lo = t * chunk, hi2 = std::min(n, lo + chunk);
      auto& h = hist[(size_t)t];
      for (int64_t i = lo; i < hi2; ++i) h[(key_in[i] >> shift) & 0xFF]++;
    });
  }
  for (auto& th : ts) th.join();
  ts.clear();

  std::vector<std::vector<int64_t>> offs(
      (size_t)n_threads, std::vector<int64_t>(RADIX, 0));
  int64_t run = 0;
  for (int d = 0; d < RADIX; ++d) {
    for (int t = 0; t < n_threads; ++t) {
      offs[(size_t)t][d] = run;
      run += hist[(size_t)t][d];
    }
  }

  for (int t = 0; t < n_threads; ++t) {
    ts.emplace_back([&, t]() {
      int64_t lo = t * chunk, hi2 = std::min(n, lo + chunk);
      auto& o = offs[(size_t)t];
      for (int64_t i = lo; i < hi2; ++i) {
        int d = (int)((key_in[i] >> shift) & 0xFF);
        int64_t pos = o[d]++;
        key_out[pos] = key_in[i];
        idx_out[pos] = idx_in[i];
      }
    });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// Stable argsort of (hi, lo) pairs, non-negative int64 keys. out must hold
// n int64. Returns 0 on success, nonzero on bad arguments.
int argsort_pairs(int64_t n, const int64_t* hi, const int64_t* lo,
                  int64_t* out, int n_threads) {
  if (n < 0 || n_threads < 1) return 1;
  if (n == 0) return 0;

  int bits_hi = significant_bits(n, hi, n_threads);
  int bits_lo = lo ? significant_bits(n, lo, n_threads) : 0;

  if (bits_hi + bits_lo <= 63) {
    // packed path: one combined key, (key, idx) carried together through
    // every pass — all sequential reads
    std::vector<uint64_t> ka((size_t)n), kb((size_t)n);
    std::vector<int64_t> ia((size_t)n), ib((size_t)n);
    {
      std::vector<std::thread> ts;
      int64_t chunk = (n + n_threads - 1) / n_threads;
      for (int t = 0; t < n_threads; ++t) {
        ts.emplace_back([&, t]() {
          int64_t s = t * chunk, e = std::min(n, s + chunk);
          for (int64_t i = s; i < e; ++i) {
            ka[(size_t)i] =
                ((uint64_t)hi[i] << bits_lo) | (lo ? (uint64_t)lo[i] : 0);
            ia[(size_t)i] = i;
          }
        });
      }
      for (auto& th : ts) th.join();
    }
    uint64_t* kc = ka.data();
    uint64_t* kn = kb.data();
    int64_t* ic = ia.data();
    int64_t* in_ = ib.data();
    int total_bytes = (bits_hi + bits_lo + 7) / 8;
    for (int b = 0; b < total_bytes; ++b) {
      packed_pass(n, kc, ic, kn, in_, 8 * b, n_threads);
      std::swap(kc, kn);
      std::swap(ic, in_);
    }
    std::memcpy(out, ic, (size_t)n * sizeof(int64_t));
    return 0;
  }

  // wide-key fallback: sort the permutation with indirect key reads
  std::vector<int64_t> tmp((size_t)n);
  int64_t* cur = out;
  int64_t* nxt = tmp.data();
  for (int64_t i = 0; i < n; ++i) cur[i] = i;
  for (const int64_t* key : {lo, hi}) {
    if (key == nullptr) continue;
    int bytes = significant_bytes(n, key, n_threads);
    for (int b = 0; b < bytes; ++b) {
      radix_pass(n, key, 8 * b, cur, nxt, n_threads);
      std::swap(cur, nxt);
    }
  }
  if (cur != out) std::memcpy(out, cur, (size_t)n * sizeof(int64_t));
  return 0;
}
}
