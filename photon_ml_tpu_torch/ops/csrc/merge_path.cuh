// A merge-path segmented sum over a compressed sparse matrix, shared by the
// CSC rmatvec (spmv_t.cu) and the CSR matvec (spmv.cu):
//   out[i] = sum over segment i's nonzeros p of term(vals[p], idx[p])
// for segments given by ptr (int64 [m+1]: columns of the CSC copy, rows of
// the CSR copy), idx int32 [nnz] and vals f32 [nnz], both 16-byte aligned.
// The term rule (a struct) gathers the dense operand at idx[p] and combines
// it with the stored value, so one template serves every payload.
//
// Segment lengths are skewed (an intercept column holds every row; a hot
// row may hold thousands of nonzeros while most hold a few), so the work is
// balanced by a merge path, as CUB splits CSR SpMV:
//   * the work list is the merge of the segment ends (m items) and the
//     nonzeros (nnz items); CTA b takes items [kItems b, kItems (b+1)),
//     from the coordinate (segments ended, nonzeros taken) that the wrapper
//     finds once a matrix by a binary search on the device
//     (fused_perm.merge_path_split) and caches. The split depends only on
//     ptr, so the order of every sum is fixed;
//   * the CTA loads its segment ends (coalesced) and its nonzeros with
//     16-byte loads of idx and vals, issues all their gathers at once, and
//     stages the terms in shared memory;
//   * each thread walks kItemsPerThread items of the merged list in order,
//     finishing the segments that end there, and a fixed-order segmented
//     scan over the threads adds the parts of a segment that several
//     threads share. The CTA then writes every segment that ends in its
//     share, an empty segment's 0 included, with coalesced stores;
//   * the segment still open at the CTA's end goes to a carry array (its
//     index, its partial sum). A second kernel adds the carries of each
//     segment into out, kCarryThreads carries a CTA, by the same segmented
//     scan in CTA order; a segment open across the end of its carries
//     leaves a carry for another round of the same kernel.
// No atomics: two calls give bitwise-equal results, which the
// coordinate-descent schedule relies on, and the grid (one CTA a share)
// does not depend on the card. The kernels allocate nothing and run on the
// caller's stream.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace merge_path {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 8;
constexpr int kItems = kThreads * kItemsPerThread;
constexpr int kCarryThreads = 1024;

// Inclusive scan of val over the CTA's threads, segmented by key (keys
// non-decreasing in thread order): each thread gets the sum of the vals of
// the threads up to itself that share its key, added earlier-first in a
// fixed order (a butterfly of shuffles in each warp, then the warps'
// totals). s_key / s_val hold one entry a warp.
template <int kBlock>
__device__ __forceinline__ float segmented_scan(int key, float val, int* s_key, float* s_val) {
  constexpr int kWarpsInBlock = kBlock / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const int k = __shfl_up_sync(0xffffffffu, key, offset);
    const float v = __shfl_up_sync(0xffffffffu, val, offset);
    if (lane >= offset && k == key) {
      val = v + val;
    }
  }
  if (lane == 31) {
    s_key[warp] = key;
    s_val[warp] = val;
  }
  __syncthreads();
  if (warp == 0) {
    int wk = lane < kWarpsInBlock ? s_key[lane] : INT_MAX;
    float wv = lane < kWarpsInBlock ? s_val[lane] : 0.0f;
#pragma unroll
    for (int offset = 1; offset < kWarpsInBlock; offset <<= 1) {
      const int k = __shfl_up_sync(0xffffffffu, wk, offset);
      const float v = __shfl_up_sync(0xffffffffu, wv, offset);
      if (lane >= offset && k == wk) {
        wv = v + wv;
      }
    }
    if (lane < kWarpsInBlock) {
      s_val[lane] = wv;
    }
  }
  __syncthreads();
  if (warp > 0 && s_key[warp - 1] == key) {
    val = s_val[warp - 1] + val;
  }
  return val;
}

// Term: term.gather(idx) loads the dense operand's entry, term(v, g)
// combines it with the stored value v into the nonzero's term.
template <typename Term>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const int64_t* __restrict__ ptr, const int32_t* __restrict__ idx,
             const float* __restrict__ vals, Term term, float* __restrict__ out,
             const int64_t* __restrict__ split_seg, const int64_t* __restrict__ split_nz,
             int32_t* __restrict__ carry_key, float* __restrict__ carry_val, int64_t nnz) {
  // the CTA's segment ends (relative to j0) in [0, n_seg), then its terms
  __shared__ int32_t s_items[kItems];
  __shared__ float s_out[kItems];
  __shared__ int s_scan_key[kThreads / 32];
  __shared__ float s_scan_val[kThreads / 32];
  __shared__ float s_incl[kThreads];
  const int tid = threadIdx.x;
  const int64_t i0 = split_seg[blockIdx.x];
  const int64_t j0 = split_nz[blockIdx.x];
  const int64_t j1 = split_nz[blockIdx.x + 1];
  const int n_seg = static_cast<int>(split_seg[blockIdx.x + 1] - i0);
  const int n_nz = static_cast<int>(j1 - j0);
  int32_t* s_end = s_items;
  float* s_term = reinterpret_cast<float*>(s_items + n_seg);

  for (int x = tid; x < n_seg; x += kThreads) {
    s_end[x] = static_cast<int32_t>(ptr[i0 + 1 + x] - j0);
  }
  // the nonzeros in aligned groups of 4: 16-byte loads, then every gather
  // of the group at once
  for (int64_t p = (j0 & ~int64_t{3}) + 4 * tid; p < j1; p += 4 * kThreads) {
    int32_t r[4];
    float v[4];
    if (p + 4 <= nnz) {
      const int4 r4 = *reinterpret_cast<const int4*>(idx + p);
      const float4 v4 = *reinterpret_cast<const float4*>(vals + p);
      r[0] = r4.x, r[1] = r4.y, r[2] = r4.z, r[3] = r4.w;
      v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        r[e] = p + e < nnz ? idx[p + e] : 0;
        v[e] = p + e < nnz ? vals[p + e] : 0.0f;
      }
    }
    float g[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      g[e] = p + e >= j0 && p + e < j1 ? term.gather(r[e]) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (p + e >= j0 && p + e < j1) {
        s_term[p + e - j0] = term(v[e], g[e]);
      }
    }
  }
  __syncthreads();

  // this thread's share of the merged list: find its start by a binary
  // search on its diagonal, then walk it in order
  const int total = n_seg + n_nz;
  const int diag = min(tid * kItemsPerThread, total);
  const int diag_end = min(diag + kItemsPerThread, total);
  int lo = max(0, diag - n_nz);
  int hi = min(diag, n_seg);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] <= diag - mid - 1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int x = lo;
  int y = diag - lo;
  float running = 0.0f;
  int first_x = -1;
  float first_sum = 0.0f;
  for (int k = diag; k < diag_end; ++k) {
    if (x < n_seg && s_end[x] <= y) {  // segment i0 + x ends here
      if (first_x < 0) {
        first_x = x;
        first_sum = running;
      } else {
        s_out[x] = running;
      }
      running = 0.0f;
      ++x;
    } else {
      running += s_term[y];
      ++y;
    }
  }
  // the first segment a thread ends may have begun in earlier threads: add
  // their parts (the CTA's earlier share of a segment that began in an
  // earlier CTA comes through the carries)
  s_incl[tid] = segmented_scan<kThreads>(x, running, s_scan_key, s_scan_val);
  __syncthreads();
  if (first_x >= 0) {
    s_out[first_x] = (tid > 0 ? s_incl[tid - 1] : 0.0f) + first_sum;
  }
  __syncthreads();
  for (int i = tid; i < n_seg; i += kThreads) {
    out[i0 + i] = s_out[i];
  }
  if (tid == kThreads - 1) {
    carry_key[blockIdx.x] = static_cast<int32_t>(i0 + n_seg);
    carry_val[blockIdx.x] = s_incl[tid];
  }
}

// One round of carries: for each segment, the sum of its carries in this
// CTA (in order) is added into out where its run of carries ends; a run
// open at the CTA's last carry leaves the CTA's carry for the next round
// (else the CTA's carry is 0). Keys of m or more (the segment past the
// last) are no segment.
__global__ void __launch_bounds__(kCarryThreads)
carry_kernel(const int32_t* __restrict__ key_in, const float* __restrict__ val_in,
             int64_t count, float* __restrict__ out, int64_t m, int32_t* __restrict__ key_out,
             float* __restrict__ val_out) {
  __shared__ int s_scan_key[kCarryThreads / 32];
  __shared__ float s_scan_val[kCarryThreads / 32];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kCarryThreads + threadIdx.x;
  const int key = i < count ? key_in[i] : INT_MAX;
  const float val =
      segmented_scan<kCarryThreads>(key, i < count ? val_in[i] : 0.0f, s_scan_key, s_scan_val);
  if (i >= count) {
    return;
  }
  const bool run_ends = i + 1 == count || key_in[i + 1] != key;
  if (run_ends && key < m) {
    out[key] += val;
  }
  if (threadIdx.x == kCarryThreads - 1 || i + 1 == count) {
    key_out[blockIdx.x] = key;
    val_out[blockIdx.x] = run_ends ? 0.0f : val;
  }
}

// The merge kernel and its carry rounds on stream s. split is int64
// [2, ctas+1]: the merge-path coordinate (segments ended, nonzeros taken)
// at item kItems b for b = 0..ctas, the last at (m, nnz); items must equal
// kItems. carry_key (int32) and carry_val (f32) are scratch of at least
// 2 ctas entries. Returns cudaGetLastError() after the launches.
template <typename Term>
int launch(const void* ptr, const void* idx, const void* vals, Term term, void* out, int64_t m,
           int64_t nnz, const void* split, int64_t ctas, int64_t items, void* carry_key,
           void* carry_val, cudaStream_t s) {
  if (items != kItems || ctas < 1 || ctas > 0x7fffffff || m >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(idx) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vals) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int64_t* split_seg = static_cast<const int64_t*>(split);
  int32_t* keys = static_cast<int32_t*>(carry_key);
  float* sums = static_cast<float*>(carry_val);
  merge_kernel<Term><<<static_cast<unsigned>(ctas), kThreads, 0, s>>>(
      static_cast<const int64_t*>(ptr), static_cast<const int32_t*>(idx),
      static_cast<const float*>(vals), term, static_cast<float*>(out), split_seg,
      split_seg + ctas + 1, keys, sums, nnz);
  cudaError_t err = cudaGetLastError();
  for (int64_t count = ctas; count > 1 && err == cudaSuccess;) {
    const int64_t blocks = (count + kCarryThreads - 1) / kCarryThreads;
    carry_kernel<<<static_cast<unsigned>(blocks), kCarryThreads, 0, s>>>(
        keys, sums, count, static_cast<float*>(out), m, keys + count, sums + count);
    err = cudaGetLastError();
    keys += count;
    sums += count;
    count = blocks;
  }
  return static_cast<int>(err);
}

}  // namespace merge_path
