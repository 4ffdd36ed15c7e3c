// csc_rmatvec_f32: g = X^T (t(vals) * c) for a CSC matrix X, with
// t in {id, sq, abs, nnz} chosen at run time; f32 accumulation.
// csc_rmatvec_bf16: the same with each product rounded to bfloat16.
//
// Replaces, in the rmatvec configuration, the three TPU kernels that
// photon_ml_tpu/ops/fused_perm.py chains in fused_execute (:476):
//   _descend_call (:325, prologue MulBroadcast: c times the transformed ELL
//                  values, broadcast over the slots),
//   _base_call    (:466),
//   _ascend_call  (:421, epilogue Reduce over each column's KP slots into g).
// Those route each nonzero's product through a Benes network from row order
// to column order because the TPU cannot scatter. Hopper can gather, so
// this kernel keeps a CSC copy of the matrix (col_ptr int64 [d+1], row_idx
// int32 [nnz], vals f32 [nnz]) and sums each column's products directly:
//   g[j] = sum over column j's nonzeros p of t(vals[p]) * c[row_idx[p]].
//
// Bound: bytes moved. Streamed: 8*nnz (row_idx + vals) + 8*(d+1) (col_ptr)
// + 4*d (g). The gather of c is served from L2 while 4*n fits in it.
// The arithmetic (2 flops a nonzero) is far below the card's rate.
//
// Column lengths are skewed: an intercept column holds every row, while at
// 2^24 dims the other columns hold about one nonzero each. The old design
// gave each short column a thread (one column a thread at that shape, so a
// warp issued three dependent rounds of single loads: col_ptr, then
// row_idx / vals, then c, with trip counts of 0 to a few diverging inside
// the warp) and cut long columns into segments from a host-built table.
// This one balances the work by a merge path, as CUB splits CSR SpMV:
//   * the work list is the merge of the column ends (d items) and the
//     nonzeros (nnz items); CTA b takes items [kItems b, kItems (b+1)),
//     from the coordinate (columns ended, nonzeros taken) that the wrapper
//     finds once a matrix by a binary search on the device
//     (fused_perm.merge_path_split) and caches. The split depends only on
//     col_ptr, so the order of every sum is fixed;
//   * the CTA loads its column ends (coalesced) and its nonzeros with
//     16-byte loads of row_idx and vals, issues all their gathers of c at
//     once, and stages the products in shared memory;
//   * each thread walks kItemsPerThread items of the merged list in order,
//     finishing the columns that end there, and a fixed-order segmented
//     scan by column over the threads adds the parts of a column that
//     several threads share. The CTA then writes every column that ends in
//     its share, an empty column's 0 included, with coalesced stores;
//   * the column still open at the CTA's end goes to a carry array (its
//     column, its partial sum). A second kernel adds the carries of each
//     column into g, 1024 carries a CTA, by the same segmented scan in CTA
//     order; a column open across the end of its 1024 carries leaves a
//     carry for another round of the same kernel (at 2^24 columns and
//     17.8 M nonzeros: 16.9 K CTAs, two rounds of 17 and 1 CTAs).
// No atomics: two calls give bitwise-equal results, which the
// coordinate-descent schedule relies on. The kernels allocate nothing and
// run on the caller's stream.
//
// csc_rmatvec_bf16 is the same kernels for the reference's bfloat16
// payload (fused_perm.py:330): there the network input is the product
// t(vals) * c[row], computed in f32 and rounded once to bf16 on entry
// (fused_perm.py:522-524; prologue MulBroadcast :211-213), then reduced per
// column in f32. So each term is bf16_rn(t(v) * c[row]) (the product
// rounded, never its factors) and the sums stay f32. The kernels are
// instantiated for both term rules (Product, RoundedProduct below).
//
// Left to a later change: TMA staging of the nonzeros; one pass over both
// entry sets of a bf16 engine (its exact set is a second, f32 pass today);
// and a narrower index format than int64 col_ptr (shared with the f32
// engine and the feature statistics).

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 8;
constexpr int kItems = kThreads * kItemsPerThread;
constexpr int kCarryThreads = 1024;

__device__ __forceinline__ float transformed(float v, int transform) {
  switch (transform) {
    case 1:
      return v * v;
    case 2:
      return fabsf(v);
    case 3:
      return v != 0.0f ? 1.0f : 0.0f;
    default:
      return v;
  }
}

// one column term from the transformed value and c[row]
struct Product {
  __device__ __forceinline__ float operator()(float v, float c) const { return v * c; }
};

struct RoundedProduct {
  __device__ __forceinline__ float operator()(float v, float c) const {
    return __bfloat162float(__float2bfloat16_rn(v * c));
  }
};

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

template <typename Term>
__global__ void __launch_bounds__(kThreads)
csc_rmatvec_merge_kernel(const int64_t* __restrict__ col_ptr,
                         const int32_t* __restrict__ row_idx,
                         const float* __restrict__ vals, const float* __restrict__ c,
                         float* __restrict__ g, const int64_t* __restrict__ split_col,
                         const int64_t* __restrict__ split_nz, int32_t* __restrict__ carry_key,
                         float* __restrict__ carry_val, int64_t nnz, int transform) {
  // the CTA's column ends (relative to j0) in [0, n_cols), then its terms
  __shared__ int32_t s_items[kItems];
  __shared__ float s_g[kItems];
  __shared__ int s_scan_key[kThreads / 32];
  __shared__ float s_scan_val[kThreads / 32];
  __shared__ float s_incl[kThreads];
  const Term term{};
  const int tid = threadIdx.x;
  const int64_t i0 = split_col[blockIdx.x];
  const int64_t j0 = split_nz[blockIdx.x];
  const int64_t j1 = split_nz[blockIdx.x + 1];
  const int n_cols = static_cast<int>(split_col[blockIdx.x + 1] - i0);
  const int n_nz = static_cast<int>(j1 - j0);
  int32_t* s_end = s_items;
  float* s_term = reinterpret_cast<float*>(s_items + n_cols);

  for (int x = tid; x < n_cols; x += kThreads) {
    s_end[x] = static_cast<int32_t>(col_ptr[i0 + 1 + x] - j0);
  }
  // the nonzeros in aligned groups of 4: 16-byte loads, then every gather
  // of the group at once
  for (int64_t p = (j0 & ~int64_t{3}) + 4 * tid; p < j1; p += 4 * kThreads) {
    int32_t r[4];
    float v[4];
    if (p + 4 <= nnz) {
      const int4 r4 = *reinterpret_cast<const int4*>(row_idx + p);
      const float4 v4 = *reinterpret_cast<const float4*>(vals + p);
      r[0] = r4.x, r[1] = r4.y, r[2] = r4.z, r[3] = r4.w;
      v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        r[e] = p + e < nnz ? row_idx[p + e] : 0;
        v[e] = p + e < nnz ? vals[p + e] : 0.0f;
      }
    }
    float cr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cr[e] = p + e >= j0 && p + e < j1 ? __ldg(c + r[e]) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (p + e >= j0 && p + e < j1) {
        s_term[p + e - j0] = term(transformed(v[e], transform), cr[e]);
      }
    }
  }
  __syncthreads();

  // this thread's share of the merged list: find its start by a binary
  // search on its diagonal, then walk it in order
  const int total = n_cols + n_nz;
  const int diag = min(tid * kItemsPerThread, total);
  const int diag_end = min(diag + kItemsPerThread, total);
  int lo = max(0, diag - n_nz);
  int hi = min(diag, n_cols);
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
    if (x < n_cols && s_end[x] <= y) {  // column i0 + x ends here
      if (first_x < 0) {
        first_x = x;
        first_sum = running;
      } else {
        s_g[x] = running;
      }
      running = 0.0f;
      ++x;
    } else {
      running += s_term[y];
      ++y;
    }
  }
  // the first column a thread ends may have begun in earlier threads: add
  // their parts (the CTA's earlier share of a column that began in an
  // earlier CTA comes through the carries)
  s_incl[tid] = segmented_scan<kThreads>(x, running, s_scan_key, s_scan_val);
  __syncthreads();
  if (first_x >= 0) {
    s_g[first_x] = (tid > 0 ? s_incl[tid - 1] : 0.0f) + first_sum;
  }
  __syncthreads();
  for (int i = tid; i < n_cols; i += kThreads) {
    g[i0 + i] = s_g[i];
  }
  if (tid == kThreads - 1) {
    carry_key[blockIdx.x] = static_cast<int32_t>(i0 + n_cols);
    carry_val[blockIdx.x] = s_incl[tid];
  }
}

// One round of carries: for each column, the sum of its carries in this
// CTA (in order) is added into g where its run of carries ends; a run open
// at the CTA's last carry leaves the CTA's carry for the next round (else
// the CTA's carry is 0). Keys of d or more (the column past the last) are
// no column.
__global__ void __launch_bounds__(kCarryThreads)
csc_rmatvec_carry_kernel(const int32_t* __restrict__ key_in, const float* __restrict__ val_in,
                         int64_t count, float* __restrict__ g, int64_t d,
                         int32_t* __restrict__ key_out, float* __restrict__ val_out) {
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
  if (run_ends && key < d) {
    g[key] += val;
  }
  if (threadIdx.x == kCarryThreads - 1 || i + 1 == count) {
    key_out[blockIdx.x] = key;
    val_out[blockIdx.x] = run_ends ? 0.0f : val;
  }
}

template <typename Term>
int launch(const void* col_ptr, const void* row_idx, const void* vals, const void* c, void* g,
           int64_t d, int64_t nnz, int transform, const void* split, int64_t ctas,
           int64_t items, void* carry_key, void* carry_val, cudaStream_t s) {
  if (items != kItems || ctas < 1 || ctas > 0x7fffffff || d >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(row_idx) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vals) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int64_t* split_col = static_cast<const int64_t*>(split);
  int32_t* keys = static_cast<int32_t*>(carry_key);
  float* sums = static_cast<float*>(carry_val);
  csc_rmatvec_merge_kernel<Term><<<static_cast<unsigned>(ctas), kThreads, 0, s>>>(
      static_cast<const int64_t*>(col_ptr), static_cast<const int32_t*>(row_idx),
      static_cast<const float*>(vals), static_cast<const float*>(c), static_cast<float*>(g),
      split_col, split_col + ctas + 1, keys, sums, nnz, transform);
  cudaError_t err = cudaGetLastError();
  for (int64_t count = ctas; count > 1 && err == cudaSuccess;) {
    const int64_t blocks = (count + kCarryThreads - 1) / kCarryThreads;
    csc_rmatvec_carry_kernel<<<static_cast<unsigned>(blocks), kCarryThreads, 0, s>>>(
        keys, sums, count, static_cast<float*>(g), d, keys + count, sums + count);
    err = cudaGetLastError();
    keys += count;
    sums += count;
    count = blocks;
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points for ctypes (csc_rmatvec_f32 and csc_rmatvec_bf16,
// one signature). Pointers are device pointers; stream is a cudaStream_t.
// transform: 0 id, 1 sq, 2 abs, 3 nnz. split is int64 [2, ctas+1]: the
// merge-path coordinate (columns ended, nonzeros taken) at item kItems b
// for b = 0..ctas, the last at (d, nnz); items must equal kItems.
// carry_key (int32) and carry_val (f32) are scratch of at least 2 ctas
// entries. row_idx and vals must be 16-byte aligned. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int csc_rmatvec_f32(const void* col_ptr, const void* row_idx, const void* vals,
                               const void* c, void* g, int64_t d, int64_t nnz, int transform,
                               const void* split, int64_t ctas, int64_t items, void* carry_key,
                               void* carry_val, void* stream) {
  return launch<Product>(col_ptr, row_idx, vals, c, g, d, nnz, transform, split, ctas, items,
                         carry_key, carry_val, static_cast<cudaStream_t>(stream));
}

extern "C" int csc_rmatvec_bf16(const void* col_ptr, const void* row_idx, const void* vals,
                                const void* c, void* g, int64_t d, int64_t nnz, int transform,
                                const void* split, int64_t ctas, int64_t items,
                                void* carry_key, void* carry_val, void* stream) {
  return launch<RoundedProduct>(col_ptr, row_idx, vals, c, g, d, nnz, transform, split, ctas,
                                items, carry_key, carry_val, static_cast<cudaStream_t>(stream));
}

// Message for a code returned by csc_rmatvec_f32 or csc_rmatvec_bf16.
extern "C" const char* spmv_t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
