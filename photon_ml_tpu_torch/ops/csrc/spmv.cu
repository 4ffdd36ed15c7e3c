// csr_matvec_f32: z = X w for a CSR matrix X;
// csr_matvec_bf16: the same with the coefficient rounded to bfloat16 (and
// exact entries flagged in the same matrix).
//
// Replaces, in the matvec configuration, the three TPU kernels that
// photon_ml_tpu/ops/fused_perm.py chains in fused_execute (:476):
//   _descend_call (:325, prologue Broadcast of w over KP column slots),
//   _base_call    (:466),
//   _ascend_call  (:421, epilogue MulReduce by the ELL values into z).
// Those carry a gather through a Benes permutation network because the TPU
// cannot gather. Hopper can, so this kernel computes the composite function
// directly: z[r] = sum over the stored nonzeros p of row r of vals[p] * w[col_idx[p]].
//
// Bound: bytes moved. The streamed part is 8*nnz (col_idx + vals) +
// 8*(n+1) (row_ptr) + 4*n (z), and w is read once at best (4*dim). The
// gather of w is served from L2 when its slice fits there and costs a
// 32-byte sector per nonzero when it does not. The arithmetic (2 flops per
// nonzero) is far below the card's rate. At the fixed-effect shard of the
// full-width fit (2^20 rows, 2^24 + 1 columns, 17.8 M nonzeros) the bound
// is 0.066 ms.
//
// Design. The old kernel gave each row a warp: at the shard's 14-17
// nonzeros a row half of every warp idled, each row was a chain of
// dependent loads (row_ptr, then col_idx / vals, then w) with a 5-step
// shuffle, and the random gather over the 64 MB f32 w missed the 50 MB L2
// (0.39 ms, 17 % of the bound). Now:
//   * the work is the merge path of merge_path.cuh over the row ends and
//     the nonzeros, 2048 items a CTA, then the carry rounds: a CTA loads
//     its row ends and nonzeros (16-byte loads of col_idx and vals) and
//     issues every gather of w at once, independent of where its rows
//     start; a thread walks 8 items of the merged list and a fixed-order
//     segmented scan joins the parts of a row that several threads share.
//     A row of thousands of nonzeros (a hot row) is cut into shares like
//     any other and summed in one fixed order through the carries;
//   * the CSR copy is stored in column blocks (fused_perm.csr_blocks: 5 at
//     2^24 + 1 columns, each a 13.4 MB slice of an f32 w), one after
//     another, each a CSR of all the rows: the CTAs in flight walk one
//     block at a time, so their gathers stay in a slice that L2 holds.
//     With blocks > 1 the merge path writes a partial sum a (block, row)
//     and a last kernel adds each row's partials in block order. On the
//     shard 5 blocks take about half the time of 1, and the walk with
//     col_idx replaced by a sequential pattern about two thirds of 5
//     blocks' (compare_kernels.py --blocks, chip_smoke.py; PERF.md). A
//     matrix of fewer than 8 nonzeros a row keeps one block (a block adds
//     a segment end a row).
// The order of every sum depends only on row_ptr: two calls are bitwise
// equal and the grid does not depend on the card. Empty rows write 0. The
// kernels allocate nothing and run on the caller's stream.
//
// csr_matvec_bf16 is the same kernel for the reference's bfloat16 payload
// (fused_perm.py:330 stores the network's intermediates in payload_dtype):
// there the network input, the broadcast coefficient, is rounded once to
// bf16 on entry (fused_perm.py:524, :315), multiplied by the f32 stored
// value and reduced in f32. So z[r] = sum of vals[p] * bf16_rn(w[col_idx[p]]),
// each gathered coefficient rounded in a register. The entries the
// reference keeps exact (hot columns, spill) are stored in the same CSR
// with column ~j (negative) and take w[j] unrounded, so the bf16 engine's
// matvec is one pass over both entry sets (a second f32 pass over all rows
// for the 2.8 M exact entries took a third of the rounded kernel's time;
// PERF.md). The old bf16 kernel first rounded w into a bf16 copy (96 MB
// of traffic at 2^24 columns) so that the 2-byte gather stayed in L2; with
// column blocks the f32 gather does, and the copy went.
//
// Left to a later change: the partial sums of a blocked matrix (20 MB
// written and read again at the shard, about 0.01 ms), TMA staging of
// col_idx / vals, and a walk that overlaps one share's loads with the
// previous share's scan.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "merge_path.cuh"

namespace {

constexpr int kSumThreads = 256;
constexpr int64_t kMaxSumBlocks = 1 << 16;

// a row term from the stored value and the coefficient of column j
struct GatherF32 {
  const float* w;
  __device__ __forceinline__ float gather(int32_t j) const { return __ldg(w + j); }
  __device__ __forceinline__ float operator()(float v, float wj) const { return v * wj; }
};

// the bf16 payload: the coefficient rounded to bf16 (to nearest even), but
// for an exact entry, stored with column ~j (negative)
struct GatherBf16 {
  const float* w;
  __device__ __forceinline__ float gather(int32_t j) const {
    const float wj = __ldg(w + (j < 0 ? ~j : j));
    return j < 0 ? wj : __bfloat162float(__float2bfloat16_rn(wj));
  }
  __device__ __forceinline__ float operator()(float v, float wj) const { return v * wj; }
};

// z[r] = the blocks' partial sums of row r, block 0 first
__global__ void __launch_bounds__(kSumThreads)
sum_blocks_kernel(const float* __restrict__ partial, float* __restrict__ z, int64_t n,
                  int64_t blocks) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSumThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x; r < n;
       r += stride) {
    float acc = partial[r];
    for (int64_t b = 1; b < blocks; ++b) {
      acc += partial[b * n + r];
    }
    z[r] = acc;
  }
}

template <typename Term>
int csr_matvec(const void* row_ptr, const void* col_idx, const void* vals, Term term, void* z,
               void* partial, int64_t n, int64_t blocks, int64_t nnz, const void* split,
               int64_t ctas, int64_t items, void* carry_key, void* carry_val,
               cudaStream_t s) {
  if (blocks < 1 || n > INT_MAX / blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* out = blocks > 1 ? partial : z;
  int rc = merge_path::launch(row_ptr, col_idx, vals, term, out, n * blocks, nnz, split, ctas,
                              items, carry_key, carry_val, s);
  if (rc != 0 || blocks == 1 || n == 0) {
    return rc;
  }
  int64_t grid = (n + kSumThreads - 1) / kSumThreads;
  grid = grid < kMaxSumBlocks ? grid : kMaxSumBlocks;
  sum_blocks_kernel<<<static_cast<unsigned>(grid), kSumThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(z), n, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes (csr_matvec_f32 and csr_matvec_bf16, one
// signature). Pointers are device pointers; stream is a cudaStream_t.
// row_ptr is int64 [blocks n + 1]: the matrix's column blocks one after
// another, each a CSR of the n rows (blocks = 1: the plain CSR); partial
// is scratch of blocks n floats (unused when blocks = 1). split is
// row_ptr's merge-path split, int64 [2, ctas+1]
// (fused_perm.merge_path_split); items must equal 2048; carry_key (int32)
// and carry_val (f32) are scratch of at least 2 ctas entries; col_idx and
// vals must be 16-byte aligned. Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int csr_matvec_f32(const void* row_ptr, const void* col_idx, const void* vals,
                              const void* w, void* z, void* partial, int64_t n, int64_t blocks,
                              int64_t nnz, const void* split, int64_t ctas, int64_t items,
                              void* carry_key, void* carry_val, void* stream) {
  return csr_matvec(row_ptr, col_idx, vals, GatherF32{static_cast<const float*>(w)}, z,
                    partial, n, blocks, nnz, split, ctas, items, carry_key, carry_val,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int csr_matvec_bf16(const void* row_ptr, const void* col_idx, const void* vals,
                               const void* w, void* z, void* partial, int64_t n, int64_t blocks,
                               int64_t nnz, const void* split, int64_t ctas, int64_t items,
                               void* carry_key, void* carry_val, void* stream) {
  return csr_matvec(row_ptr, col_idx, vals, GatherBf16{static_cast<const float*>(w)}, z,
                    partial, n, blocks, nnz, split, ctas, items, carry_key, carry_val,
                    static_cast<cudaStream_t>(stream));
}

// Message for a code returned by csr_matvec_f32 or csr_matvec_bf16.
extern "C" const char* spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
