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
// 2^24 dims the other columns hold about one nonzero each. The work is
// balanced by the merge path of merge_path.cuh over the column ends and
// the nonzeros (2048 items a CTA; at 2^24 columns and 17.8 M nonzeros:
// 16.9 K CTAs, then two carry rounds of 17 and 1 CTAs): no atomics, so two
// calls give bitwise-equal results, and the split depends only on col_ptr.
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

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "merge_path.cuh"

namespace {

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

// one column term from the stored value and c[row]
struct Product {
  const float* c;
  int transform;
  __device__ __forceinline__ float gather(int32_t row) const { return __ldg(c + row); }
  __device__ __forceinline__ float operator()(float v, float cr) const {
    return transformed(v, transform) * cr;
  }
};

struct RoundedProduct {
  const float* c;
  int transform;
  __device__ __forceinline__ float gather(int32_t row) const { return __ldg(c + row); }
  __device__ __forceinline__ float operator()(float v, float cr) const {
    return __bfloat162float(__float2bfloat16_rn(transformed(v, transform) * cr));
  }
};

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
  return merge_path::launch(col_ptr, row_idx, vals,
                            Product{static_cast<const float*>(c), transform}, g, d, nnz, split,
                            ctas, items, carry_key, carry_val, static_cast<cudaStream_t>(stream));
}

extern "C" int csc_rmatvec_bf16(const void* col_ptr, const void* row_idx, const void* vals,
                                const void* c, void* g, int64_t d, int64_t nnz, int transform,
                                const void* split, int64_t ctas, int64_t items,
                                void* carry_key, void* carry_val, void* stream) {
  return merge_path::launch(col_ptr, row_idx, vals,
                            RoundedProduct{static_cast<const float*>(c), transform}, g, d, nnz,
                            split, ctas, items, carry_key, carry_val,
                            static_cast<cudaStream_t>(stream));
}

// Message for a code returned by csc_rmatvec_f32 or csc_rmatvec_bf16.
extern "C" const char* spmv_t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
