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
// Deterministic: every g[j] is summed by one fixed sequence of adds (no
// atomics), so repeated calls give bitwise-equal results, which the
// coordinate-descent schedule relies on.
//
// Bound: bytes moved. Streamed: 8*nnz (row_idx + vals) + 8*(d+1) (col_ptr)
// + 4*d (g). The gather of c is served from L2 while 4*n fits in it.
// The arithmetic (2 flops a nonzero) is far below the card's rate.
//
// Column lengths are skewed: an intercept column holds every row, while at
// 2^24 dims the other columns hold about one nonzero each. So the work is
// split by length, in one launch:
//   * blocks [0, num_segments): each sums one segment (at most a few
//     thousand nonzeros) of a long column (more than short_max nonzeros)
//     with all its threads, then a fixed-order block reduction writes the
//     segment's partial sum;
//   * the remaining blocks stride over the columns with one thread a
//     column and sum the short columns sequentially (neighbouring threads
//     read neighbouring col_ptr entries and, for short columns, nearby
//     row_idx/vals), skipping the long ones.
// A second small launch sums each long column's segment partials in order
// (one thread a long column). The segment table is built once per matrix
// by the Python wrapper. The kernels allocate nothing and run on the
// caller's stream.
//
// csc_rmatvec_bf16 is the same pair of kernels for the reference's
// bfloat16 payload (fused_perm.py:330): there the network input is the
// product t(vals) * c[row], computed in f32 and rounded once to bf16 on
// entry (fused_perm.py:522-524; prologue MulBroadcast :211-213), then
// reduced per column in f32. So each term is bf16_rn(t(v) * c[row]) (the
// product rounded, never its factors) and the sums stay f32. The kernels
// are instantiated for both term rules (Fma, RoundedProduct below).
//
// Left to a later change: a warp per column for mid-length columns, TMA
// staging, and binning columns by length.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxShortBlocks = 1 << 16;

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

// acc + one column term
struct Fma {
  __device__ __forceinline__ float operator()(float acc, float v, float c) const {
    return fmaf(v, c, acc);
  }
};

struct RoundedProduct {
  __device__ __forceinline__ float operator()(float acc, float v, float c) const {
    return acc + __bfloat162float(__float2bfloat16_rn(v * c));
  }
};

template <typename Term>
__global__ void __launch_bounds__(kThreads)
csc_rmatvec_main_kernel(const int64_t* __restrict__ col_ptr,
                        const int32_t* __restrict__ row_idx,
                        const float* __restrict__ vals,
                        const float* __restrict__ c,
                        float* __restrict__ g,
                        int64_t d, int transform, int64_t short_max,
                        const int64_t* __restrict__ seg_begin,
                        const int64_t* __restrict__ seg_end,
                        float* __restrict__ partial,
                        int64_t num_segments) {
  __shared__ float warp_sums[kWarps];
  const Term term{};
  const int64_t block = blockIdx.x;
  if (block < num_segments) {
    const int64_t end = seg_end[block];
    float acc = 0.0f;
    for (int64_t p = seg_begin[block] + threadIdx.x; p < end; p += kThreads) {
      acc = term(acc, transformed(vals[p], transform), __ldg(c + row_idx[p]));
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, offset);
    }
    if ((threadIdx.x & 31) == 0) {
      warp_sums[threadIdx.x >> 5] = acc;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.0f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        total += warp_sums[i];
      }
      partial[block] = total;
    }
    return;
  }
  const int64_t stride = (static_cast<int64_t>(gridDim.x) - num_segments) * kThreads;
  for (int64_t j = (block - num_segments) * kThreads + threadIdx.x; j < d; j += stride) {
    const int64_t begin = col_ptr[j];
    const int64_t end = col_ptr[j + 1];
    if (end - begin > short_max) {
      continue;  // a long column: summed by its segments
    }
    float acc = 0.0f;
    for (int64_t p = begin; p < end; ++p) {
      acc = term(acc, transformed(vals[p], transform), __ldg(c + row_idx[p]));
    }
    g[j] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
csc_rmatvec_finish_kernel(const int32_t* __restrict__ long_cols,
                          const int64_t* __restrict__ seg_ptr,
                          const float* __restrict__ partial,
                          float* __restrict__ g, int64_t num_long) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (l >= num_long) {
    return;
  }
  float total = 0.0f;
  for (int64_t s = seg_ptr[l]; s < seg_ptr[l + 1]; ++s) {
    total += partial[s];
  }
  g[long_cols[l]] = total;
}

template <typename Term>
int launch(const void* col_ptr, const void* row_idx, const void* vals, const void* c, void* g,
           int64_t d, int transform, int64_t short_max, const void* seg_begin,
           const void* seg_end, void* partial, int64_t num_segments, const void* long_cols,
           const void* seg_ptr, int64_t num_long, cudaStream_t s) {
  int64_t short_blocks = (d + kThreads - 1) / kThreads;
  if (short_blocks > kMaxShortBlocks) {
    short_blocks = kMaxShortBlocks;
  }
  const int64_t blocks = num_segments + short_blocks;
  if (blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (blocks > 0) {
    csc_rmatvec_main_kernel<Term><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int64_t*>(col_ptr), static_cast<const int32_t*>(row_idx),
        static_cast<const float*>(vals), static_cast<const float*>(c),
        static_cast<float*>(g), d, transform, short_max,
        static_cast<const int64_t*>(seg_begin), static_cast<const int64_t*>(seg_end),
        static_cast<float*>(partial), num_segments);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  if (num_long > 0) {
    const int64_t finish_blocks = (num_long + kThreads - 1) / kThreads;
    csc_rmatvec_finish_kernel<<<static_cast<unsigned>(finish_blocks), kThreads, 0, s>>>(
        static_cast<const int32_t*>(long_cols), static_cast<const int64_t*>(seg_ptr),
        static_cast<const float*>(partial), static_cast<float*>(g), num_long);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes (csc_rmatvec_f32 and csc_rmatvec_bf16,
// one signature). Pointers are device pointers; stream is a cudaStream_t.
// transform: 0 id, 1 sq, 2 abs, 3 nnz. The segment table
// (seg_begin/seg_end [num_segments], long_cols [num_long], seg_ptr
// [num_long+1]) must cover exactly the columns longer than short_max;
// partial is scratch of num_segments floats. Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int csc_rmatvec_f32(const void* col_ptr, const void* row_idx,
                               const void* vals, const void* c, void* g,
                               int64_t d, int transform, int64_t short_max,
                               const void* seg_begin, const void* seg_end,
                               void* partial, int64_t num_segments,
                               const void* long_cols, const void* seg_ptr,
                               int64_t num_long, void* stream) {
  return launch<Fma>(col_ptr, row_idx, vals, c, g, d, transform, short_max, seg_begin,
                     seg_end, partial, num_segments, long_cols, seg_ptr, num_long,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int csc_rmatvec_bf16(const void* col_ptr, const void* row_idx,
                                const void* vals, const void* c, void* g,
                                int64_t d, int transform, int64_t short_max,
                                const void* seg_begin, const void* seg_end,
                                void* partial, int64_t num_segments,
                                const void* long_cols, const void* seg_ptr,
                                int64_t num_long, void* stream) {
  return launch<RoundedProduct>(col_ptr, row_idx, vals, c, g, d, transform, short_max,
                                seg_begin, seg_end, partial, num_segments, long_cols,
                                seg_ptr, num_long, static_cast<cudaStream_t>(stream));
}

// Message for a code returned by csc_rmatvec_f32 or csc_rmatvec_bf16.
extern "C" const char* spmv_t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
