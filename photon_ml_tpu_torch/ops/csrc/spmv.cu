// csr_matvec_f32: z = X w for a CSR matrix X, one warp per row;
// csr_matvec_bf16: the same with the coefficient rounded to bfloat16.
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
// 8*(n+1) (row_ptr) + 4*n (z). The gather of w is served from L2 when
// 4*dim <= 50 MB, and costs one 32-byte sector per nonzero when it is not.
// The arithmetic (2 flops per nonzero) is far below the card's rate.
//
// Design: each lane of a warp strides over the row's nonzeros, so
// neighbouring lanes read neighbouring col_idx/vals addresses (coalesced),
// gathers w through the read-only path (__ldg), accumulates in f32, and the
// warp reduces with __shfl_down_sync; lane 0 writes z[r]. Empty rows write 0.
// A grid-stride loop over rows lets any n run. The kernel allocates nothing
// and runs on the caller's stream.
//
// csr_matvec_bf16 is the same kernel for the reference's bfloat16 payload
// (fused_perm.py:330 stores the network's intermediates in payload_dtype):
// there the network input, the broadcast coefficient, is rounded once to
// bf16 on entry (fused_perm.py:524, :315), multiplied by the f32 stored
// value and reduced in f32. So z[r] = sum of vals[p] * bf16_rn(w[col_idx[p]]).
// A first launch rounds w into a bf16 copy (4*dim read, 2*dim written),
// and the gather then reads 2-byte values: the copy of a 2^24-column w is
// 32 MB and stays in the 50 MB L2, where the f32 w (64 MB) does not. At
// the full-width shape this measured 11-14% faster than gathering the f32
// value and rounding it in a register (PERF.md).
//
// Left to a later change: row-length binning (short rows waste lanes; long
// rows serialise on one warp), TMA staging of col_idx/vals, and any use of
// wgmma (a matvec has no tile product to feed it).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 1 << 16;

// the coefficient of column j as the product sees it
struct GatherF32 {
  const float* w;
  __device__ __forceinline__ float operator()(int32_t j) const { return __ldg(w + j); }
};

struct GatherBf16 {
  const __nv_bfloat16* w;
  __device__ __forceinline__ float operator()(int32_t j) const {
    return __bfloat162float(__ldg(w + j));
  }
};

template <typename Gather>
__global__ void __launch_bounds__(kThreads)
csr_matvec_kernel(const int64_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ col_idx,
                  const float* __restrict__ vals,
                  Gather gather,
                  float* __restrict__ z,
                  int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t num_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t r = warp; r < n; r += num_warps) {
    const int64_t begin = row_ptr[r];
    const int64_t end = row_ptr[r + 1];
    float acc = 0.0f;
    for (int64_t p = begin + lane; p < end; p += 32) {
      acc = fmaf(vals[p], gather(col_idx[p]), acc);
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, offset);
    }
    if (lane == 0) {
      z[r] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
round_to_bf16_kernel(const float* __restrict__ w, __nv_bfloat16* __restrict__ out,
                     int64_t dim) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; j < dim;
       j += stride) {
    out[j] = __float2bfloat16_rn(w[j]);
  }
}

int64_t row_blocks(int64_t n) {
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

template <typename Gather>
int launch(const void* row_ptr, const void* col_idx, const void* vals, Gather gather,
           void* z, int64_t n, cudaStream_t stream) {
  csr_matvec_kernel<Gather><<<static_cast<unsigned>(row_blocks(n)), kThreads, 0, stream>>>(
      static_cast<const int64_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
      static_cast<const float*>(vals), gather, static_cast<float*>(z), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers; stream is a
// cudaStream_t. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int csr_matvec_f32(const void* row_ptr, const void* col_idx,
                              const void* vals, const void* w, void* z,
                              int64_t n, void* stream) {
  if (n <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  return launch(row_ptr, col_idx, vals, GatherF32{static_cast<const float*>(w)}, z, n,
                static_cast<cudaStream_t>(stream));
}

// The bf16 payload configuration. w_bf16 is scratch of dim bf16 values.
extern "C" int csr_matvec_bf16(const void* row_ptr, const void* col_idx,
                               const void* vals, const void* w, void* w_bf16, void* z,
                               int64_t n, int64_t dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (dim > 0) {
    int64_t blocks = (dim + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) {
      blocks = kMaxBlocks;
    }
    round_to_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(w), static_cast<__nv_bfloat16*>(w_bf16), dim);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  return launch(row_ptr, col_idx, vals,
                GatherBf16{static_cast<const __nv_bfloat16*>(w_bf16)}, z, n, s);
}

// Message for a code returned by csr_matvec_f32.
extern "C" const char* spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
