// csr_matvec_f32: z = X w for a CSR matrix X, one warp per row.
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
// Left to a later change: row-length binning (short rows waste lanes; long
// rows serialise on one warp), TMA staging of col_idx/vals, and any use of
// wgmma (a matvec has no tile product to feed it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 1 << 16;

__global__ void __launch_bounds__(kThreads)
csr_matvec_f32_kernel(const int64_t* __restrict__ row_ptr,
                      const int32_t* __restrict__ col_idx,
                      const float* __restrict__ vals,
                      const float* __restrict__ w,
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
      acc = fmaf(vals[p], __ldg(w + col_idx[p]), acc);
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

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers; stream is a
// cudaStream_t. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int csr_matvec_f32(const void* row_ptr, const void* col_idx,
                              const void* vals, const void* w, void* z,
                              int64_t n, void* stream) {
  if (n <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) {
    blocks = kMaxBlocks;
  }
  csr_matvec_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
      static_cast<const float*>(vals), static_cast<const float*>(w),
      static_cast<float*>(z), n);
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by csr_matvec_f32.
extern "C" const char* spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
