// fused_value_grad_batched_f32: one pass over a batch of E small dense GLM
// problems, returning for each entity e
//   value[e] = sum_r where(wt>0, wt * l(z_r, y_r), 0)
//   grad[e]  = X[e]^T dz,  dz_r = where(wt>0, wt * l'(z_r, y_r), 0)
//   csum[e]  = sum_r dz_r
// with z = X[e] w[e] + off[e], for X [E, s, d], y/off/wt [E, s], w [E, d],
// all f32, and l one of the four pointwise losses (run-time choice).
//
// Replaces fused_value_grad_single (photon_ml_tpu/ops/pallas_kernels.py:186,
// body _single_kernel :140), which the reference runs under jax.vmap over
// the entities of a random-effect bucket: one Pallas block per entity, the
// two products on the MXU.
//
// Bound: bytes moved, 4*E*(s*d + 3s + 2d + 2): X, y, off, wt and w read
// once, value, grad and csum written once. The arithmetic (about 4*s*d
// flops an entity) is far below the card's f32 rate at these shapes
// (s of 16-64, d of 16), so entities per launch, not per-entity work, set
// the time.
//
// Design: one warp per entity, a grid-stride loop over entities, four warps
// a block. The warp walks its entity's rows 32 at a time:
//   * lane r computes z for row r (a dot over d in a fixed order, w read
//     through the read-only path, the same address on every lane), then
//     l and l' in registers; a weight-0 row contributes an exact 0 and its
//     loss is never multiplied by its weight, so a loss that overflows to
//     inf on such a row cannot make 0*inf = NaN;
//   * the 32 values of dz go to shared memory, and lane j then adds
//     dz_r * X[r, j] into grad[e, j] for the columns it owns (j = lane,
//     lane+32, ...), row by row, keeping the running sum in the output;
//   * value and csum are per-lane partial sums, reduced at the end with a
//     fixed butterfly of warp shuffles.
// Every output is summed by one fixed sequence of operations (no atomics),
// so a lane's result does not depend on which other entities share the
// launch. X is read straight from global memory, so any s and d run; the
// kernel allocates nothing and runs on the caller's stream.
//
// Left to a later change: staging X tiles in shared memory with coalesced
// (TMA) loads, several entities a warp when s*d is small, and the tensor
// cores for larger d.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int64_t kMaxBlocks = 1 << 16;

// Losses as photon_ml_tpu_torch/losses/pointwise.py computes them.
constexpr int kLogistic = 0;
constexpr int kSquared = 1;
constexpr int kPoisson = 2;

__device__ __forceinline__ void loss_terms(int loss, float z, float y, float* l, float* d1) {
  if (loss == kLogistic) {
    // l = softplus(z) - y z (softplus as torch computes it: z above 20),
    // l' = sigmoid(z) - y
    const float softplus = z > 20.0f ? z : log1pf(expf(z));
    *l = softplus - y * z;
    *d1 = 1.0f / (1.0f + expf(-z)) - y;
  } else if (loss == kSquared) {
    const float r = z - y;
    *l = 0.5f * r * r;
    *d1 = r;
  } else if (loss == kPoisson) {
    const float e = expf(z);
    *l = e - y * z;
    *d1 = e - y;
  } else {
    // smoothed hinge, labels {0, 1} mapped to t = +-1, u = t z
    const float t = y > 0.5f ? 1.0f : -1.0f;
    const float u = t * z;
    if (u >= 1.0f) {
      *l = 0.0f;
      *d1 = 0.0f;
    } else if (u <= 0.0f) {
      *l = 0.5f - u;
      *d1 = -t;
    } else {
      *l = 0.5f * (1.0f - u) * (1.0f - u);
      *d1 = (u - 1.0f) * t;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_value_grad_kernel(const float* __restrict__ X, const float* __restrict__ y,
                        const float* __restrict__ offsets, const float* __restrict__ wt,
                        const float* __restrict__ w, float* __restrict__ value,
                        float* __restrict__ grad, float* __restrict__ csum,
                        int64_t E, int64_t s, int64_t d, int loss) {
  __shared__ float dz_tile[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp; e < E;
       e += static_cast<int64_t>(gridDim.x) * kWarpsPerBlock) {
    const float* xe = X + e * s * d;
    const float* we = w + e * d;
    float* ge = grad + e * d;
    for (int64_t j = lane; j < d; j += 32) {
      ge[j] = 0.0f;
    }
    float value_acc = 0.0f;
    float csum_acc = 0.0f;
    for (int64_t r0 = 0; r0 < s; r0 += 32) {
      const int64_t r = r0 + lane;
      float dz = 0.0f;
      if (r < s) {
        const float* xr = xe + r * d;
        float z = 0.0f;
        for (int64_t j = 0; j < d; ++j) {
          z = fmaf(xr[j], __ldg(we + j), z);
        }
        z += offsets[e * s + r];
        const float weight = wt[e * s + r];
        if (weight > 0.0f) {
          float l, d1;
          loss_terms(loss, z, y[e * s + r], &l, &d1);
          value_acc += weight * l;
          dz = weight * d1;
          csum_acc += dz;
        }
      }
      dz_tile[warp][lane] = dz;
      __syncwarp();
      const int64_t rows = s - r0 < 32 ? s - r0 : 32;
      for (int64_t j = lane; j < d; j += 32) {
        float acc = ge[j];
        for (int64_t i = 0; i < rows; ++i) {
          acc = fmaf(dz_tile[warp][i], xe[(r0 + i) * d + j], acc);
        }
        ge[j] = acc;
      }
      __syncwarp();
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      value_acc += __shfl_xor_sync(0xffffffffu, value_acc, offset);
      csum_acc += __shfl_xor_sync(0xffffffffu, csum_acc, offset);
    }
    if (lane == 0) {
      value[e] = value_acc;
      csum[e] = csum_acc;
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers to
// contiguous f32 arrays; stream is a cudaStream_t; loss: 0 logistic,
// 1 squared, 2 Poisson, 3 smoothed hinge. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int fused_value_grad_batched_f32(const void* X, const void* y,
                                            const void* offsets, const void* wt,
                                            const void* w, void* value, void* grad,
                                            void* csum, int64_t E, int64_t s,
                                            int64_t d, int loss, void* stream) {
  if (E <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  int64_t blocks = (E + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) {
    blocks = kMaxBlocks;
  }
  fused_value_grad_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(y),
      static_cast<const float*>(offsets), static_cast<const float*>(wt),
      static_cast<const float*>(w), static_cast<float*>(value),
      static_cast<float*>(grad), static_cast<float*>(csum), E, s, d, loss);
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by fused_value_grad_batched_f32.
extern "C" const char* value_grad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
