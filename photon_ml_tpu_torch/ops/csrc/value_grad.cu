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
//
// fused_value_grad_f32: the same three sums over ONE dense problem X [n, d]
// of any size (value, grad [d], csum).
//
// Replaces fused_value_grad (photon_ml_tpu/ops/pallas_kernels.py:115, body
// _kernel :45), the reference's blocked kernel: a sequential grid over
// 256-row blocks of X that accumulates into its outputs from one step to
// the next, the two products on the MXU. Hopper's blocks run in parallel
// and in no order, so nothing carries over between them:
//   * each CTA takes 64-row blocks of X in a grid-stride loop over a fixed
//     grid of at most kMaxGrid CTAs, and stages each block's [64, d] tile
//     in shared memory, so X is read from HBM once;
//   * from the staged tile it computes z (a warp per row, lanes strided
//     over the columns, a fixed butterfly of shuffles), then dz and the
//     loss terms (a thread per row, weight-0 rows exact zeros as in the
//     batched kernel), then its partial X^T dz (a thread per column, rows
//     in order), added into its own row of a [grid, d] scratch array;
//   * a second launch sums the grid's partials in CTA order, a thread per
//     column: the cross-CTA reduction is deterministic, without atomics.
//     The grid is a constant (two waves of three 64 KiB CTAs on each of
//     the H100's 132 SMs), not the card's SM count, so the order of the
//     sums, and so the bits, do not depend on the card.
// A tile holds at most kMaxTileCols = 256 columns (64 KiB of shared
// memory). Wider rows are split into column tiles: the z pass streams
// them, and the gradient pass loads each again, so for d > 256 X is read
// twice (the second read of a 64-row block may come from L2).
//
// Bound: bytes moved, 4*(n*d + 3n + 2d + 2): X, y, off, wt, w read once,
// value, grad, csum written once; 4*n*d flops, below the f32 rate's line.
// At n = 2^20, d = 256 that is 1.086 GB, 0.324 ms at 3.35 TB/s.
// No entry point of the reference reaches its blocked kernel (its
// objective routes only the single-block one); the port keeps the same
// rule, and this kernel serves callers of pallas_kernels.fused_value_grad.
//
// Left to a later change: 16-byte (or TMA) tile loads, a double-buffered
// tile ring so loads overlap the products, and the tensor cores (a
// [64, d] x [d] product is a matvec; two passes would need X^T dz as a
// [1, 64] x [64, d] product).

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

constexpr int kBlockedThreads = 256;
constexpr int kBlockedWarps = kBlockedThreads / 32;
constexpr int kRowsPerTile = 64;
constexpr int kMaxTileCols = 256;
constexpr int64_t kMaxGrid = 792;

int64_t blocked_grid(int64_t n) {
  const int64_t row_blocks = (n + kRowsPerTile - 1) / kRowsPerTile;
  return row_blocks < kMaxGrid ? row_blocks : kMaxGrid;
}

__host__ __device__ __forceinline__ int tile_cols(int64_t d) {
  return d > kMaxTileCols ? kMaxTileCols : (d > 0 ? static_cast<int>(d) : 1);
}

// Copy rows [row0, row0 + rows) x columns [c0, c0 + cols) of X into tile.
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ X,
                                          int64_t d, int64_t row0, int rows, int64_t c0,
                                          int cols) {
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * cols; i += kBlockedThreads) {
    const int r = i / cols;
    const int j = i - r * cols;
    tile[i] = X[(row0 + r) * d + c0 + j];
  }
}

__global__ void __launch_bounds__(kBlockedThreads)
fused_value_grad_blocked_kernel(const float* __restrict__ X, const float* __restrict__ y,
                                const float* __restrict__ offsets,
                                const float* __restrict__ wt, const float* __restrict__ w,
                                float* __restrict__ partial_grad,
                                float* __restrict__ partial_value,
                                float* __restrict__ partial_csum, int64_t n, int64_t d,
                                int loss) {
  extern __shared__ float tile[];  // [kRowsPerTile, tile_cols(d)]
  __shared__ float z_row[kRowsPerTile];
  __shared__ float dz_row[kRowsPerTile];
  __shared__ float warp_sums[2][kBlockedWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int width = tile_cols(d);
  const int64_t num_tiles = (d + width - 1) / width;
  const int64_t row_blocks = (n + kRowsPerTile - 1) / kRowsPerTile;
  float* pg = partial_grad + static_cast<int64_t>(blockIdx.x) * d;
  float value_acc = 0.0f;
  float csum_acc = 0.0f;
  bool first = true;
  for (int64_t rb = blockIdx.x; rb < row_blocks; rb += gridDim.x) {
    const int64_t row0 = rb * kRowsPerTile;
    const int rows = n - row0 < kRowsPerTile ? static_cast<int>(n - row0) : kRowsPerTile;
    if (threadIdx.x < kRowsPerTile) {
      z_row[threadIdx.x] = 0.0f;
    }
    // z = X w, tile by tile
    for (int64_t t = 0; t < num_tiles; ++t) {
      const int64_t c0 = t * width;
      const int cols = d - c0 < width ? static_cast<int>(d - c0) : width;
      __syncthreads();
      load_tile(tile, X, d, row0, rows, c0, cols);
      __syncthreads();
      for (int r = warp; r < rows; r += kBlockedWarps) {
        float acc = 0.0f;
        for (int j = lane; j < cols; j += 32) {
          acc = fmaf(tile[r * cols + j], __ldg(w + c0 + j), acc);
        }
#pragma unroll
        for (int offset = 16; offset > 0; offset >>= 1) {
          acc += __shfl_xor_sync(0xffffffffu, acc, offset);
        }
        if (lane == 0) {
          z_row[r] += acc;
        }
      }
    }
    __syncthreads();
    // dz and the loss terms, a thread per row
    if (threadIdx.x < kRowsPerTile) {
      float dz = 0.0f;
      if (static_cast<int>(threadIdx.x) < rows) {
        const int64_t row = row0 + threadIdx.x;
        const float weight = wt[row];
        if (weight > 0.0f) {
          float l, d1;
          loss_terms(loss, z_row[threadIdx.x] + offsets[row], y[row], &l, &d1);
          value_acc += weight * l;
          dz = weight * d1;
          csum_acc += dz;
        }
      }
      dz_row[threadIdx.x] = dz;
    }
    __syncthreads();
    // the block's X^T dz, a thread per column, rows in order; one tile is
    // still staged from the z pass
    for (int64_t t = 0; t < num_tiles; ++t) {
      const int64_t c0 = t * width;
      const int cols = d - c0 < width ? static_cast<int>(d - c0) : width;
      if (num_tiles > 1) {
        __syncthreads();
        load_tile(tile, X, d, row0, rows, c0, cols);
        __syncthreads();
      }
      for (int j = threadIdx.x; j < cols; j += kBlockedThreads) {
        float acc = 0.0f;
        for (int r = 0; r < rows; ++r) {
          acc = fmaf(dz_row[r], tile[r * cols + j], acc);
        }
        pg[c0 + j] = first ? acc : pg[c0 + j] + acc;
      }
    }
    first = false;
  }
  // the CTA's value and csum: a fixed butterfly in each warp, then the
  // warps in order
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    value_acc += __shfl_xor_sync(0xffffffffu, value_acc, offset);
    csum_acc += __shfl_xor_sync(0xffffffffu, csum_acc, offset);
  }
  if (lane == 0) {
    warp_sums[0][warp] = value_acc;
    warp_sums[1][warp] = csum_acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.0f;
    float c = 0.0f;
#pragma unroll
    for (int i = 0; i < kBlockedWarps; ++i) {
      v += warp_sums[0][i];
      c += warp_sums[1][i];
    }
    partial_value[blockIdx.x] = v;
    partial_csum[blockIdx.x] = c;
  }
}

__global__ void __launch_bounds__(kBlockedThreads)
fused_value_grad_finish_kernel(const float* __restrict__ partial_grad,
                               const float* __restrict__ partial_value,
                               const float* __restrict__ partial_csum,
                               float* __restrict__ grad, float* __restrict__ value,
                               float* __restrict__ csum, int64_t grid, int64_t d) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kBlockedThreads + threadIdx.x;
  if (j < d) {
    float acc = 0.0f;
    for (int64_t g = 0; g < grid; ++g) {
      acc += partial_grad[g * d + j];
    }
    grad[j] = acc;
  }
  if (j == 0) {
    float v = 0.0f;
    float c = 0.0f;
    for (int64_t g = 0; g < grid; ++g) {
      v += partial_value[g];
      c += partial_csum[g];
    }
    *value = v;
    *csum = c;
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

// CTAs (rows of the partial sums) fused_value_grad_f32 uses for n rows:
// the wrapper allocates partial_grad [grid, d], partial_value and
// partial_csum [grid].
extern "C" int64_t fused_value_grad_f32_grid(int64_t n) { return blocked_grid(n); }

// Plain C entry point for ctypes. X [n, d] and y/off/wt [n], w [d] are
// contiguous f32 device arrays; value and csum point to one float, grad to
// d. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int fused_value_grad_f32(const void* X, const void* y, const void* offsets,
                                    const void* wt, const void* w, void* value, void* grad,
                                    void* csum, void* partial_grad, void* partial_value,
                                    void* partial_csum, int64_t n, int64_t d, int loss,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t grid = blocked_grid(n);
  if (grid > 0) {
    const size_t tile_bytes = sizeof(float) * kRowsPerTile * tile_cols(d);
    cudaError_t err = cudaFuncSetAttribute(fused_value_grad_blocked_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(tile_bytes));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    fused_value_grad_blocked_kernel<<<static_cast<unsigned>(grid), kBlockedThreads,
                                      tile_bytes, s>>>(
        static_cast<const float*>(X), static_cast<const float*>(y),
        static_cast<const float*>(offsets), static_cast<const float*>(wt),
        static_cast<const float*>(w), static_cast<float*>(partial_grad),
        static_cast<float*>(partial_value), static_cast<float*>(partial_csum), n, d, loss);
    err = cudaGetLastError();
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const int64_t finish_blocks = d > 0 ? (d + kBlockedThreads - 1) / kBlockedThreads : 1;
  fused_value_grad_finish_kernel<<<static_cast<unsigned>(finish_blocks), kBlockedThreads, 0,
                                   s>>>(
      static_cast<const float*>(partial_grad), static_cast<const float*>(partial_value),
      static_cast<const float*>(partial_csum), static_cast<float*>(grad),
      static_cast<float*>(value), static_cast<float*>(csum), grid, d);
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by fused_value_grad_batched_f32 or
// fused_value_grad_f32.
extern "C" const char* value_grad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
