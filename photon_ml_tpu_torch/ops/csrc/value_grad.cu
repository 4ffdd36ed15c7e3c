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
// and in no order, so nothing carries over between them.
//
// Bound: bytes moved, 4*(n*d + 3n + 2d + 2): X, y, off, wt, w read once,
// value, grad, csum written once; 4*n*d flops, 1 flop a byte, far below
// the f32 rate's line (and the tensor cores would need TF32, which the
// reference's Precision.HIGHEST rules out). At n = 2^20, d = 256 that is
// 1.086 GB, 0.324 ms at 3.35 TB/s. So the design keeps enough bytes of X
// in flight to stream it at the memory's rate, reads it once, and does
// the rest from shared memory and registers:
//   * a constant grid of kRingGrid persistent CTAs (two on each of the
//     H100's 132 SMs; a constant, not the card's SM count, so the order of
//     the sums, and so the bits, do not depend on the card). CTA b takes
//     the contiguous run of row tiles [T b / G, T (b+1) / G);
//   * a tile is R full rows [R, d] (R a multiple of 4, R d <= 8192
//     floats): one contiguous span of X whose start is 16-byte aligned
//     whenever X is (the wrapper copies an X that is not). One thread
//     stages it into a ring of kStages 32 KiB slots in dynamic shared
//     memory with one cp.async.bulk global->shared copy that completes on
//     the slot's mbarrier (expect_tx); the ragged last tile's tail of at
//     most 3 floats comes by plain loads. So a CTA keeps up to kStages
//     tiles (96 KiB) in flight, and loads overlap the products: the old
//     kernel's scalar tile loads (an integer division an element, 4 loads
//     in flight a thread) and its load / sync / compute / sync steps
//     bounded it at a third of the memory's rate;
//   * all 8 warps consume the tile that has landed: z (a warp a row,
//     16-byte shared reads of X and of w, staged once, then a fixed
//     butterfly of shuffles), dz and the loss terms (a thread a row, with
//     y, off and wt loaded while the tile lands; weight-0 rows exact
//     zeros, as in the batched kernel), then X^T dz: thread t owns columns
//     t, t + 256, ... and keeps their partial sums in registers across all
//     of the CTA's tiles, rows in order; the CTA writes its partial
//     gradient row once, at the end (the old kernel read and wrote it
//     after every 64-row block);
//   * a second launch sums the grid's partials in CTA order, a thread per
//     column: the cross-CTA reduction is deterministic, without atomics,
//     and two calls are bitwise equal.
// Rows of more than kRingMaxCols = 2048 columns do not fit four to a slot;
// they take the column-split kernel below (64-row blocks, 256-column tiles
// staged by plain loads; the gradient pass loads each tile again, so X is
// read twice, the second time mostly from L2).
// No entry point of the reference reaches its blocked kernel (its
// objective routes only the single-block one); the port keeps the same
// rule, and this kernel serves callers of pallas_kernels.fused_value_grad.
//
// Left to a later change: the same ring for K6 (a batch of small
// problems), and a ring for rows wider than 2048 columns.

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

// the ring kernel (1 <= d <= kRingMaxCols)
constexpr int kStages = 3;
constexpr int kStageFloats = 8192;  // 32 KiB a slot
constexpr int kMaxTileRows = 256;
constexpr int kRingMaxCols = kStageFloats / 4;
constexpr int kColsPerThread = kRingMaxCols / kBlockedThreads;
constexpr int64_t kRingGrid = 264;

// the column-split kernel (wider rows)
constexpr int kRowsPerTile = 64;
constexpr int kMaxTileCols = 256;
constexpr int64_t kMaxGrid = 792;

__host__ __device__ __forceinline__ bool ring_path(int64_t d) {
  return d >= 1 && d <= kRingMaxCols;
}

// Rows a ring tile holds: a multiple of 4 (so every tile starts 16-byte
// aligned), at most kMaxTileRows.
__host__ __device__ __forceinline__ int ring_rows(int64_t d) {
  const int64_t rows = (kStageFloats / d) & ~int64_t{3};
  return rows > kMaxTileRows ? kMaxTileRows : static_cast<int>(rows);
}

int64_t blocked_grid(int64_t n, int64_t d) {
  const int64_t rows = ring_path(d) ? ring_rows(d) : kRowsPerTile;
  const int64_t cap = ring_path(d) ? kRingGrid : kMaxGrid;
  const int64_t tiles = (n + rows - 1) / rows;
  return tiles < cap ? tiles : cap;
}

size_t ring_smem_bytes(int64_t d) {
  return sizeof(float) * (kStages * kStageFloats + ((d + 3) & ~int64_t{3}) + 2 * kMaxTileRows);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrive on bar and add bytes to the transfer count its phase waits for.
__device__ __forceinline__ void barrier_expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One bulk copy of bytes (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Stage ring tile t (rows [t R, min(n, t R + R)) of X, one contiguous span)
// into slot: its 16-byte prefix by one bulk copy, the tail of a ragged last
// tile (at most 3 floats) by plain loads; the slot's barrier completes when
// both are in. One thread calls this.
__device__ __forceinline__ void stage_tile(float* slot, uint64_t* bar,
                                           const float* __restrict__ X, int64_t n, int64_t d,
                                           int rows_per_tile, int64_t t) {
  const int64_t row0 = t * rows_per_tile;
  const int64_t rows = n - row0 < rows_per_tile ? n - row0 : rows_per_tile;
  const int64_t count = rows * d;
  const int64_t bulk = count & ~int64_t{3};
  const float* src = X + row0 * d;
  for (int64_t i = bulk; i < count; ++i) {
    slot[i] = src[i];
  }
  barrier_expect_bytes(bar, static_cast<uint32_t>(bulk * sizeof(float)));
  if (bulk > 0) {
    bulk_copy(slot, src, static_cast<uint32_t>(bulk * sizeof(float)), bar);
  }
}

// The CTA's value and csum: a fixed butterfly in each warp, then the warps
// in order.
__device__ __forceinline__ void write_cta_sums(float value_acc, float csum_acc,
                                               float (*warp_sums)[kBlockedWarps],
                                               float* __restrict__ partial_value,
                                               float* __restrict__ partial_csum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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
fused_value_grad_ring_kernel(const float* __restrict__ X, const float* __restrict__ y,
                             const float* __restrict__ offsets, const float* __restrict__ wt,
                             const float* __restrict__ w, float* __restrict__ partial_grad,
                             float* __restrict__ partial_value,
                             float* __restrict__ partial_csum, int64_t n, int64_t d,
                             int loss) {
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;                              // [kStages][kStageFloats]
  float* w_s = ring + kStages * kStageFloats;      // [d rounded up to 4]
  float* z_s = w_s + ((d + 3) & ~int64_t{3});      // [kMaxTileRows]
  float* dz_s = z_s + kMaxTileRows;                // [kMaxTileRows]
  __shared__ uint64_t full[kStages];
  __shared__ float warp_sums[2][kBlockedWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows_per_tile = ring_rows(d);
  const int64_t tiles = (n + rows_per_tile - 1) / rows_per_tile;
  const int64_t first = tiles * blockIdx.x / gridDim.x;
  const int64_t last = tiles * (blockIdx.x + 1) / gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      barrier_init(&full[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int64_t j = tid; j < d; j += kBlockedThreads) {
    w_s[j] = w[j];
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < kStages && first + s < last; ++s) {
      stage_tile(ring + s * kStageFloats, &full[s], X, n, d, rows_per_tile, first + s);
    }
  }

  float grad_acc[kColsPerThread];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    grad_acc[c] = 0.0f;
  }
  float value_acc = 0.0f;
  float csum_acc = 0.0f;
  const bool vec4 = (d & 3) == 0;
  for (int64_t t = first; t < last; ++t) {
    const int64_t k = t - first;
    const int stage = static_cast<int>(k % kStages);
    const float* tile = ring + stage * kStageFloats;
    const int64_t row0 = t * rows_per_tile;
    const int rows = n - row0 < rows_per_tile ? static_cast<int>(n - row0) : rows_per_tile;
    // this tile's row operands, loaded while the tile lands
    float y_r = 0.0f, off_r = 0.0f, wt_r = 0.0f;
    if (tid < rows) {
      y_r = y[row0 + tid];
      off_r = offsets[row0 + tid];
      wt_r = wt[row0 + tid];
    }
    barrier_wait(&full[stage], static_cast<uint32_t>((k / kStages) & 1));

    // z = X w, a warp a row
    for (int r = warp; r < rows; r += kBlockedWarps) {
      const float* xr = tile + r * d;
      float acc = 0.0f;
      if (vec4) {
        const float4* x4 = reinterpret_cast<const float4*>(xr);
        const float4* w4 = reinterpret_cast<const float4*>(w_s);
        for (int q = lane; q < d / 4; q += 32) {
          const float4 a = x4[q];
          const float4 b = w4[q];
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
          acc = fmaf(a.z, b.z, acc);
          acc = fmaf(a.w, b.w, acc);
        }
      } else {
        for (int j = lane; j < d; j += 32) {
          acc = fmaf(xr[j], w_s[j], acc);
        }
      }
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, offset);
      }
      if (lane == 0) {
        z_s[r] = acc;
      }
    }
    __syncthreads();
    // dz and the loss terms, a thread per row
    if (tid < rows) {
      float dz = 0.0f;
      if (wt_r > 0.0f) {
        float l, d1;
        loss_terms(loss, z_s[tid] + off_r, y_r, &l, &d1);
        value_acc += wt_r * l;
        dz = wt_r * d1;
        csum_acc += dz;
      }
      dz_s[tid] = dz;
    }
    __syncthreads();
    // X^T dz into each thread's columns, rows in order
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int j = tid + c * kBlockedThreads;
      if (j < d) {
        float acc = grad_acc[c];
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
          acc = fmaf(dz_s[r], tile[r * d + j], acc);
        }
        grad_acc[c] = acc;
      }
    }
    __syncthreads();  // every thread is done with the slot
    if (tid == 0 && t + kStages < last) {
      // the slot's next contents come through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      stage_tile(ring + stage * kStageFloats, &full[stage], X, n, d, rows_per_tile,
                 t + kStages);
    }
  }

  float* pg = partial_grad + static_cast<int64_t>(blockIdx.x) * d;
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    const int j = tid + c * kBlockedThreads;
    if (j < d) {
      pg[j] = grad_acc[c];
    }
  }
  write_cta_sums(value_acc, csum_acc, warp_sums, partial_value, partial_csum);
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

// The column-split kernel, for rows wider than kRingMaxCols (and d = 0):
// 64-row blocks in a grid-stride loop over a fixed grid of at most
// kMaxGrid CTAs, each block's z pass streaming its 256-column tiles, its
// gradient pass loading them again.
__global__ void __launch_bounds__(kBlockedThreads)
fused_value_grad_wide_kernel(const float* __restrict__ X, const float* __restrict__ y,
                             const float* __restrict__ offsets, const float* __restrict__ wt,
                             const float* __restrict__ w, float* __restrict__ partial_grad,
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
  write_cta_sums(value_acc, csum_acc, warp_sums, partial_value, partial_csum);
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

// CTAs (rows of the partial sums) fused_value_grad_f32 uses for X [n, d]:
// the wrapper allocates partial_grad [grid, d], partial_value and
// partial_csum [grid].
extern "C" int64_t fused_value_grad_f32_grid(int64_t n, int64_t d) {
  return blocked_grid(n, d);
}

// Plain C entry point for ctypes. X [n, d] and y/off/wt [n], w [d] are
// contiguous f32 device arrays, X 16-byte aligned; value and csum point to
// one float, grad to d. Returns cudaGetLastError() after the launches (0 on
// success), cudaErrorMisalignedAddress for an X that is not 16-byte
// aligned.
extern "C" int fused_value_grad_f32(const void* X, const void* y, const void* offsets,
                                    const void* wt, const void* w, void* value, void* grad,
                                    void* csum, void* partial_grad, void* partial_value,
                                    void* partial_csum, int64_t n, int64_t d, int loss,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t grid = blocked_grid(n, d);
  if (grid > 0) {
    const bool ring = ring_path(d);
    if (ring && reinterpret_cast<uintptr_t>(X) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    const void* kernel = ring ? reinterpret_cast<const void*>(fused_value_grad_ring_kernel)
                              : reinterpret_cast<const void*>(fused_value_grad_wide_kernel);
    const size_t smem_bytes =
        ring ? ring_smem_bytes(d) : sizeof(float) * kRowsPerTile * tile_cols(d);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_bytes));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    auto launch = ring ? fused_value_grad_ring_kernel : fused_value_grad_wide_kernel;
    launch<<<static_cast<unsigned>(grid), kBlockedThreads, smem_bytes, s>>>(
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
