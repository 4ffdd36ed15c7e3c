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
// flops an entity) is far below the card's f32 rate at these shapes (s of
// 16-100, d of 16), so the design streams the bucket at the memory's rate
// and does the rest from shared memory. At the random-effect buckets
// [65,536, 38, 16] and [16,384, 96, 16] that is 198 MB (0.0592 ms at
// 3.35 TB/s) and 121 MB.
//
// Design: K7's ring (below), applied to a batch of small problems. The
// old kernel gave each entity a warp: lane r looped over row r's d
// columns with loads 64 B apart across the warp and a chain of dependent
// FMAs, half of the warp idled in the gradient pass at d = 16, and that
// pass read X a second time and read and wrote grad[e, :] in global memory
// every 32 rows (45 % of the bound). Now, for 1 <= d <= 2048:
//   * a constant grid of persistent CTAs (the wrapper's plan: 396, three
//     an SM of an H100, in "tiles" mode; a constant, not the SM count);
//     CTA b takes a contiguous run of tiles. The grid changes no bits;
//   * "tiles" mode (entities that fit a 32 KiB slot): a tile is k whole
//     entities, k from the wrapper's plan (pallas_kernels.entity_tiling:
//     the most that fit, rounded down to a multiple of the 8 warps, or of
//     the period that keeps every tile start 16-byte aligned in X, y,
//     off, wt and w). One thread stages a tile's five contiguous spans
//     (X [k, s, d], y, off, wt [k, s], w [k, d]) into a ring of
//     kTileStages slots by cp.async.bulk on the slot's mbarrier; a span
//     that starts or ends off a 16-byte boundary has its head and tail
//     (< 4 floats each) loaded plainly and keeps its offset within the
//     line in shared memory, so any shape and any base address run. Then
//     each warp takes whole entities of the tile with no block-wide
//     barrier between its steps: z from shared memory, G lanes a row (G
//     from d: 4 at d = 16, at most one 16-byte chunk a lane below 32
//     lanes), a fixed butterfly in the group; the loss terms a lane a row;
//     X^T dz with the rows cut into P parts (2 at d = 16), a lane a (part,
//     column), each part's rows in order in two chains (even and odd rows,
//     joined even + odd), the parts joined in a fixed tree; value and csum
//     as lane partials joined by a fixed butterfly. G and P are template
//     parameters (8 instantiations, chosen by d). What is left between
//     the kernel and its bound is the latency of this arithmetic more than
//     the loads: builds for the experiment that dropped one or the other
//     each kept most of the time. A first design in steps of the whole
//     CTA, separated by __syncthreads, was slower than the old kernel, and
//     two slots of 32 KiB with three CTAs an SM beat three slots with two;
//   * "rows" mode (an entity larger than a slot, up to the 2 M elements
//     the objective routes here): CTA b takes a contiguous run of
//     entities and streams each through the ring in chunks of R rows (R a
//     multiple of 4, R d <= 8192, R <= 256), keeping the entity's gradient
//     in registers (a thread a column, up to 8 columns a thread) until its
//     last chunk, as K7 does for one problem;
//   * d > 2048, s = 0 or d = 0: the old warp-an-entity kernel ("warp").
// Weight-0 rows contribute exact zeros, and their loss is never multiplied
// by their weight, so a loss that overflows to inf on such a row cannot
// make 0*inf = NaN. Every output is one thread's or one group's fixed
// sequence of operations (no atomics), and the sequence depends only on
// (s, d) and the mode, which depends only on (s, d): an entity's outputs
// do not depend on which entities share the launch, on their number, on
// the tile or CTA that takes it, or on the card. The kernels allocate
// nothing and run on the caller's stream.
//
// Left to a later change: the "rows" mode in warp-sized steps as the
// "tiles" mode now runs, and a ring for rows wider than 2048 columns.
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
// Left to a later change: a ring for rows wider than 2048 columns.

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

// The old K6 design, kept for rows wider than kRingMaxCols (and s = 0 or
// d = 0): a warp an entity, lane r computing row r's z, the gradient
// summed into grad[e, :] in global memory 32 rows at a time.
__global__ void __launch_bounds__(kThreads)
batched_warp_kernel(const float* __restrict__ X, const float* __restrict__ y,
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

// The CTA's value and csum into *value_out and *csum_out: a fixed
// butterfly in each warp, then the warps in order.
__device__ __forceinline__ void write_cta_sums(float value_acc, float csum_acc,
                                               float (*warp_sums)[kBlockedWarps],
                                               float* __restrict__ value_out,
                                               float* __restrict__ csum_out) {
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
    *value_out = v;
    *csum_out = c;
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
  write_cta_sums(value_acc, csum_acc, warp_sums, partial_value + blockIdx.x,
                 partial_csum + blockIdx.x);
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
  write_cta_sums(value_acc, csum_acc, warp_sums, partial_value + blockIdx.x,
                 partial_csum + blockIdx.x);
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

// ---------------------------------------------------------------- K6 ring
// (the batched kernel's "tiles" and "rows" modes; see the note at the top)

constexpr int kModeTiles = 0;
constexpr int kModeRows = 1;
constexpr int kModeWarp = 2;
// "rows" mode: kStages slots, each a chunk of at most kStageFloats floats
// plus room to keep the chunk's offset within its 16-byte line
constexpr int kSlotStride = kStageFloats + 4;
// "tiles" mode: kTileStages slots of kTileFloats floats (32 KiB) and rows
// of at most kEntityTileMaxRows a tile: 74 KiB a CTA, so that three CTAs
// (24 warps) share an SM (measured faster than three 32 KiB slots and two
// CTAs, or two 24 KiB slots and four; PERF.md)
constexpr int kTileFloats = 8192;
constexpr int kTileStages = 2;
constexpr int kEntityTileMaxRows = 1024;

__host__ __device__ __forceinline__ int64_t round4(int64_t x) { return (x + 3) & ~int64_t{3}; }

// Where a tile of k entities keeps its five spans in a slot (floats): X at
// 0, then y, off, wt and w, each with 4 floats of room for its offset in
// its 16-byte line; end is the slot's use.
struct TileLayout {
  int64_t y, off, wt, w, end;
};

__host__ __device__ __forceinline__ TileLayout tile_layout(int64_t k, int64_t s, int64_t d) {
  TileLayout L;
  L.y = round4(k * s * d) + 4;
  L.off = L.y + round4(k * s) + 4;
  L.wt = L.off + round4(k * s) + 4;
  L.w = L.wt + round4(k * s) + 4;
  L.end = L.w + round4(k * d) + 4;
  return L;
}

// p's offset in floats within its 16-byte line
__device__ __forceinline__ int line_offset(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// A span of count floats at src, placed at seg + line_offset(src) so that
// it keeps src's alignment: its head and tail (< 4 floats each) copied here
// by plain loads, its 16-byte aligned interior returned for one bulk copy.
struct Bulk {
  float* dst;
  const float* src;
  uint32_t bytes;
};

__device__ __forceinline__ Bulk stage_edges(float* seg, const float* src, int64_t count) {
  const int m = line_offset(src);
  float* dst = seg + m;
  const int64_t aligned_at = (4 - m) & 3;
  const int64_t head = aligned_at < count ? aligned_at : count;
  const int64_t tail = head + ((count - head) & ~int64_t{3});
  float v[6];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    v[i] = i < head ? src[i] : 0.0f;
    v[3 + i] = tail + i < count ? src[tail + i] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i < head) {
      dst[i] = v[i];
    }
    if (tail + i < count) {
      dst[tail + i] = v[3 + i];
    }
  }
  return {dst + head, src + head, static_cast<uint32_t>((tail - head) * sizeof(float))};
}

// Arrive on bar expecting the spans' interiors, then start their copies.
// One thread calls this.
template <int kSpans>
__device__ __forceinline__ void stage_spans(const Bulk (&spans)[kSpans], uint64_t* bar) {
  uint32_t bytes = 0;
#pragma unroll
  for (int i = 0; i < kSpans; ++i) {
    bytes += spans[i].bytes;
  }
  barrier_expect_bytes(bar, bytes);
#pragma unroll
  for (int i = 0; i < kSpans; ++i) {
    if (spans[i].bytes > 0) {
      bulk_copy(spans[i].dst, spans[i].src, spans[i].bytes, bar);
    }
  }
}

// Lanes a row in the z pass: enough for one float4 of the row each, a
// power of two up to the warp.
__host__ __device__ __forceinline__ int group_lanes(int64_t d) {
  int g = 1;
  while (g < 32 && 4 * g < d) {
    g <<= 1;
  }
  return g;
}

// One lane's part of the dot of row x with w (d entries): the 4-float
// chunks q, q + G, ... in order, each an FMA chain over its 4 entries. The
// 16-byte path (both rows aligned, d a multiple of 4) does the same
// operations in the same order as the scalar one.
__device__ __forceinline__ float row_dot_part(const float* x, const float* w, int d, int G,
                                              int q, bool vec4) {
  float acc = 0.0f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    for (int c = q; c < (d >> 2); c += G) {
      const float4 a = x4[c];
      const float4 b = w4[c];
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else {
    for (int c = q; 4 * c < d; c += G) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (4 * c + t < d) {
          acc = fmaf(x[4 * c + t], w[4 * c + t], acc);
        }
      }
    }
  }
  return acc;
}

// z_s[r] = x_r . w for the rows of a staged chunk (of one entity), G lanes
// a row (a fixed butterfly within the group); every lane of a warp runs
// the same rounds, so the shuffles never diverge.
__device__ __forceinline__ void chunk_dot(const float* xs, const float* ws, int rows, int64_t d,
                                          float* z_s) {
  const int G = group_lanes(d);
  const int q = threadIdx.x & (G - 1);
  const int group = threadIdx.x / G;
  const int groups = kBlockedThreads / G;
  const bool vec4 = (d & 3) == 0 && ((reinterpret_cast<uintptr_t>(xs) |
                                      reinterpret_cast<uintptr_t>(ws)) & 15) == 0;
  for (int base = 0; base < rows; base += groups) {
    const int r = base + group;
    float acc = 0.0f;
    if (r < rows) {
      acc = row_dot_part(xs + static_cast<int64_t>(r) * d, ws, static_cast<int>(d), G, q,
                         vec4);
    }
    for (int offset = G >> 1; offset > 0; offset >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, offset);
    }
    if (r < rows && q == 0) {
      z_s[r] = acc;
    }
  }
}

// The loss terms of one row: weight * l and dz = weight * l', exact zeros
// for a row of weight 0 (its loss is never evaluated against the weight).
__device__ __forceinline__ void row_terms(int loss, float z, float y, float weight, float* lw,
                                          float* dz) {
  *lw = 0.0f;
  *dz = 0.0f;
  if (weight > 0.0f) {
    float l, d1;
    loss_terms(loss, z, y, &l, &d1);
    *lw = weight * l;
    *dz = weight * d1;
  }
}

// row_dot_part for a group of G lanes (G from group_lanes(d)): below 32
// lanes each lane holds at most one chunk, so no loop.
template <int G>
__device__ __forceinline__ float group_dot_part(const float* x, const float* w, int d, int q,
                                                bool vec4) {
  if (G == 32) {
    return row_dot_part(x, w, d, G, q, vec4);
  }
  float acc = 0.0f;
  if (vec4) {
    if (q < (d >> 2)) {
      const float4 a = reinterpret_cast<const float4*>(x)[q];
      const float4 b = reinterpret_cast<const float4*>(w)[q];
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (4 * q + t < d) {
        acc = fmaf(x[4 * q + t], w[4 * q + t], acc);
      }
    }
  }
  return acc;
}

// One entity of a staged tile, by one warp, with only warp-level
// synchronisation: xs [s, d], ws [d] and ys / os / wts [s] in shared
// memory, z_w / dz_w [s] the entity's scratch rows. z by G lanes a row;
// the loss terms a lane a row (value and csum as lane partials joined by
// a fixed butterfly); X^T dz by P row parts (P d <= 32 lanes; lane = part
// d + col, each a part's rows in order for one column) joined in a fixed
// tree, or (P = 1) a lane a column over all rows. G and P (functions of d)
// are compile-time, so the lane arithmetic and the shuffles unroll.
template <int G, int P>
__device__ __forceinline__ void warp_entity(const float* xs, const float* ws, const float* ys,
                                            const float* os, const float* wts, int s, int d,
                                            int part, int col, int loss, float* z_w,
                                            float* dz_w, float* __restrict__ value_out,
                                            float* __restrict__ grad_out,
                                            float* __restrict__ csum_out) {
  const int lane = threadIdx.x & 31;
  const int q = lane & (G - 1);
  const bool vec4 = (d & 3) == 0 && ((reinterpret_cast<uintptr_t>(xs) |
                                      reinterpret_cast<uintptr_t>(ws)) & 15) == 0;
  for (int base = 0; base < s; base += 32 / G) {
    const int r = base + lane / G;
    float acc = 0.0f;
    if (r < s) {
      acc = group_dot_part<G>(xs + r * d, ws, d, q, vec4);
    }
#pragma unroll
    for (int offset = G >> 1; offset > 0; offset >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, offset);
    }
    if (r < s && q == 0) {
      z_w[r] = acc;
    }
  }
  __syncwarp();
  float value_acc = 0.0f;
  float csum_acc = 0.0f;
  for (int r = lane; r < s; r += 32) {
    float lw, dz;
    row_terms(loss, z_w[r] + os[r], ys[r], wts[r], &lw, &dz);
    value_acc += lw;
    csum_acc += dz;
    dz_w[r] = dz;
  }
  __syncwarp();
  if (P > 1) {
    const int span = (s + P - 1) / P;
    const int r1 = min(s, (part + 1) * span);
    // two chains (even and odd rows of the part), joined even + odd
    float acc = 0.0f;
    if (part < P) {
      float odd = 0.0f;
      int r = part * span;
#pragma unroll 2
      for (; r + 1 < r1; r += 2) {
        acc = fmaf(dz_w[r], xs[r * d + col], acc);
        odd = fmaf(dz_w[r + 1], xs[(r + 1) * d + col], odd);
      }
      if (r < r1) {
        acc = fmaf(dz_w[r], xs[r * d + col], acc);
      }
      acc += odd;
    }
#pragma unroll
    for (int half = P >> 1; half > 0; half >>= 1) {
      const float other = __shfl_down_sync(0xffffffffu, acc, half * d);
      if (part < half) {
        acc += other;
      }
    }
    if (part == 0) {
      grad_out[col] = acc;
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      float acc = 0.0f;
#pragma unroll 4
      for (int r = 0; r < s; ++r) {
        acc = fmaf(dz_w[r], xs[r * d + j], acc);
      }
      grad_out[j] = acc;
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    value_acc += __shfl_xor_sync(0xffffffffu, value_acc, offset);
    csum_acc += __shfl_xor_sync(0xffffffffu, csum_acc, offset);
  }
  if (lane == 0) {
    *value_out = value_acc;
    *csum_out = csum_acc;
  }
}

// Stage tile t (entities [t k, min(E, t k + k))) into slot.
__device__ __forceinline__ void stage_entity_tile(float* slot, uint64_t* bar,
                                                  const float* __restrict__ X,
                                                  const float* __restrict__ y,
                                                  const float* __restrict__ offsets,
                                                  const float* __restrict__ wt,
                                                  const float* __restrict__ w, int64_t E,
                                                  int64_t s, int64_t d, int64_t k,
                                                  const TileLayout& L, int64_t t) {
  const int64_t e0 = t * k;
  const int64_t kt = E - e0 < k ? E - e0 : k;
  const Bulk spans[5] = {
      stage_edges(slot, X + e0 * s * d, kt * s * d),
      stage_edges(slot + L.y, y + e0 * s, kt * s),
      stage_edges(slot + L.off, offsets + e0 * s, kt * s),
      stage_edges(slot + L.wt, wt + e0 * s, kt * s),
      stage_edges(slot + L.w, w + e0 * d, kt * d),
  };
  stage_spans(spans, bar);
}

template <int G, int P>
__global__ void __launch_bounds__(kBlockedThreads)
batched_tiles_kernel(const float* __restrict__ X, const float* __restrict__ y,
                     const float* __restrict__ offsets, const float* __restrict__ wt,
                     const float* __restrict__ w, float* __restrict__ value,
                     float* __restrict__ grad, float* __restrict__ csum, int64_t E, int64_t s,
                     int64_t d, int64_t k, int loss) {
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;                             // [kTileStages][kTileFloats]
  float* z_s = ring + kTileStages * kTileFloats;  // [kEntityTileMaxRows]
  float* dz_s = z_s + kEntityTileMaxRows;         // [kEntityTileMaxRows]
  __shared__ uint64_t full[kTileStages];
  const int tid = threadIdx.x;
  const TileLayout L = tile_layout(k, s, d);
  const int64_t tiles = (E + k - 1) / k;
  const int64_t first = tiles * blockIdx.x / gridDim.x;
  const int64_t last = tiles * (blockIdx.x + 1) / gridDim.x;
  const int si = static_cast<int>(s);
  const int di = static_cast<int>(d);
  const int part = P > 1 ? (tid & 31) / di : 0;  // this lane's (part, column)
  const int col = (tid & 31) - part * di;

  if (tid == 0) {
    for (int st = 0; st < kTileStages; ++st) {
      barrier_init(&full[st], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int st = 0; st < kTileStages && first + st < last; ++st) {
      stage_entity_tile(ring + st * kTileFloats, &full[st], X, y, offsets, wt, w, E, s, d, k,
                        L, first + st);
    }
  }

  for (int64_t t = first; t < last; ++t) {
    const int64_t kk = t - first;
    const int stage = static_cast<int>(kk % kTileStages);
    float* slot = ring + stage * kTileFloats;
    const int64_t e0 = t * k;
    const int kt = static_cast<int>(E - e0 < k ? E - e0 : k);
    const float* xs = slot + line_offset(X + e0 * s * d);
    const float* ys = slot + L.y + line_offset(y + e0 * s);
    const float* os = slot + L.off + line_offset(offsets + e0 * s);
    const float* wts = slot + L.wt + line_offset(wt + e0 * s);
    const float* ws = slot + L.w + line_offset(w + e0 * d);
    barrier_wait(&full[stage], static_cast<uint32_t>((kk / kTileStages) & 1));

    // a warp an entity of the tile
    for (int el = tid >> 5; el < kt; el += kBlockedWarps) {
      const int rows0 = el * si;
      warp_entity<G, P>(xs + rows0 * di, ws + el * di, ys + rows0, os + rows0, wts + rows0, si,
                        di, part, col, loss, z_s + rows0, dz_s + rows0, value + e0 + el,
                        grad + (e0 + el) * d, csum + e0 + el);
    }
    __syncthreads();  // every thread is done with the slot
    if (tid == 0 && t + kTileStages < last) {
      // the slot's next contents come through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      stage_entity_tile(slot, &full[stage], X, y, offsets, wt, w, E, s, d, k, L,
                        t + kTileStages);
    }
  }
}

// Stage chunk t of the flattened (entity, chunk) list: rows [c R, c R + R)
// of entity t / chunks.
__device__ __forceinline__ void stage_chunk(float* slot, uint64_t* bar,
                                            const float* __restrict__ X, int64_t s, int64_t d,
                                            int64_t R, int64_t chunks, int64_t t) {
  const int64_t e = t / chunks;
  const int64_t r0 = (t - e * chunks) * R;
  const int64_t rows = s - r0 < R ? s - r0 : R;
  const Bulk spans[1] = {stage_edges(slot, X + (e * s + r0) * d, rows * d)};
  stage_spans(spans, bar);
}

__global__ void __launch_bounds__(kBlockedThreads)
batched_rows_kernel(const float* __restrict__ X, const float* __restrict__ y,
                    const float* __restrict__ offsets, const float* __restrict__ wt,
                    const float* __restrict__ w, float* __restrict__ value,
                    float* __restrict__ grad, float* __restrict__ csum, int64_t E, int64_t s,
                    int64_t d, int64_t R, int loss) {
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;                             // [kStages][kSlotStride]
  float* w_s = ring + kStages * kSlotStride;      // [d rounded up to 4]
  float* z_s = w_s + round4(d);                   // [kMaxTileRows]
  float* dz_s = z_s + kMaxTileRows;               // [kMaxTileRows]
  __shared__ uint64_t full[kStages];
  __shared__ float warp_sums[2][kBlockedWarps];
  const int tid = threadIdx.x;
  const int64_t chunks = (s + R - 1) / R;
  const int64_t first = E * blockIdx.x / gridDim.x * chunks;
  const int64_t last = E * (blockIdx.x + 1) / gridDim.x * chunks;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      barrier_init(&full[st], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int st = 0; st < kStages && first + st < last; ++st) {
      stage_chunk(ring + st * kSlotStride, &full[st], X, s, d, R, chunks, first + st);
    }
  }

  float grad_acc[kColsPerThread];
  float value_acc = 0.0f;
  float csum_acc = 0.0f;
  for (int64_t t = first; t < last; ++t) {
    const int64_t kk = t - first;
    const int stage = static_cast<int>(kk % kStages);
    float* slot = ring + stage * kSlotStride;
    const int64_t e = t / chunks;
    const int64_t c = t - e * chunks;
    const int64_t r0 = c * R;
    const int rows = static_cast<int>(s - r0 < R ? s - r0 : R);
    if (c == 0) {
      for (int64_t j = tid; j < d; j += kBlockedThreads) {
        w_s[j] = w[e * d + j];
      }
#pragma unroll
      for (int cc = 0; cc < kColsPerThread; ++cc) {
        grad_acc[cc] = 0.0f;
      }
      value_acc = 0.0f;
      csum_acc = 0.0f;
    }
    // this chunk's row operands, loaded while it lands
    float y_r = 0.0f, off_r = 0.0f, wt_r = 0.0f;
    if (tid < rows) {
      y_r = y[e * s + r0 + tid];
      off_r = offsets[e * s + r0 + tid];
      wt_r = wt[e * s + r0 + tid];
    }
    const float* xs = slot + line_offset(X + (e * s + r0) * d);
    barrier_wait(&full[stage], static_cast<uint32_t>((kk / kStages) & 1));
    if (c == 0) {
      __syncthreads();  // w_s
    }

    chunk_dot(xs, w_s, rows, d, z_s);
    __syncthreads();
    if (tid < rows) {
      float lw, dz;
      row_terms(loss, z_s[tid] + off_r, y_r, wt_r, &lw, &dz);
      value_acc += lw;
      csum_acc += dz;
      dz_s[tid] = dz;
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < kColsPerThread; ++cc) {
      const int64_t j = tid + cc * kBlockedThreads;
      if (j < d) {
        float acc = grad_acc[cc];
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
          acc = fmaf(dz_s[r], xs[r * d + j], acc);
        }
        grad_acc[cc] = acc;
      }
    }
    __syncthreads();  // every thread is done with the slot
    if (tid == 0 && t + kStages < last) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      stage_chunk(slot, &full[stage], X, s, d, R, chunks, t + kStages);
    }
    if (c == chunks - 1) {  // the entity's last chunk
#pragma unroll
      for (int cc = 0; cc < kColsPerThread; ++cc) {
        const int64_t j = tid + cc * kBlockedThreads;
        if (j < d) {
          grad[e * d + j] = grad_acc[cc];
        }
      }
      write_cta_sums(value_acc, csum_acc, warp_sums, value + e, csum + e);
    }
  }
}

size_t tiles_smem_bytes() {
  return sizeof(float) * (kTileStages * kTileFloats + 2 * kEntityTileMaxRows);
}

size_t rows_smem_bytes(int64_t d) {
  return sizeof(float) * (kStages * kSlotStride + round4(d) + 2 * kMaxTileRows);
}

// Whether (mode, per_tile, grid) is a plan the kernels can run for [E, s, d].
bool batched_plan_ok(int64_t E, int64_t s, int64_t d, int mode, int64_t per_tile,
                     int64_t grid) {
  if (grid < 1 || grid > 0x7fffffff) {
    return false;
  }
  if (mode == kModeWarp) {
    return grid <= kMaxBlocks;
  }
  if (s < 1 || d < 1 || d > kRingMaxCols || per_tile < 1) {
    return false;
  }
  if (mode == kModeTiles) {
    return per_tile * s <= kEntityTileMaxRows && tile_layout(per_tile, s, d).end <= kTileFloats;
  }
  return mode == kModeRows && per_tile <= kMaxTileRows && per_tile * d <= kStageFloats;
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers to
// contiguous f32 arrays; stream is a cudaStream_t; loss: 0 logistic,
// 1 squared, 2 Poisson, 3 smoothed hinge. The plan is the wrapper's
// (pallas_kernels.entity_tiling): mode 0 "tiles" (per_tile entities a
// tile), 1 "rows" (per_tile rows a chunk of one entity), 2 "warp", on grid
// CTAs. Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a plan the kernels cannot run.
extern "C" int fused_value_grad_batched_f32(const void* X, const void* y,
                                            const void* offsets, const void* wt,
                                            const void* w, void* value, void* grad,
                                            void* csum, int64_t E, int64_t s,
                                            int64_t d, int loss, int mode, int64_t per_tile,
                                            int64_t grid, void* stream) {
  if (E <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (!batched_plan_ok(E, s, d, mode, per_tile, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* args[5] = {static_cast<const float*>(X), static_cast<const float*>(y),
                          static_cast<const float*>(offsets), static_cast<const float*>(wt),
                          static_cast<const float*>(w)};
  float* out[3] = {static_cast<float*>(value), static_cast<float*>(grad),
                   static_cast<float*>(csum)};
  if (mode == kModeWarp) {
    batched_warp_kernel<<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        args[0], args[1], args[2], args[3], args[4], out[0], out[1], out[2], E, s, d, loss);
    return static_cast<int>(cudaGetLastError());
  }
  using Kernel = void (*)(const float*, const float*, const float*, const float*,
                         const float*, float*, float*, float*, int64_t, int64_t, int64_t,
                         int64_t, int);
  Kernel kernel = batched_rows_kernel;
  if (mode == kModeTiles) {
    // (G, P) as group_lanes(d) and row_parts(d) give them
    switch (group_lanes(d)) {
      case 1:
        kernel = d == 1 ? batched_tiles_kernel<1, 32>
                        : d == 2 ? batched_tiles_kernel<1, 16> : batched_tiles_kernel<1, 8>;
        break;
      case 2:
        kernel = batched_tiles_kernel<2, 4>;
        break;
      case 4:
        kernel = batched_tiles_kernel<4, 2>;
        break;
      case 8:
        kernel = batched_tiles_kernel<8, 1>;
        break;
      case 16:
        kernel = batched_tiles_kernel<16, 1>;
        break;
      default:
        kernel = batched_tiles_kernel<32, 1>;
    }
  }
  const size_t smem_bytes = mode == kModeTiles ? tiles_smem_bytes() : rows_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(grid), kBlockedThreads, smem_bytes, st>>>(
      args[0], args[1], args[2], args[3], args[4], out[0], out[1], out[2], E, s, d, per_tile,
      loss);
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
