// The kernels of a Benes permutation plan (ops/permute_net.py::apply_plan)
// on [m, 128] f32 arrays with int8 stage indices, and the plan's launcher.
//
// Replaces the TPU kernels of photon_ml_tpu/ops/permute_net.py:
//   _lane_shuffle_pallas    (:88, pallas_call :96)
//     out[r, c] = v[r, idx[r, c]],            idx in [0, 128)
//   _sublane_shuffle_pallas (:109, pallas_call :129)
//     out[g*R + i, c] = v[g*R + idx[g*R + i, c], c],   R in {2, 4, 8},
//                                                       idx in [0, R)
// and the Enter/Leave relayouts that the reference's apply_plan (:165-200)
// leaves to XLA between them. The TPU needs the routed network because it
// cannot gather from device memory; each stage there is a within-tile
// gather in vector registers, and a plan of c*128^3 slots makes ten passes
// over device memory (six lane stages, one sublane stage, four relayouts).
//
// Here a plan runs in three passes. Its stages are
//   L E L E ... L [E L S L V] L ... V L V L
// (L a lane stage, S the sublane stage, E/V Enter/Leave of (B, R)); the
// plan compiler (permute_net.compile_plan) groups them into
//
//   lane_relayout_f32  "L E L" or "L V L" around an outer level: a CTA owns
//       a 128 x 128 tile. For Enter(B, R) it is 128 consecutive old rows of
//       one block (b R + g 128 + s); new row (b, col, g), at b R + col R/128
//       + g, is column col of those rows. Leave is the same map read the
//       other way (128 strided rows in, 128 consecutive rows out). With
//       out[o][k] = y1[s][o], s = B[o][k] and y1[s][o] = x[s][A[s][o]], the
//       kernel copies the tile and A's rows into shared memory (cp.async),
//       holds B's rows in registers, and computes each output row as two
//       shared-memory lookups, written as one coalesced 512-byte store.
//       With no relayout it is the standalone lane shuffle (K4), 32 rows a
//       CTA (many CTAs a SM: no short last wave), out[o][k] = x[o][A[o][k]].
//   inner_shuffle_f32  "E L S L V", the innermost level Enter(B, c 128): a
//       CTA owns block b, all c 128 of its old rows and 16 of its columns;
//       new rows (b, col, g < c) are column col of old rows g 128 + j, so
//       both lane stages, the sublane select across g and the Leave stay in
//       the CTA. The [c 128, 16] region is copied to shared memory
//       transposed (4-byte cp.async: a column a shared row), a warp takes a
//       column: lane gather, the register-only select of the reference
//       (permute_net.py:114-127, unrolled over c), lane gather, written
//       back in place and stored by rows of 16 floats. With no relayout it
//       runs on groups of c whole rows, a warp a group (a plan of c 128
//       slots); with the sublane stage alone it is the standalone K5, in
//       registers only (an instantiation of its own: a quarter of the
//       registers the three-stage body takes, so more warps a SM).
//
// Bound: bytes moved, no arithmetic. A lane shuffle reads 4 B and a 1 B
// index and writes 4 B an element; lane_relayout_f32 10 B (two indices),
// inner_shuffle_f32 11 B (three). A plan of S slots moves 31 S bytes in
// three passes where the stage-by-stage plan moved 95 S (six 9-byte lane
// passes, one 9-byte sublane pass, four 8-byte copies).
//
// Shared-memory layout: tile rows are 132 floats apart (16-byte aligned for
// the copies, and a column read at random rows spreads over the banks), A's
// rows 132 bytes apart; the inner kernel's column rows c 128 + 4 floats.
// Every value is moved, never combined, so each kernel equals the
// composition of the plain stages bitwise. Indices are masked into range
// (& 127, & (c-1)) so that a malformed plan cannot read outside its tile;
// a plan built by ops/routing.py never needs the mask. The kernels
// allocate nothing and run on the caller's stream; apply_plan_f32 launches
// every group of a plan back to back from here, ping-ponging between two
// buffers the caller allocates.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 128;            // lane_relayout: rows of a relayout's tile
constexpr int kLaneTileRows = 32;         // rows of a tile with no relayout
constexpr int kRowPitch = kLanes + 4;     // floats between tile rows in shared memory
constexpr int kIdxPitch = kLanes + 4;     // bytes between index rows in shared memory
constexpr int kInnerCols = 16;            // inner_shuffle: columns a CTA owns
constexpr int64_t kMaxGroupBlocks = 1 << 16;
constexpr int kMaxDevices = 64;

// kSublane: inner_shuffle_kernel with the sublane stage alone (no shared
// memory, fewer registers: an instantiation of its own)
enum Relayout : int { kNone = 0, kEnter = 1, kLeave = 2, kSublane = 3 };
enum Kernel : int { kLaneRelayout = 0, kInnerShuffle = 1 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies (completed by copies_wait).
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ char4 load_idx4(const int8_t* __restrict__ row, int lane) {
  return reinterpret_cast<const char4*>(row)[lane];
}

// ------------------------------------------------------------ lane_relayout

// First input row and stride of tile t, and first output row and stride:
// Enter(B, R) reads 128 consecutive old rows b R + g 128 + s and writes new
// rows b R + o R/128 + g; Leave the reverse; no relayout rows t 128 + s.
struct TileRows {
  int64_t in_base, in_stride, out_base, out_stride;
};

__device__ __forceinline__ TileRows tile_rows(int mode, int64_t t, int64_t rows) {
  if (mode == kNone) {
    return {t * kLaneTileRows, 1, t * kLaneTileRows, 1};
  }
  const int64_t per_block = rows / kTileRows;
  const int64_t b = t / per_block, g = t % per_block;
  const int64_t consecutive = b * rows + g * kTileRows;
  const int64_t strided = b * rows + g;
  if (mode == kEnter) {
    return {consecutive, 1, strided, per_block};
  }
  return {strided, per_block, consecutive, 1};
}

// One tile a CTA: TR = 32 rows with no relayout (MODE kNone: out[o][k] =
// v[o][row_idx[o][k]]; small tiles, many CTAs a SM), TR = 128 for kEnter /
// kLeave: out[o][k] = v[s][col_idx[s][o]], s = row_idx[o][k] (row indices
// of the input rows s and output rows o as tile_rows says; either index
// array may be null: the identity stage).
template <int MODE, int TR = MODE == kNone ? kLaneTileRows : kTileRows>
__global__ void __launch_bounds__(kThreads)
lane_relayout_kernel(const float* __restrict__ v, const int8_t* __restrict__ col_idx,
                     const int8_t* __restrict__ row_idx, float* __restrict__ out, int64_t m,
                     int64_t rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  int8_t* first = reinterpret_cast<int8_t*>(smem + sizeof(float) * TR * kRowPitch);
  constexpr int kRowsPerWarp = TR / kWarps;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x;
  const TileRows tr = tile_rows(MODE, t, rows);
  const int64_t left = m - t * TR;
  const int n_rows = MODE == kNone && left < TR ? static_cast<int>(left) : TR;
  const bool has_col = MODE != kNone && col_idx != nullptr;
  const bool has_row = row_idx != nullptr;

  // the tile (and the first stage's rows) by asynchronous copies
#pragma unroll 4
  for (int e = threadIdx.x; e < n_rows * 32; e += kThreads) {
    const int s = e >> 5, q = e & 31;
    const int64_t row = tr.in_base + s * tr.in_stride;
    copy16(tile + s * kRowPitch + 4 * q, v + row * kLanes + 4 * q);
    if (has_col) {
      copy4(first + s * kIdxPitch + 4 * q, col_idx + row * kLanes + 4 * q);
    }
  }
  // meanwhile the indices read by output row into registers
  char4 sel[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int o = warp + kWarps * i;
    sel[i] = make_char4(4 * lane, 4 * lane + 1, 4 * lane + 2, 4 * lane + 3);
    if (has_row && o < n_rows) {
      sel[i] = load_idx4(row_idx + (tr.out_base + o * tr.out_stride) * kLanes, lane);
    }
  }
  copies_wait();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int o = warp + kWarps * i;
    if (o >= n_rows) {
      break;
    }
    const int s0 = sel[i].x & (kLanes - 1), s1 = sel[i].y & (kLanes - 1),
              s2 = sel[i].z & (kLanes - 1), s3 = sel[i].w & (kLanes - 1);
    float4 y;
    if (MODE == kNone) {
      const float* src = tile + o * kRowPitch;
      y.x = src[s0];
      y.y = src[s1];
      y.z = src[s2];
      y.w = src[s3];
    } else if (has_col) {
      y.x = tile[s0 * kRowPitch + (first[s0 * kIdxPitch + o] & (kLanes - 1))];
      y.y = tile[s1 * kRowPitch + (first[s1 * kIdxPitch + o] & (kLanes - 1))];
      y.z = tile[s2 * kRowPitch + (first[s2 * kIdxPitch + o] & (kLanes - 1))];
      y.w = tile[s3 * kRowPitch + (first[s3 * kIdxPitch + o] & (kLanes - 1))];
    } else {
      y.x = tile[s0 * kRowPitch + o];
      y.y = tile[s1 * kRowPitch + o];
      y.z = tile[s2 * kRowPitch + o];
      y.w = tile[s3 * kRowPitch + o];
    }
    reinterpret_cast<float4*>(out + (tr.out_base + o * tr.out_stride) * kLanes)[lane] = y;
  }
}

size_t lane_relayout_smem(int mode, bool has_col) {
  const int rows = mode == kNone ? kLaneTileRows : kTileRows;
  return sizeof(float) * rows * kRowPitch + (has_col ? rows * kIdxPitch : 0);
}

// -------------------------------------------------------------- inner_shuffle

// x[g] (lane's four columns 4 lane .. of row g of a group of C rows) after
// the sublane select y[i][c] = x[sel[i][c]][c]: registers only.
template <int C>
__device__ __forceinline__ void sublane_select(float4 (&x)[C], const char4 (&sel)[C]) {
  float4 y[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int sx = sel[i].x & (C - 1), sy = sel[i].y & (C - 1), sz = sel[i].z & (C - 1),
              sw = sel[i].w & (C - 1);
    y[i] = x[0];
#pragma unroll
    for (int k = 1; k < C; ++k) {
      y[i].x = sx == k ? x[k].x : y[i].x;
      y[i].y = sy == k ? x[k].y : y[i].y;
      y[i].z = sz == k ? x[k].z : y[i].z;
      y[i].w = sw == k ? x[k].w : y[i].w;
    }
  }
#pragma unroll
  for (int i = 0; i < C; ++i) {
    x[i] = y[i];
  }
}

// Lane gather of a group held as C rows of 128 at `rows` in shared memory
// (the warp's own): x[g][c] = rows[g][sel[g][c]].
template <int C>
__device__ __forceinline__ void gather_rows(float4 (&x)[C], const float* rows,
                                            const char4 (&sel)[C]) {
#pragma unroll
  for (int g = 0; g < C; ++g) {
    const float* r = rows + g * kLanes;
    x[g].x = r[sel[g].x & (kLanes - 1)];
    x[g].y = r[sel[g].y & (kLanes - 1)];
    x[g].z = r[sel[g].z & (kLanes - 1)];
    x[g].w = r[sel[g].w & (kLanes - 1)];
  }
}

template <int C>
__device__ __forceinline__ void put_rows(float* rows, const float4 (&x)[C], int lane) {
#pragma unroll
  for (int g = 0; g < C; ++g) {
    reinterpret_cast<float4*>(rows + g * kLanes)[lane] = x[g];
  }
}

template <int C>
__device__ __forceinline__ void load_sel(char4 (&sel)[C], const int8_t* __restrict__ idx,
                                         int lane) {
#pragma unroll
  for (int g = 0; g < C; ++g) {
    sel[g] = idx != nullptr ? load_idx4(idx + g * kLanes, lane) : make_char4(0, 0, 0, 0);
  }
}

// L (a) -> S (s) -> L (b) on a group of C rows that the warp holds in x
// and, for the lane gathers, in `rows` (its own shared rows, holding x on
// entry). Leaves the result in x and in `rows`.
template <int C>
__device__ __forceinline__ void group_stages(float4 (&x)[C], float* rows,
                                             const char4 (&sa)[C], const char4 (&ss)[C],
                                             const char4 (&sb)[C], bool has_a, bool has_s,
                                             bool has_b, int lane) {
  if (has_a) {
    gather_rows<C>(x, rows, sa);
  }
  if (C > 1 && has_s) {
    sublane_select<C>(x, ss);
  }
  if (has_b) {
    __syncwarp();
    put_rows<C>(rows, x, lane);
    __syncwarp();
    gather_rows<C>(x, rows, sb);
  }
}

// MODE kNone: groups of C whole rows, a warp a group (grid-stride); the
// warp's C shared rows only when a lane stage is present. kSublane: the
// same groups, the sublane stage alone, in registers (the standalone K5).
// MODE kEnter: Enter(B, C 128) -> L -> S -> L -> Leave; CTA (b, slice)
// owns old rows b C 128 .. + C 128 and columns slice 16 .. + 16.
template <int C, int MODE>
__global__ void __launch_bounds__(kThreads)
inner_shuffle_kernel(const float* __restrict__ v, const int8_t* __restrict__ la,
                     const int8_t* __restrict__ sub, const int8_t* __restrict__ lb,
                     float* __restrict__ out, int64_t m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool has_a = la != nullptr, has_s = sub != nullptr, has_b = lb != nullptr;
  char4 sa[C], ss[C], sb[C];
  float4 x[C];
  if (MODE == kSublane) {
    const int64_t groups = m / C;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
    for (int64_t grp = static_cast<int64_t>(blockIdx.x) * kWarps + warp; grp < groups;
         grp += stride) {
      const int64_t base = grp * C * kLanes;
#pragma unroll
      for (int g = 0; g < C; ++g) {
        x[g] = reinterpret_cast<const float4*>(v + base + g * kLanes)[lane];
      }
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const char4 s = load_idx4(sub + base + i * kLanes, lane);
        const int sx = s.x & (C - 1), sy = s.y & (C - 1), sz = s.z & (C - 1),
                  sw = s.w & (C - 1);
        float4 y = x[0];
#pragma unroll
        for (int k = 1; k < C; ++k) {
          y.x = sx == k ? x[k].x : y.x;
          y.y = sy == k ? x[k].y : y.y;
          y.z = sz == k ? x[k].z : y.z;
          y.w = sw == k ? x[k].w : y.w;
        }
        reinterpret_cast<float4*>(out + base + i * kLanes)[lane] = y;
      }
    }
    return;
  }
  if (MODE == kNone) {
    float* rows = reinterpret_cast<float*>(smem) + warp * C * kLanes;
    const int64_t groups = m / C;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
    for (int64_t grp = static_cast<int64_t>(blockIdx.x) * kWarps + warp; grp < groups;
         grp += stride) {
      const int64_t base = grp * C * kLanes;
#pragma unroll
      for (int g = 0; g < C; ++g) {
        x[g] = reinterpret_cast<const float4*>(v + base + g * kLanes)[lane];
      }
      load_sel<C>(sa, has_a ? la + base : nullptr, lane);
      load_sel<C>(ss, has_s ? sub + base : nullptr, lane);
      load_sel<C>(sb, has_b ? lb + base : nullptr, lane);
      if (has_a) {
        __syncwarp();  // the previous group's reads of rows are done
        put_rows<C>(rows, x, lane);
        __syncwarp();
      }
      group_stages<C>(x, rows, sa, ss, sb, has_a, has_s, has_b, lane);
#pragma unroll
      for (int g = 0; g < C; ++g) {
        reinterpret_cast<float4*>(out + base + g * kLanes)[lane] = x[g];
      }
    }
    return;
  }

  constexpr int kPitch = C * kLanes + 4;  // floats between column rows
  constexpr int kSlices = kLanes / kInnerCols;
  constexpr int64_t kRows = C * kLanes;   // old rows of a block
  float* cols = reinterpret_cast<float*>(smem);
  const int64_t b = blockIdx.x / kSlices;
  const int col0 = static_cast<int>(blockIdx.x % kSlices) * kInnerCols;
  const float* src = v + b * kRows * kLanes + col0;
  // old rows r of the block, columns col0 .. + 16, into column rows
#pragma unroll 8
  for (int e = threadIdx.x; e < kRows * kInnerCols; e += kThreads) {
    const int r = e / kInnerCols, c = e % kInnerCols;
    copy4(cols + c * kPitch + r, src + static_cast<int64_t>(r) * kLanes + c);
  }
  copies_wait();
  __syncthreads();
  for (int c = warp; c < kInnerCols; c += kWarps) {
    float* rows = cols + c * kPitch;
    // the group's new rows (b, col0 + c, g < C) and their indices
    const int64_t ib = (b * kRows + static_cast<int64_t>(col0 + c) * C) * kLanes;
    load_sel<C>(sa, has_a ? la + ib : nullptr, lane);
    load_sel<C>(ss, has_s ? sub + ib : nullptr, lane);
    load_sel<C>(sb, has_b ? lb + ib : nullptr, lane);
    if (!has_a) {
#pragma unroll
      for (int g = 0; g < C; ++g) {
        x[g] = reinterpret_cast<const float4*>(rows + g * kLanes)[lane];
      }
    }
    group_stages<C>(x, rows, sa, ss, sb, has_a, has_s, has_b, lane);
    __syncwarp();
    put_rows<C>(rows, x, lane);
  }
  __syncthreads();
  float* dst = out + b * kRows * kLanes + col0;
#pragma unroll 8
  for (int e = threadIdx.x; e < kRows * kInnerCols; e += kThreads) {
    const int r = e / kInnerCols, c = e % kInnerCols;
    dst[static_cast<int64_t>(r) * kLanes + c] = cols[c * kPitch + r];
  }
}

size_t inner_smem(int c, int mode, bool lanes) {
  if (mode == kSublane) {
    return 0;
  }
  if (mode == kEnter) {
    return sizeof(float) * kInnerCols * (c * kLanes + 4);
  }
  return lanes ? sizeof(float) * kWarps * c * kLanes : 0;
}

// ------------------------------------------------------------------- host

// One launch of a plan, as permute_net.PlanGroup describes it (every field
// 8 bytes: the ctypes structure has no padding to agree on).
struct PlanGroup {
  int64_t kernel;    // kLaneRelayout or kInnerShuffle
  int64_t relayout;  // lane: kNone / kEnter / kLeave; inner: kNone / kEnter (Enter .. Leave)
  int64_t blocks;    // B of the relayout
  int64_t rows;      // lane: R of the relayout; inner: C, the sublane group
  const void* a;     // first lane stage, or null
  const void* s;     // sublane stage (inner), or null
  const void* b;     // second lane stage, or null
};

// The largest dynamic shared memory each kernel may take, set once a device
// (the attribute belongs to the device's context); slot names the kernel.
std::atomic<uint64_t> g_smem_set[16];

template <class K>
cudaError_t allow_smem(K kernel, int slot, size_t bytes) {
  if (bytes <= 48 * 1024) {
    return cudaSuccess;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    return err;
  }
  const uint64_t bit = uint64_t{1} << (dev % kMaxDevices);
  if (g_smem_set[slot].load(std::memory_order_relaxed) & bit) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) {
    g_smem_set[slot].fetch_or(bit, std::memory_order_relaxed);
  }
  return err;
}

template <int MODE>
cudaError_t launch_lane(const PlanGroup& g, const float* in, float* out, int64_t m,
                        cudaStream_t st) {
  // the largest size this instantiation takes: tile and first-stage rows
  const size_t max_bytes = lane_relayout_smem(MODE, MODE != kNone);
  cudaError_t err = allow_smem(lane_relayout_kernel<MODE>, MODE, max_bytes);
  if (err != cudaSuccess) {
    return err;
  }
  const int8_t* col_idx = MODE == kNone ? nullptr : static_cast<const int8_t*>(g.a);
  const int8_t* row_idx = static_cast<const int8_t*>(MODE == kNone ? g.a : g.b);
  const int tile_rows = MODE == kNone ? kLaneTileRows : kTileRows;
  const int64_t tiles = (m + tile_rows - 1) / tile_rows;
  lane_relayout_kernel<MODE><<<static_cast<unsigned>(tiles), kThreads,
                               lane_relayout_smem(MODE, col_idx != nullptr), st>>>(
      in, col_idx, row_idx, out, m, g.rows);
  return cudaGetLastError();
}

template <int C, int MODE>
cudaError_t launch_inner(const PlanGroup& g, const float* in, float* out, int64_t m,
                         cudaStream_t st) {
  const bool lanes = g.a != nullptr || g.b != nullptr;
  const size_t bytes = inner_smem(C, MODE, lanes);
  // slots 3 .. 10: after the three lane modes, two a sublane group size
  // (kSublane takes no shared memory)
  constexpr int kSlot = 3 + 2 * (C == 1 ? 0 : C == 2 ? 1 : C == 4 ? 2 : 3) + (MODE == kEnter);
  cudaError_t err = allow_smem(inner_shuffle_kernel<C, MODE>, kSlot, inner_smem(C, MODE, true));
  if (err != cudaSuccess) {
    return err;
  }
  int64_t grid;
  if (MODE != kEnter) {
    const int64_t groups = m / C;
    grid = (groups + kWarps - 1) / kWarps;
    grid = grid > kMaxGroupBlocks ? kMaxGroupBlocks : grid;
  } else {
    grid = g.blocks * (kLanes / kInnerCols);
  }
  inner_shuffle_kernel<C, MODE><<<static_cast<unsigned>(grid), kThreads, bytes, st>>>(
      in, static_cast<const int8_t*>(g.a), static_cast<const int8_t*>(g.s),
      static_cast<const int8_t*>(g.b), out, m);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launch one group on m rows: checks its shape against m, then its kernel.
cudaError_t launch_group(const PlanGroup& g, const float* in, float* out, int64_t m,
                         cudaStream_t st) {
  if (!aligned16(in) || !aligned16(out) || !aligned16(g.a) || !aligned16(g.s) ||
      !aligned16(g.b)) {
    return cudaErrorMisalignedAddress;
  }
  if (g.kernel == kLaneRelayout) {
    if (g.relayout == kNone) {
      if (g.a == nullptr || g.b != nullptr || g.s != nullptr) {
        return cudaErrorInvalidValue;
      }
      return launch_lane<kNone>(g, in, out, m, st);
    }
    if (g.rows <= 0 || g.rows % kTileRows != 0 || g.blocks * g.rows != m || g.s != nullptr) {
      return cudaErrorInvalidValue;
    }
    return g.relayout == kEnter ? launch_lane<kEnter>(g, in, out, m, st)
                                : g.relayout == kLeave ? launch_lane<kLeave>(g, in, out, m, st)
                                                       : cudaErrorInvalidValue;
  }
  if (g.kernel != kInnerShuffle) {
    return cudaErrorInvalidValue;
  }
  const int64_t c = g.rows;
  if (c != 1 && c != 2 && c != 4 && c != 8) {
    return cudaErrorInvalidValue;
  }
  if (g.relayout == kNone) {
    if (m % c != 0) {
      return cudaErrorInvalidValue;
    }
    if (g.a == nullptr && g.b == nullptr && g.s != nullptr) {
      switch (c) {
        case 2: return launch_inner<2, kSublane>(g, in, out, m, st);
        case 4: return launch_inner<4, kSublane>(g, in, out, m, st);
        case 8: return launch_inner<8, kSublane>(g, in, out, m, st);
        default: break;  // one row a group: the general kernel
      }
    }
    switch (c) {
      case 1: return launch_inner<1, kNone>(g, in, out, m, st);
      case 2: return launch_inner<2, kNone>(g, in, out, m, st);
      case 4: return launch_inner<4, kNone>(g, in, out, m, st);
      default: return launch_inner<8, kNone>(g, in, out, m, st);
    }
  }
  if (g.relayout != kEnter || g.blocks * c * kLanes != m) {
    return cudaErrorInvalidValue;
  }
  switch (c) {
    case 1: return launch_inner<1, kEnter>(g, in, out, m, st);
    case 2: return launch_inner<2, kEnter>(g, in, out, m, st);
    case 4: return launch_inner<4, kEnter>(g, in, out, m, st);
    default: return launch_inner<8, kEnter>(g, in, out, m, st);
  }
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers, 16-byte
// aligned, of [m, 128] f32 arrays and int8 indices of the same shape;
// stream is a cudaStream_t. Each returns cudaGetLastError() after its
// launches (0 on success), or the error that stopped it: a shape that does
// not fit the group, a misaligned pointer, or a refused shared-memory size.

// out[r, c] = v[r, idx[r, c]] (the standalone lane shuffle, K4).
extern "C" int lane_shuffle_f32(const void* v, const void* idx, void* out, int64_t m,
                                void* stream) {
  if (m <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const PlanGroup g{kLaneRelayout, kNone, 0, 0, idx, nullptr, nullptr};
  return static_cast<int>(launch_group(g, static_cast<const float*>(v),
                                       static_cast<float*>(out), m,
                                       static_cast<cudaStream_t>(stream)));
}

// m rows in groups of `rows` (2, 4 or 8; m a multiple of it): the
// standalone sublane shuffle (K5).
extern "C" int sublane_shuffle_f32(const void* v, const void* idx, void* out, int64_t m,
                                   int rows, void* stream) {
  if (m <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (rows != 2 && rows != 4 && rows != 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PlanGroup g{kInnerShuffle, kNone, 0, rows, nullptr, idx, nullptr};
  return static_cast<int>(launch_group(g, static_cast<const float*>(v),
                                       static_cast<float*>(out), m,
                                       static_cast<cudaStream_t>(stream)));
}

// First lane stage a (on the input rows, or null), relayout (1 Enter, 2
// Leave) of `blocks` blocks of `rows` rows, second lane stage b (on the
// output rows, or null).
extern "C" int lane_relayout_f32(const void* v, const void* a, const void* b, void* out,
                                 int64_t m, int relayout, int64_t blocks, int64_t rows,
                                 void* stream) {
  if (m <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (relayout != kEnter && relayout != kLeave) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PlanGroup g{kLaneRelayout, relayout, blocks, rows, a, nullptr, b};
  return static_cast<int>(launch_group(g, static_cast<const float*>(v),
                                       static_cast<float*>(out), m,
                                       static_cast<cudaStream_t>(stream)));
}

// Lane stage a, sublane stage s in groups of `rows` (1, 2, 4 or 8), lane
// stage b (each may be null), inside Enter(blocks, rows 128) .. Leave when
// blocks > 0, on groups of `rows` whole rows when blocks is 0.
extern "C" int inner_shuffle_f32(const void* v, const void* a, const void* s, const void* b,
                                 void* out, int64_t m, int64_t rows, int64_t blocks,
                                 void* stream) {
  if (m <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const PlanGroup g{kInnerShuffle, blocks > 0 ? kEnter : kNone, blocks, rows, a, s, b};
  return static_cast<int>(launch_group(g, static_cast<const float*>(v),
                                       static_cast<float*>(out), m,
                                       static_cast<cudaStream_t>(stream)));
}

// A whole plan: group i reads x (i = 0) or buffer (i - 1) % 2 and writes
// buffer i % 2, so the result is in buffer (n_groups - 1) % 2; buf1 may be
// null for one group. The launches go back to back on the stream.
extern "C" int apply_plan_f32(const void* x, void* buf0, void* buf1, int64_t m,
                              const void* groups, int64_t n_groups, void* stream) {
  if (m <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (n_groups > 1 && buf1 == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PlanGroup* gs = static_cast<const PlanGroup*>(groups);
  float* bufs[2] = {static_cast<float*>(buf0), static_cast<float*>(buf1)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int64_t i = 0; i < n_groups; ++i) {
    const float* in = i == 0 ? static_cast<const float*>(x) : bufs[(i - 1) % 2];
    const cudaError_t err = launch_group(gs[i], in, bufs[i % 2], m, st);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by the entry points above.
extern "C" const char* permute_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
