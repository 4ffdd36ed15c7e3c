// lane_shuffle_f32 and sublane_shuffle_f32: the two stage kernels of a
// Benes permutation plan (ops/permute_net.py::apply_plan), on [m, 128] f32
// arrays with int8 stage indices.
//
// Replaces the TPU kernels of photon_ml_tpu/ops/permute_net.py:
//   _lane_shuffle_pallas    (:88, pallas_call :96)  -> lane_shuffle_f32
//     out[r, c] = v[r, idx[r, c]],            idx in [0, 128)
//   _sublane_shuffle_pallas (:109, pallas_call :129) -> sublane_shuffle_f32
//     out[g*R + i, c] = v[g*R + idx[g*R + i, c], c],   R in {2, 4, 8},
//                                                       idx in [0, R)
// The TPU needs the routed network because it cannot gather from device
// memory; each stage there is a within-tile gather in vector registers.
//
// Bound: bytes moved. Each element is read once (4 B), its index read once
// (1 B) and the output written once (4 B): 9 bytes an element, 1152 bytes a
// row; no arithmetic. At m = 2^17 rows that is 151 MB, 0.045 ms at 3.35 TB/s.
//
// Design. lane_shuffle_f32: one warp a row. The warp loads the row's 512
// bytes with one coalesced float4 load a lane into shared memory, and its
// 128 int8 indices as one 4-byte load a lane; each lane then gathers its
// four outputs from shared memory and writes them with one coalesced float4
// store. sublane_shuffle_f32: one thread per (group, four columns); it loads
// the group's R source float4s of its columns into registers (coalesced
// across the warp's 32 column quads), and for each output row selects per
// component by the index, unrolled over R so the values stay in registers
// (the Pallas body's loop-free select, permute_net.py:114-127). Both move
// values without arithmetic, so they equal their plain versions bitwise.
// Indices are masked into range (& 127, & (R-1)) so that a malformed plan
// cannot read outside the row or group; a plan built by ops/routing.py
// never needs the mask. Grid-stride loops let any m run. The kernels
// allocate nothing and run on the caller's stream.
//
// Left to a later change: fusing the stages of a plan (and the Enter/Leave
// transposes between them) into fewer passes over device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int64_t kMaxBlocks = 1 << 16;

__global__ void __launch_bounds__(kThreads)
lane_shuffle_f32_kernel(const float* __restrict__ v,
                        const int8_t* __restrict__ idx,
                        float* __restrict__ out,
                        int64_t m) {
  __shared__ float rows[kWarpsPerBlock][kLanes];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* row = rows[warp];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp; r < m;
       r += stride) {
    const float4 x = reinterpret_cast<const float4*>(v + r * kLanes)[lane];
    const char4 s = reinterpret_cast<const char4*>(idx + r * kLanes)[lane];
    reinterpret_cast<float4*>(row)[lane] = x;
    __syncwarp();
    float4 y;
    y.x = row[s.x & (kLanes - 1)];
    y.y = row[s.y & (kLanes - 1)];
    y.z = row[s.z & (kLanes - 1)];
    y.w = row[s.w & (kLanes - 1)];
    reinterpret_cast<float4*>(out + r * kLanes)[lane] = y;
    __syncwarp();  // the row buffer is refilled by the next iteration
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
sublane_shuffle_f32_kernel(const float* __restrict__ v,
                           const int8_t* __restrict__ idx,
                           float* __restrict__ out,
                           int64_t groups) {
  constexpr int kQuads = kLanes / 4;  // float4 column quads a row
  const int64_t total = groups * kQuads;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t base = (t / kQuads) * R * kLanes;
    const int q = static_cast<int>(t % kQuads);
    const float4* src = reinterpret_cast<const float4*>(v + base) + q;
    const char4* sel = reinterpret_cast<const char4*>(idx + base) + q;
    float4* dst = reinterpret_cast<float4*>(out + base) + q;
    float4 x[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      x[k] = src[k * kQuads];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const char4 s = sel[i * kQuads];
      const int sx = s.x & (R - 1), sy = s.y & (R - 1), sz = s.z & (R - 1),
                sw = s.w & (R - 1);
      float4 y = x[0];
#pragma unroll
      for (int k = 1; k < R; ++k) {
        y.x = sx == k ? x[k].x : y.x;
        y.y = sy == k ? x[k].y : y.y;
        y.z = sz == k ? x[k].z : y.z;
        y.w = sw == k ? x[k].w : y.w;
      }
      dst[i * kQuads] = y;
    }
  }
}

int64_t blocks_for(int64_t work_items, int64_t items_per_block) {
  int64_t blocks = (work_items + items_per_block - 1) / items_per_block;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers (v, idx and
// out 16-byte aligned, rows of 128 contiguous elements); stream is a
// cudaStream_t. Each returns cudaGetLastError() after its launch (0 on
// success).
extern "C" int lane_shuffle_f32(const void* v, const void* idx, void* out, int64_t m,
                                void* stream) {
  if (m <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  lane_shuffle_f32_kernel<<<static_cast<unsigned>(blocks_for(m, kWarpsPerBlock)), kThreads,
                            0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const int8_t*>(idx),
      static_cast<float*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

// m rows in groups of `rows` (2, 4 or 8; m a multiple of it).
extern "C" int sublane_shuffle_f32(const void* v, const void* idx, void* out, int64_t m,
                                   int rows, void* stream) {
  if (m <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if ((rows != 2 && rows != 4 && rows != 8) || m % rows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t groups = m / rows;
  const unsigned blocks = static_cast<unsigned>(blocks_for(groups * (kLanes / 4), kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* vf = static_cast<const float*>(v);
  const int8_t* ix = static_cast<const int8_t*>(idx);
  float* of = static_cast<float*>(out);
  if (rows == 2) {
    sublane_shuffle_f32_kernel<2><<<blocks, kThreads, 0, s>>>(vf, ix, of, groups);
  } else if (rows == 4) {
    sublane_shuffle_f32_kernel<4><<<blocks, kThreads, 0, s>>>(vf, ix, of, groups);
  } else {
    sublane_shuffle_f32_kernel<8><<<blocks, kThreads, 0, s>>>(vf, ix, of, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by lane_shuffle_f32 / sublane_shuffle_f32.
extern "C" const char* permute_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
