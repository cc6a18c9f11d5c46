// K6: embedding bag (sum pooling), for sm_90a.
//
// Replaces: src/repro/kernels/embedding_bag.py::_kernel, launched by
// embedding_bag (pl.pallas_call over the grid (B, hot) with the ids
// scalar-prefetched: each grid step DMAs one (1, D) table row picked by the
// index map and adds it into the bag's output block, revisited across the
// bag axis, in the table's own dtype).
//
// What bounds it on the H100: bytes.  A bag of `hot` rows does (hot - 1) * D
// additions on hot * D values read, well under one operation per byte, so
// the least time is the rows read (each distinct row once), the ids and the
// (B, D) output over 3.35 TB/s.  At the DLRM serving batch (B = 262144,
// D = 128, f32, hot 1) a table writes 134 MB and reads at most as much.
//
// What the design does about it: one warp owns one bag and a block holds
// several bags (the caller's geometry), so there is no grid over the bag
// axis and nothing carries over between blocks.  Each lane loads 16 bytes of
// a row at a time (4 f32 or 8 bf16 values), so a warp reads 512 contiguous
// bytes per load and a D = 128 f32 row is one coalesced load; a loop over
// column chunks covers any D.  Where a row does not start on a 16-byte
// boundary (D not a multiple of the vector width) every lane loads single
// values instead.  The lanes load up to 32 of the bag's ids at once, check
// each against [0, V) (an id outside it traps: the TPU kernel would read out
// of bounds), and pass them round with __shfl_sync; four rows are loaded
// before the first of them is added, so four loads are in flight per lane.
// Row offsets are (int64) id * D: a 20M-row table at D = 128 is 2.56e9
// elements.  The ids may be a strided view (a table's slice of the (B, 26,
// hot) sparse features) and the output a strided view (the table's slot of
// the (B, 27, D) interaction features), so neither is copied.
//
// The numbers follow the TPU kernel exactly: rows h = 0 .. hot - 1 are added
// in that order into a sum that starts at zero, in the table's dtype; a bf16
// sum is rounded to nearest after every addition.  So the kernel is
// bit-identical to the sequential plain version, in f32 and in bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ebag {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kInFlight = 4;  // rows loaded before the first is added

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
// One addition in the table's dtype T.  The running sum is a float that
// always holds a value of T: a bf16 sum is rounded to nearest after each add.
template <typename T> __device__ __forceinline__ float add_in(float acc, float v);
template <> __device__ __forceinline__ float add_in<float>(float acc, float v) { return acc + v; }
template <> __device__ __forceinline__ float add_in<__nv_bfloat16>(float acc, float v) {
  return __bfloat162float(__float2bfloat16_rn(acc + v));
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC values of T starting at p (16-byte aligned when VEC > 1).
template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Chunk {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Chunk<T, VEC> load(const T* p) {
  Chunk<T, VEC> c;
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(c.v) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) c.v[i] = p[i];
  }
  return c;
}

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(float (&acc)[VEC], const Chunk<T, VEC>& c) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = add_in<T>(acc[i], to_f32(c.v[i]));
}

template <typename T, int VEC>
__global__ void embedding_bag_kernel(const T* __restrict__ table, const int32_t* __restrict__ ids,
                                     T* __restrict__ out, int64_t v, int d, int b, int hot,
                                     int64_t id_stride, int64_t out_stride) {
  const int lane = threadIdx.x & 31;
  const int64_t bag = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (bag >= b) return;  // the whole warp leaves together
  const int32_t* bag_ids = ids + bag * id_stride;
  T* bag_out = out + bag * out_stride;
  // Every lane runs every iteration below (the shuffles need the full warp);
  // lanes whose columns lie past D load and store nothing.
  for (int base = 0; base < d; base += 32 * VEC) {
    const int col = base + lane * VEC;
    const bool active = col < d;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    for (int h0 = 0; h0 < hot; h0 += 32) {
      const int n = min(32, hot - h0);
      int32_t mine = 0;
      if (lane < n) {
        mine = __ldg(bag_ids + h0 + lane);
        if (mine < 0 || (int64_t)mine >= v) __trap();
      }
      int j = 0;
      for (; j + kInFlight <= n; j += kInFlight) {
        int32_t id[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) id[u] = __shfl_sync(kFullWarp, mine, j + u);
        if (active) {
          Chunk<T, VEC> row[kInFlight];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) row[u] = load<T, VEC>(table + (int64_t)id[u] * d + col);
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) accumulate<T, VEC>(acc, row[u]);
        }
      }
      for (; j < n; ++j) {
        const int32_t id = __shfl_sync(kFullWarp, mine, j);
        if (active) accumulate<T, VEC>(acc, load<T, VEC>(table + (int64_t)id * d + col));
      }
    }
    if (active) {
      Chunk<T, VEC> o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<T>(acc[i]);
      if constexpr (VEC * sizeof(T) == 16) {
        *reinterpret_cast<uint4*>(bag_out + col) = *reinterpret_cast<const uint4*>(o.v);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) bag_out[col + i] = o.v[i];
      }
    }
  }
}

template <typename T>
int launch(const void* table, const void* ids, void* out, int64_t v, int d, int b, int hot,
           int64_t id_stride, int64_t out_stride, int vec, int bags_per_block, int grid,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) {
    const bool aligned = d % kVec == 0 && out_stride % kVec == 0 &&
                         reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (!aligned) return (int)cudaErrorInvalidValue;
    embedding_bag_kernel<T, kVec><<<grid, 32 * bags_per_block, 0, stream>>>(
        static_cast<const T*>(table), static_cast<const int32_t*>(ids), static_cast<T*>(out), v,
        d, b, hot, id_stride, out_stride);
  } else if (vec == 1) {
    embedding_bag_kernel<T, 1><<<grid, 32 * bags_per_block, 0, stream>>>(
        static_cast<const T*>(table), static_cast<const int32_t*>(ids), static_cast<T*>(out), v,
        d, b, hot, id_stride, out_stride);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace ebag

// table (V, D) contiguous; ids (B, hot) int32 with row stride id_stride and
// unit column stride; out (B, D) with row stride out_stride and unit column
// stride; table and out share one dtype (0 f32, 1 bf16).  vec (1, or 16
// bytes' worth of values), bags_per_block and grid are the caller's geometry
// (repro_torch.kernels.embedding_bag.bag_geometry): grid * bags_per_block
// covers B with less than one block to spare.  An id outside [0, V) traps.
extern "C" int embedding_bag(const void* table, const void* ids, void* out, int64_t v, int d,
                             int b, int hot, int64_t id_stride, int64_t out_stride, int vec,
                             int bags_per_block, int grid, int dtype, void* stream) {
  if (v <= 0 || d <= 0 || b <= 0 || hot <= 0 || bags_per_block <= 0 ||
      bags_per_block > 32 || grid <= 0 || (int64_t)grid * bags_per_block < b ||
      (int64_t)(grid - 1) * bags_per_block >= b)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ebag::kF32)
    return ebag::launch<float>(table, ids, out, v, d, b, hot, id_stride, out_stride, vec,
                               bags_per_block, grid, st);
  if (dtype == ebag::kBF16)
    return ebag::launch<__nv_bfloat16>(table, ids, out, v, d, b, hot, id_stride, out_stride,
                                       vec, bags_per_block, grid, st);
  return (int)cudaErrorInvalidValue;
}
