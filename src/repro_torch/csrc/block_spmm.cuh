// Device building blocks shared by the fused (edge_aggregate.cu) and the
// unfused (edge_aggregate_unfused.cu) block-dense SpMM kernels.
//
// CTA geometry (mirrored by repro_torch.kernels.edge_aggregate.fused_grid_spec,
// which the conformance harness traces; keep the two in step):
//   * one CTA of kThreads threads per destination block of BN rows;
//   * the feature axis F is cut into chunks of FC = kAccElems / BN columns, so
//     the (BN x FC) fp32 accumulator is exactly kAccPerThread registers per
//     thread (an 8 x 4 tile of it);
//   * for each chunk the CTA walks every source block of Bk columns in order,
//     staging kStepK source columns of A and the matching X rows in shared
//     memory per step.  Each CTA therefore reads its A row-block once per
//     chunk, every X row once per chunk, and nothing carries over between CTAs.
//
// BN is a template parameter (16 ... 512), so the chunk width and every
// staging index are compile-time.  While a step computes out of shared
// memory, the next step's global loads are already in flight into
// registers: with one or two CTAs per SM, nothing else hides their latency.
//
// Arithmetic is plain fp32 FMA on the CUDA cores: the tensor cores' fp32 path
// is TF32, whose ~1e-3 relative error misses the reference's 1e-5.  bf16
// operands are widened to fp32 as they are staged.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace block_spmm {

constexpr int kThreads = 256;
constexpr int kTileRows = 8;
constexpr int kTileCols = 4;
constexpr int kAccPerThread = kTileRows * kTileCols;
constexpr int kAccElems = kThreads * kAccPerThread;  // BN * FC
static_assert(kTileRows == 8 && kTileCols == 4, "aggregate_chunk reads 2 + 1 float4 per k");
constexpr int kStepK = 16;
// Opt-in dynamic shared memory of one block on sm_90.
constexpr size_t kMaxSmemBytes = 232448;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int BN>
struct Geometry {
  static constexpr int kFC = kAccElems / BN;            // feature chunk width
  static constexpr int kTCols = kFC / kTileCols;        // threads across a chunk
  // Row stride of the transposed A tile.  Padding by 4 floats spreads a warp's
  // stores (16 source columns of one row) over 8 banks instead of 1 and keeps
  // rows 16-byte aligned for the float4 reads.
  static constexpr int kAsStride = BN + 4;
  // Row stride of the staged (BN x FC) accumulator: one pad column keeps the
  // combine's column walk off a single shared-memory bank.
  static constexpr int kAccStride = kFC + 1;
  static constexpr int kAPerThread = BN * kStepK / kThreads;
  static constexpr int kXPerThread = kStepK * kFC / kThreads;
  static_assert(BN % 16 == 0 && kAccElems % BN == 0 && kFC % kTileCols == 0 &&
                    kAPerThread >= 1 && kXPerThread >= 1,
                "unsupported destination block height");

  static constexpr size_t aggregate_smem_floats() {
    return (size_t)kStepK * kAsStride + (size_t)kStepK * kFC;
  }
  static size_t combine_smem_floats(int t) {
    return (size_t)BN * kAccStride + (size_t)kFC * t + (size_t)BN * t;
  }
};

// The geometry every kernel here accepts; the Python wrappers check it first.
// fc is the chunk width the caller traced; it must be the one compiled in.
inline bool geometry_ok(int n, int f, int bn, int bk, int fc) {
  return n > 0 && f > 0 && bn > 0 && bk > 0 && n % bn == 0 && n % bk == 0 &&
         bk % kStepK == 0 && bn * fc == kAccElems;
}

// Calls f with std::integral_constant<int, BN> for each supported height.
template <typename F>
int dispatch_bn(int bn, F&& f) {
  switch (bn) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    case 512: return f(std::integral_constant<int, 512>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
struct TypeTag {
  using type = T;
};

// Calls f with TypeTag<float> or TypeTag<__nv_bfloat16>.
template <typename F>
int dispatch_dtype(int dtype, F&& f) {
  if (dtype == kF32) return f(TypeTag<float>{});
  if (dtype == kBF16) return f(TypeTag<__nv_bfloat16>{});
  return (int)cudaErrorInvalidValue;
}

// One kStepK step of A[row0 : row0+BN, k0 : k0+kStepK] and
// X[k0 : k0+kStepK, f0 : f0+FC], held in registers between the global load
// and the shared-memory store.  Columns at or past f load as 0.
template <typename T, int BN>
struct StepTile {
  using G = Geometry<BN>;
  T a[G::kAPerThread];
  T x[G::kXPerThread];

  __device__ __forceinline__ void load(const T* __restrict__ ag, const T* __restrict__ xg,
                                       int n, int f, int row0, int f0, int k0) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < G::kAPerThread; ++i) {
      const int e = tid + i * kThreads, r = e / kStepK, k = e % kStepK;
      a[i] = ag[(size_t)(row0 + r) * n + k0 + k];
    }
#pragma unroll
    for (int i = 0; i < G::kXPerThread; ++i) {
      const int e = tid + i * kThreads, k = e / G::kFC, col = f0 + e % G::kFC;
      x[i] = col < f ? xg[(size_t)(k0 + k) * f + col] : from_f32<T>(0.f);
    }
  }

  __device__ __forceinline__ void store(float* as_, float* xs) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < G::kAPerThread; ++i) {
      const int e = tid + i * kThreads;
      as_[(e % kStepK) * G::kAsStride + e / kStepK] = to_f32(a[i]);
    }
#pragma unroll
    for (int i = 0; i < G::kXPerThread; ++i) xs[tid + i * kThreads] = to_f32(x[i]);
  }
};

// acc[m][c] = sum_k A[row0 + tr*8 + m, k] * X[k, f0 + tc*4 + c] over all n
// source columns.  The source blocks j = 0 .. n/Bk - 1 tile [0, n) in order,
// so the CTA walks them as one run of kStepK-column steps.
// as_: kStepK rows of kAsStride floats (A transposed); xs: kStepK x FC floats.
template <typename T, int BN>
__device__ void aggregate_chunk(const T* __restrict__ a, const T* __restrict__ x, int n, int f,
                                int row0, int f0, float* as_, float* xs,
                                float acc[kTileRows][kTileCols]) {
  using G = Geometry<BN>;
  const int tid = threadIdx.x;
  const int tr = tid / G::kTCols, tc = tid % G::kTCols;
#pragma unroll
  for (int m = 0; m < kTileRows; ++m)
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) acc[m][c] = 0.f;

  StepTile<T, BN> tile;
  tile.load(a, x, n, f, row0, f0, 0);
  for (int k0 = 0; k0 < n; k0 += kStepK) {
    tile.store(as_, xs);
    __syncthreads();
    // The next step's loads run while this step computes.
    if (k0 + kStepK < n) tile.load(a, x, n, f, row0, f0, k0 + kStepK);
    // 16-byte shared loads: a warp's 4-column slices of xs are then one
    // conflict-free transaction (as scalars they hit each bank 4 times).
#pragma unroll
    for (int k = 0; k < kStepK; ++k) {
      const float4* arow =
          reinterpret_cast<const float4*>(as_ + k * G::kAsStride + tr * kTileRows);
      const float4 a0 = arow[0], a1 = arow[1];
      const float4 xv4 = reinterpret_cast<const float4*>(xs + k * G::kFC)[tc];
      const float av[kTileRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float xv[kTileCols] = {xv4.x, xv4.y, xv4.z, xv4.w};
#pragma unroll
      for (int m = 0; m < kTileRows; ++m)
#pragma unroll
        for (int c = 0; c < kTileCols; ++c) acc[m][c] = fmaf(av[m], xv[c], acc[m][c]);
    }
    __syncthreads();
  }
}

// Writes this thread's accumulator tile into the staged (BN x FC) block.
template <int BN>
__device__ __forceinline__ void stage_acc(const float acc[kTileRows][kTileCols], float* acc_s) {
  using G = Geometry<BN>;
  const int tid = threadIdx.x;
  const int tr = tid / G::kTCols, tc = tid % G::kTCols;
#pragma unroll
  for (int m = 0; m < kTileRows; ++m)
#pragma unroll
    for (int c = 0; c < kTileCols; ++c)
      acc_s[(tr * kTileRows + m) * G::kAccStride + tc * kTileCols + c] = acc[m][c];
}

// out_s[r][t] += sum_{c < fv} acc_s[r][c] * W[f0 + c][t], fv = min(FC, f - f0).
// Each thread owns the same out_s elements on every call, so the running sum
// needs no atomics and is summed in a fixed order.  w_s: FC x t floats.
template <typename T, int BN>
__device__ void combine_chunk(const float* acc_s, const T* __restrict__ w, int f, int t, int f0,
                              float* w_s, float* out_s) {
  using G = Geometry<BN>;
  const int tid = threadIdx.x;
  const int fv = min(G::kFC, f - f0);
  for (int e = tid; e < fv * t; e += kThreads) w_s[e] = to_f32(w[(size_t)f0 * t + e]);
  __syncthreads();
  for (int e = tid; e < BN * t; e += kThreads) {
    const int r = e / t, col = e % t;
    float s = out_s[e];
    for (int c = 0; c < fv; ++c) s = fmaf(acc_s[r * G::kAccStride + c], w_s[c * t + col], s);
    out_s[e] = s;
  }
  __syncthreads();
}

// Sets the kernel's dynamic shared memory and launches it on `stream`;
// returns the launch's error code.
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, int grid, size_t smem_floats, cudaStream_t stream,
                  Args... args) {
  const size_t smem = sizeof(float) * smem_floats;
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace block_spmm
