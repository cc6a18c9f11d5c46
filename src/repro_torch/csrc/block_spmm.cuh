// Shared pieces of the GNN layer kernels K1-K3: the chunk geometry, the
// geometry check of the C entry points, and the dtype and block-height
// dispatch.  K1's and K2's aggregation is aggregate_hopper.cuh; K3's combine
// is edge_aggregate_unfused.cu.
//
// The feature axis F is cut into chunks of FC = kAccElems / Bn columns
// (repro_torch.kernels.edge_aggregate.feature_chunk): a (Bn x FC) fp32 tile of
// the aggregate is the unit every kernel here stages, spills or combines.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace block_spmm {

constexpr int kAccElems = 8192;    // BN * FC
constexpr int kStepK = 16;         // Bk must be a multiple

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

}  // namespace block_spmm
