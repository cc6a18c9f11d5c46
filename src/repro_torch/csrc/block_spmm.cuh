// Shared pieces of the GNN layer kernels K1-K3: the chunk geometry, the
// geometry check of the C entry points, the dtype and block-height dispatch,
// and K3's combine (edge_aggregate_unfused.cu).  K1's and K2's aggregation is
// aggregate_hopper.cuh.
//
// The feature axis F is cut into chunks of FC = kAccElems / Bn columns
// (repro_torch.kernels.edge_aggregate.feature_chunk): a (Bn x FC) fp32 tile of
// the aggregate is the unit every kernel here stages, spills or combines.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace block_spmm {

constexpr int kThreads = 256;      // K3's CTA
constexpr int kAccElems = 8192;    // BN * FC
constexpr int kStepK = 16;         // Bk must be a multiple
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
  static constexpr int kFC = kAccElems / BN;  // feature chunk width
  // Row stride of the staged (BN x FC) aggregate: one pad column keeps the
  // combine's column walk off a single shared-memory bank.
  static constexpr int kAccStride = kFC + 1;
  static_assert(BN % 16 == 0 && kAccElems % BN == 0, "unsupported destination block height");

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
