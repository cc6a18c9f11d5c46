// K1: fused GNN aggregate + combine, Y = (A @ X) @ W, for sm_90a.
//
// Replaces: src/repro/kernels/edge_aggregate.py::_kernel, launched by
// fused_aggregate_combine (pl.pallas_call over the grid (N/Bn, N/Bk), which a
// TPU walks in order, carrying a (Bn, F) fp32 VMEM accumulator across the
// source-block axis and applying W on the last source block).
//
// What bounds it on the H100: at GCN-Cora width (N = 2816 padded, F = 1433)
// the block-dense product does 2*N*N*F fp32 operations, 600x what the 0.2%
// dense adjacency needs, so the CUDA-core fp32 rate bounds it, not the
// ~48 MB of operands.  The TPU sequential grid has no counterpart here.
//
// What the design does about it: one CTA per destination block with the
// source loop inside the CTA (blocks run in no order on an H100, so nothing
// may carry over between them).  A (Bn, F) fp32 accumulator does not fit in
// 227 KB of shared memory at Bn >= 64 and F = 1433, so the CTA cuts F into
// chunks of FC = 8192 / Bn columns, keeps each (Bn, FC) partial sum in
// registers, stages it once in shared memory and folds it into the (Bn, T)
// output through the matching rows of W:
//   out += (sum_j A[i, j] @ X[j, f0:f1]) @ W[f0:f1, :]
// A is re-read once per chunk (the port spec spmm_tiled_cta counts that), W is
// read once per CTA, and the aggregate never leaves the SM: the inter-phase
// buffer stays on chip, as in EnGN.  fp32 FMA, not TF32 (see block_spmm.cuh).
// Each step's global loads go to registers while the previous step computes
// (block_spmm.cuh); TMA, wgmma and split work across CTAs are left for later.
#include "block_spmm.cuh"

using namespace block_spmm;

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    fused_kernel(const T* __restrict__ a, const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ out, int n, int f, int t) {
  using G = Geometry<BN>;
  extern __shared__ __align__(16) float smem[];
  float* as_ = smem;
  float* xs = as_ + kStepK * G::kAsStride;
  float* acc_s = xs + kStepK * G::kFC;
  float* w_s = acc_s + BN * G::kAccStride;
  float* out_s = w_s + (size_t)G::kFC * t;

  const int row0 = blockIdx.x * BN;
  for (int e = threadIdx.x; e < BN * t; e += kThreads) out_s[e] = 0.f;

  float acc[kTileRows][kTileCols];
  for (int f0 = 0; f0 < f; f0 += G::kFC) {
    aggregate_chunk<T, BN>(a, x, n, f, row0, f0, as_, xs, acc);
    stage_acc<BN>(acc, acc_s);
    __syncthreads();
    combine_chunk<T, BN>(acc_s, w, f, t, f0, w_s, out_s);
  }
  // The output tile is written once, cast to the input type.
  for (int e = threadIdx.x; e < BN * t; e += kThreads)
    out[(size_t)row0 * t + e] = from_f32<T>(out_s[e]);
}

extern "C" int fused_aggregate_combine(const void* a, const void* x, const void* w, void* out,
                                       int n, int f, int t, int bn, int bk, int fc, int dtype,
                                       void* stream) {
  if (!geometry_ok(n, f, bn, bk, fc) || t <= 0) return (int)cudaErrorInvalidValue;
  return dispatch_dtype(dtype, [&](auto type) {
    using T = typename decltype(type)::type;
    return dispatch_bn(bn, [&](auto bn_c) {
      constexpr int BN = decltype(bn_c)::value;
      using G = Geometry<BN>;
      return launch_kernel(fused_kernel<T, BN>, n / BN,
                           G::aggregate_smem_floats() + G::combine_smem_floats(t),
                           static_cast<cudaStream_t>(stream), static_cast<const T*>(a),
                           static_cast<const T*>(x), static_cast<const T*>(w),
                           static_cast<T*>(out), n, f, t);
    });
  });
}
