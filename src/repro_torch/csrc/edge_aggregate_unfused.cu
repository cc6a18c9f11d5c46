// K2 + K3: the unfused two-pass GNN layer for sm_90a, HyGCN's inter-phase
// analogue.  Two kernels, two launches: the aggregate crosses device memory
// between them, and that round trip is the traffic the port's conformance
// harness measures against writeinterphase + readinterphase.
//
// K2 aggregate_kernel, Y_agg = A @ X.  Replaces
// src/repro/kernels/edge_aggregate_unfused.py::_aggregate_kernel (launched by
// aggregate_pass).  It cuts F into the same chunks as the fused kernel K1 and
// walks the source blocks the same way, so the two read exactly the same A
// and X bytes and the fused-minus-unfused delta stays the two interphase
// terms.  Each (Bn, FC) partial sum goes from registers to Y_agg, rounded to
// the input type, as the TPU kernel rounds its spill.  Bound on the H100: as
// for K1, the fp32 rate of the block-dense product at Cora width.
//
// K3 combine_kernel, Y = Y_agg @ W.  Replaces
// src/repro/kernels/edge_aggregate_unfused.py::_combine_kernel (launched by
// combine_pass) over the grid (N/Bn,).  Each CTA reads its (Bn, F) aggregate
// rows and all of W once, chunk by chunk, and writes its (Bn, T) tile once.
// Bound on the H100: the bytes of Y_agg (2*T operations per element read).
//
// fp32 FMA throughout, not TF32 (see block_spmm.cuh).
#include "block_spmm.cuh"

using namespace block_spmm;

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    aggregate_kernel(const T* __restrict__ a, const T* __restrict__ x, T* __restrict__ y, int n,
                     int f) {
  using G = Geometry<BN>;
  extern __shared__ __align__(16) float smem[];
  float* as_ = smem;
  float* xs = as_ + kStepK * G::kAsStride;

  const int row0 = blockIdx.x * BN;
  const int tr = threadIdx.x / G::kTCols, tc = threadIdx.x % G::kTCols;
  float acc[kTileRows][kTileCols];
  for (int f0 = 0; f0 < f; f0 += G::kFC) {
    aggregate_chunk<T, BN>(a, x, n, f, row0, f0, as_, xs, acc);
    // The inter-phase spill: the aggregate leaves the SM.
#pragma unroll
    for (int m = 0; m < kTileRows; ++m) {
      const size_t row = (size_t)(row0 + tr * kTileRows + m);
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) {
        const int col = f0 + tc * kTileCols + c;
        if (col < f) y[row * f + col] = from_f32<T>(acc[m][c]);
      }
    }
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const T* __restrict__ y, const T* __restrict__ w, T* __restrict__ out, int f,
                   int t) {
  using G = Geometry<BN>;
  extern __shared__ __align__(16) float smem[];
  float* acc_s = smem;
  float* w_s = acc_s + BN * G::kAccStride;
  float* out_s = w_s + (size_t)G::kFC * t;

  const int row0 = blockIdx.x * BN;
  for (int e = threadIdx.x; e < BN * t; e += kThreads) out_s[e] = 0.f;
  for (int f0 = 0; f0 < f; f0 += G::kFC) {
    // Read the spilled aggregate back, one (BN, FC) chunk at a time.
    for (int e = threadIdx.x; e < BN * G::kFC; e += kThreads) {
      const int r = e / G::kFC, c = e % G::kFC, col = f0 + c;
      acc_s[r * G::kAccStride + c] = col < f ? to_f32(y[(size_t)(row0 + r) * f + col]) : 0.f;
    }
    __syncthreads();
    combine_chunk<T, BN>(acc_s, w, f, t, f0, w_s, out_s);
  }
  for (int e = threadIdx.x; e < BN * t; e += kThreads)
    out[(size_t)row0 * t + e] = from_f32<T>(out_s[e]);
}

extern "C" int aggregate_pass(const void* a, const void* x, void* y, int n, int f, int bn, int bk,
                              int fc, int dtype, void* stream) {
  if (!geometry_ok(n, f, bn, bk, fc)) return (int)cudaErrorInvalidValue;
  return dispatch_dtype(dtype, [&](auto type) {
    using T = typename decltype(type)::type;
    return dispatch_bn(bn, [&](auto bn_c) {
      constexpr int BN = decltype(bn_c)::value;
      return launch_kernel(aggregate_kernel<T, BN>, n / BN,
                           Geometry<BN>::aggregate_smem_floats(),
                           static_cast<cudaStream_t>(stream), static_cast<const T*>(a),
                           static_cast<const T*>(x), static_cast<T*>(y), n, f);
    });
  });
}

extern "C" int combine_pass(const void* y, const void* w, void* out, int n, int f, int t, int bn,
                            int fc, int dtype, void* stream) {
  // The combine pass has no source blocks; bk = bn satisfies the shared check.
  if (!geometry_ok(n, f, bn, bn, fc) || t <= 0) return (int)cudaErrorInvalidValue;
  return dispatch_dtype(dtype, [&](auto type) {
    using T = typename decltype(type)::type;
    return dispatch_bn(bn, [&](auto bn_c) {
      constexpr int BN = decltype(bn_c)::value;
      return launch_kernel(combine_kernel<T, BN>, n / BN,
                           Geometry<BN>::combine_smem_floats(t),
                           static_cast<cudaStream_t>(stream), static_cast<const T*>(y),
                           static_cast<const T*>(w), static_cast<T*>(out), f, t);
    });
  });
}
