// K2 + K3: the unfused two-pass GNN layer for sm_90a, HyGCN's inter-phase
// analogue.  Two kernels, two launches: the aggregate crosses device memory
// between them, and that round trip is the traffic the port's conformance
// harness measures against writeinterphase + readinterphase.
//
// K2, Y_agg = A @ X.  Replaces
// src/repro/kernels/edge_aggregate_unfused.py::_aggregate_kernel (launched by
// aggregate_pass).  It is K1's aggregation (aggregate_hopper.cuh: wgmma,
// 3xTF32 for f32, a TMA ring) over the same feature chunks and source
// blocks, so the two read exactly the same A and X bytes and the
// fused-minus-unfused delta stays the two interphase terms.  Each (destination
// block, chunk) is its own CTA (Cora layer 1: 88 x 6); with one chunk, a
// cluster's ranks split the source blocks and the leader sums them from
// distributed shared memory (layer 2: 44 x 2).  Each (Bn, chunk) tile goes to
// Y_agg once, rounded to the input type, as the TPU kernel rounds its spill.
// Bound on the H100: as for K1, the block-dense product's operations.
//
// K3 combine_kernel, Y = Y_agg @ W.  Replaces
// src/repro/kernels/edge_aggregate_unfused.py::_combine_kernel (launched by
// combine_pass) over the grid (N/Bn,).  Each CTA reads its (Bn, F) aggregate
// rows and all of W once, chunk by chunk, and writes its (Bn, T) tile once.
// Bound on the H100: the bytes of Y_agg (2*T operations per element read).
// fp32 FMA on the CUDA cores.
#include "aggregate_hopper.cuh"

using namespace block_spmm;

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
  return agg_hopper::dispatch<false>(a, x, nullptr, y, n, f, 0, bn, bk, fc, dtype, stream);
}

// Ranks (CTAs) per destination block of aggregate_pass, -1 for a geometry it
// refuses; the wrapper holds it to aggregate_grid_spec's grid.
extern "C" int aggregate_ranks(int n, int f, int bn, int bk, int fc) {
  return agg_hopper::ranks(n, f, bn, bk, fc, false);
}

// Clusters of aggregate_pass's launch that fit on the card at once, or
// minus a cudaError_t.
extern "C" int aggregate_active_clusters(int n, int f, int bn, int bk, int fc, int dtype) {
  return agg_hopper::dispatch_active_clusters<false>(n, f, 0, bn, bk, fc, dtype);
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
