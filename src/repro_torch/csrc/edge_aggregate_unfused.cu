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
// combine_pass) over the grid (N/Bn,).  Bound on the H100: the bytes of Y_agg,
// read once (2 * T operations per element, 8 per byte in f32 at T = 16: the
// FP32 cores take 2.2 of the 4.9 us the bytes take at Cora layer 1).
//
// Design.  A destination block's feature chunks (FC = 8192 / Bn columns) are
// spread over the ranks of a thread block cluster, as K1 spreads them: rank r
// takes chunks r, r + 8, ... and only those chunks' rows of W, folds them into
// a (Bn, T) fp32 partial in shared memory, and the leader sums the ranks'
// partials from distributed shared memory in rank order and writes the tile
// once, rounded to the input type (Cora layer 1: 6 chunks, 88 clusters of 6,
// 528 CTAs; one chunk: one CTA a block).  So each block still reads its
// (Bn, F) rows once and W once and writes its tile once, and the traced
// schedule (repro_torch.kernels.edge_aggregate_unfused.combine_grid_spec)
// keeps the byte counts of one CTA a block.
//
// Inside a rank the product runs from registers.  A warp takes RG = 64 / TB
// rows and a slab of the chunk's features: lane l holds features l, l + 32,
// ... of each row (32 registers), read straight from device memory with
// coalesced loads, all of a slab's in flight before the first FMA; the
// data is used once, so shared memory would only add a pass (and TMA,
// which needs 16-byte boxes, would need K2's residue boxes at F = 1433).
// The warp's first slab is requested before W's rows, so the two arrive
// together.  W's chunk rows of a TB-column block lie in shared memory (rows
// padded to an odd number of 16-byte units, so a quarter warp's 16-byte loads
// hit distinct banks), and each 16-byte load of W feeds 4 * RG FMAs.  A
// lane's RG x TB = 64 partial sums are then summed over the warp by a
// reduce-scatter (32 + 16 + 8 + 4 + 2 shuffles; lane l ends with outputs 2l
// and 2l + 1) and added to the rank's partial, which each output's one lane
// owns: the sum's order is fixed.  fp32 FMA throughout; bf16 inputs are
// widened.
//
// What holds it: a kernel this small is latency-bound.  One CTA's chain (Y's
// and W's loads, the FMAs, the reduce-scatter, two cluster barriers, the
// leader's sum) sets the time, so the rounds of CTAs on the SMs count: with
// CTAs of 2 warps all 88 clusters of layer 1 fit the card at once, where
// with 8 fewer than half did.  A tensor-core build (mma.sync m16n8k8, 3xTF32) was
// slower and spilled, so the combine stays on the FP32 cores.
#include <cooperative_groups.h>

#include <type_traits>

#include "aggregate_hopper.cuh"

using namespace block_spmm;
namespace cg = cooperative_groups;

namespace {

constexpr size_t kMaxSmemBytes = 232448;  // opt-in shared memory of one block
constexpr int kMaxCluster = 8;            // the portable cluster size

// Geometry of one combine instance: TB output columns at a time (8, 16 or
// 32), RG = 64 / TB rows a warp, features in slabs of SW = 32 * J, and at
// most W warps a CTA.
template <int BN, int TB, int W>
struct CombineGeo {
  static constexpr int kFC = block_spmm::kAccElems / BN;
  static constexpr int kRG = 64 / TB;
  static constexpr int kSW0 = 1024 / kRG;                // RG * SW = 1024 elements
  static constexpr int kFC32 = kFC < 32 ? 32 : kFC;
  static constexpr int kSW = kSW0 < kFC32 ? kSW0 : kFC32;
  static constexpr int kJ = kSW / 32;
  static constexpr int kSlabs = kFC32 / kSW;
  static constexpr int kWR = kSlabs * kSW;               // W rows in shared memory
  static constexpr int kWS = TB + 4;                     // an odd count of float4
  static constexpr int kGroups = BN / kRG;
  // At most W warps (2 or 8, combine_warps), one a row group or fewer.
  static constexpr int kWarps = kGroups < W ? kGroups : W;
  static constexpr int kThreads = 32 * kWarps;
  static_assert((kWS / 4) % 2 == 1 && BN % kRG == 0, "unsupported combine geometry");

  static size_t smem_bytes(int t) { return 4 * ((size_t)kWR * kWS + (size_t)BN * t); }
};

inline int combine_tb(int t) { return t <= 8 ? 8 : t <= 16 ? 16 : 32; }

// Warps a CTA may take: 2 where the launch has at least two CTAs an SM
// (Cora layer 1: 528 CTAs, and all 88 clusters of 6 fit the card at once),
// else 8 (layer 2: 44 CTAs, where more warps a CTA shorten each CTA's
// chain).  Each choice was the faster on its layer on the H100.
inline int combine_warps(int ctas) { return ctas >= 2 * 132 ? 2 : 8; }

// Ranks (CTAs) of a destination block: one per chunk, at most a cluster of 8.
// Mirrored by kernels/edge_aggregate_unfused.py::combine_plan.
inline int combine_plan(int f, int fc) {
  const int nfc = (f + fc - 1) / fc;
  return nfc < kMaxCluster ? nfc : kMaxCluster;
}

// v[0..N) summed over the warp, scattered: lane l keeps v[2l] and v[2l + 1]
// (of the first N = 64 values) in v[0] and v[1].
template <int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[64], int lane) {
  if constexpr (N > 2) {
    constexpr int kHalf = N / 2, kOff = N / 4;
    const bool up = (lane & kOff) != 0;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float send = up ? v[i] : v[i + kHalf];
      const float keep = up ? v[i + kHalf] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
    }
    reduce_scatter<kHalf>(v, lane);
  }
}

template <typename T, int BN, int TB, int W>
__global__ void __launch_bounds__(CombineGeo<BN, TB, W>::kThreads)
    combine_kernel(const T* __restrict__ y, const T* __restrict__ w, T* __restrict__ out, int f,
                   int t, int ranks) {
  using G = CombineGeo<BN, TB, W>;
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* out_s = w_s + G::kWR * G::kWS;
  const int rank = blockIdx.x, row0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nfc = (f + G::kFC - 1) / G::kFC;
  for (int e = threadIdx.x; e < BN * t; e += G::kThreads) out_s[e] = 0.f;

  // Slab s of row group g of the chunk at f0 (fv features), lane's columns.
  float yv[G::kRG][G::kJ];
  auto load_y = [&](int g, int s, int f0, int fv) {
    const T* yg = y + (size_t)(row0 + g * G::kRG) * f + f0;
#pragma unroll
    for (int r = 0; r < G::kRG; ++r)
#pragma unroll
      for (int j = 0; j < G::kJ; ++j) {
        const int col = s * G::kSW + lane + 32 * j;
        yv[r][j] = col < fv ? to_f32(yg[(size_t)r * f + col]) : 0.f;
      }
  };
  for (int c = rank; c < nfc; c += ranks) {
    const int f0 = c * G::kFC, fv = min(G::kFC, f - f0);
    for (int tb0 = 0; tb0 < t; tb0 += TB) {
      const int tv = min(TB, t - tb0);
      // The warp's first slab is in flight while W's rows arrive.
      load_y(warp, 0, f0, fv);
      __syncthreads();  // the last block's W is read; the partial is zeroed
      for (int e = threadIdx.x; e < G::kWR * TB; e += G::kThreads) {
        const int k = e / TB, j = e % TB;
        w_s[k * G::kWS + j] = k < fv && j < tv ? to_f32(w[(size_t)(f0 + k) * t + tb0 + j]) : 0.f;
      }
      __syncthreads();
      for (int g = warp; g < G::kGroups; g += G::kWarps) {
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll 1
        for (int s = 0; s < G::kSlabs; ++s) {
          if (g != warp || s != 0) load_y(g, s, f0, fv);
#pragma unroll
          for (int j = 0; j < G::kJ; ++j) {
            const float4* wk =
                reinterpret_cast<const float4*>(w_s + (s * G::kSW + lane + 32 * j) * G::kWS);
#pragma unroll
            for (int q = 0; q < TB / 4; ++q) {
              const float4 wv = wk[q];
#pragma unroll
              for (int r = 0; r < G::kRG; ++r) {
                float* a = acc + r * TB + 4 * q;
                a[0] = fmaf(yv[r][j], wv.x, a[0]);
                a[1] = fmaf(yv[r][j], wv.y, a[1]);
                a[2] = fmaf(yv[r][j], wv.z, a[2]);
                a[3] = fmaf(yv[r][j], wv.w, a[3]);
              }
            }
          }
        }
        reduce_scatter<64>(acc, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = 2 * lane + i, r = idx / TB, j = idx % TB;
          if (j < tv) out_s[(g * G::kRG + r) * t + tb0 + j] += acc[i];
        }
      }
    }
  }

  // The ranks' partials, summed by the leader in rank order, every rank's
  // word of an output in flight at once.
  if (ranks > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (rank == 0)
      for (int e = threadIdx.x; e < BN * t; e += G::kThreads) {
        float part[kMaxCluster];
#pragma unroll
        for (int r = 1; r < kMaxCluster; ++r)
          part[r] = r < ranks ? cluster.map_shared_rank(out_s, r)[e] : 0.f;
        float v = out_s[e];
#pragma unroll
        for (int r = 1; r < kMaxCluster; ++r)
          if (r < ranks) v += part[r];
        out[(size_t)row0 * t + e] = from_f32<T>(v);
      }
    cluster.sync();
  } else {
    __syncthreads();
    for (int e = threadIdx.x; e < BN * t; e += G::kThreads)
      out[(size_t)row0 * t + e] = from_f32<T>(out_s[e]);
  }
}

// The launch's kernel, shared memory and configuration (cluster of `ranks`).
template <typename T, int BN, int TB, int W>
cudaError_t combine_config(int n, int f, int t, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  using G = CombineGeo<BN, TB, W>;
  const size_t smem = G::smem_bytes(t);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  const int ranks = combine_plan(f, G::kFC);
  cudaError_t e = cudaFuncSetAttribute(combine_kernel<T, BN, TB, W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cfg = {};
  cfg.gridDim = dim3(ranks, n / BN, 1);
  cfg.blockDim = dim3(G::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ranks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// Calls fn(TypeTag<T>, integral_constant BN, TB, W) for the dtype, the block
// height, T's column block and the warps of a CTA.
template <typename F>
int dispatch_combine(int dtype, int n, int f, int t, int bn, F&& fn) {
  const int warps = combine_warps(combine_plan(f, block_spmm::kAccElems / bn) * (n / bn));
  return dispatch_dtype(dtype, [&](auto type) {
    return dispatch_bn(bn, [&](auto bn_c) {
      auto with_tb = [&](auto tb_c) {
        if (warps == 2) return fn(type, bn_c, tb_c, std::integral_constant<int, 2>{});
        return fn(type, bn_c, tb_c, std::integral_constant<int, 8>{});
      };
      switch (combine_tb(t)) {
        case 8: return with_tb(std::integral_constant<int, 8>{});
        case 16: return with_tb(std::integral_constant<int, 16>{});
        default: return with_tb(std::integral_constant<int, 32>{});
      }
    });
  });
}

}  // namespace

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
  return dispatch_combine(dtype, n, f, t, bn, [&](auto type, auto bn_c, auto tb_c, auto w_c) {
    using T = typename decltype(type)::type;
    constexpr int BN = decltype(bn_c)::value, TB = decltype(tb_c)::value,
                  W = decltype(w_c)::value;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = combine_config<T, BN, TB, W>(n, f, t, cfg, attr);
    if (e != cudaSuccess) return (int)e;
    cfg.stream = static_cast<cudaStream_t>(stream);
    e = cudaLaunchKernelEx(&cfg, combine_kernel<T, BN, TB, W>, static_cast<const T*>(y),
                           static_cast<const T*>(w), static_cast<T*>(out), f, t,
                           (int)cfg.gridDim.x);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  });
}

// Ranks (CTAs) per destination block of combine_pass, -1 for a geometry it
// refuses; the wrapper holds it to combine_grid_spec's grid.
extern "C" int combine_ranks(int n, int f, int t, int bn, int fc) {
  if (!geometry_ok(n, f, bn, bn, fc) || t <= 0) return -1;
  return combine_plan(f, fc);
}

// Clusters of combine_pass's launch that fit on the card at once, or minus a
// cudaError_t.
extern "C" int combine_active_clusters(int n, int f, int t, int bn, int fc, int dtype) {
  if (!geometry_ok(n, f, bn, bn, fc) || t <= 0) return -(int)cudaErrorInvalidValue;
  return dispatch_combine(dtype, n, f, t, bn, [&](auto type, auto bn_c, auto tb_c, auto w_c) {
    using T = typename decltype(type)::type;
    constexpr int BN = decltype(bn_c)::value, TB = decltype(tb_c)::value,
                  W = decltype(w_c)::value;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = combine_config<T, BN, TB, W>(n, f, t, cfg, attr);
    int count = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&count, combine_kernel<T, BN, TB, W>, &cfg);
    return e == cudaSuccess ? count : -(int)e;
  });
}
