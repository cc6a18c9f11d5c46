// The block-dense aggregation of K1 (edge_aggregate.cu, fused with the
// combine) and K2 (edge_aggregate_unfused.cu, spilled) on Hopper: tensor
// cores, a ring of shared-memory stages filled by TMA, and thread block
// clusters that spread a destination block over several SMs.
//
// Work.  A CTA of destination block i (Bn rows) and feature chunk c (FC =
// 8192 / Bn columns, as in the port specs) forms agg = A[i, :] . X[:, c].  It
// computes the transpose, agg^T = X[:, c]^T . A[i, :]^T, as wgmma m64nNk:
//   * M is 64 feature columns.  X's chunk is the A operand, from registers:
//     a pass through registers is needed anyway to split f32 values, and it
//     reads X in the layout the product needs although X is feature-major in
//     memory (TF32 wgmma takes shared-memory operands only K-major).  Only the
//     M tiles that hold a feature below F run, so a 16-wide layer computes 64
//     columns, not FC.
//   * N is the destination rows.  A's row block is the B operand from shared
//     memory, K-major as stored, 128-byte swizzled: one 128-byte row of A (32
//     f32 or 64 bf16 sources) per stage (f32 at Bn = 512: 64 bytes, 64-byte
//     swizzle, or two stages would not fit).  Bn = 16 or 32 fit N directly,
//     where they would waste M's fixed 64 rows.
// Two consumer warpgroups split the M tiles (or, with one M tile, the rows);
// each loads the next k steps' X fragments while the tensor cores work on
// the current ones.
//
// Numerics.  bf16: bf16 x bf16 products are exact in fp32, summed in fp32,
// like the widened FMAs they replace.  f32: 3xTF32.  Each operand v splits
// into hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi), and the sum takes
// hi.hi + lo.hi + hi.lo in fp32.  One TF32 product misses the 1e-5 gate on
// the Cora inputs by 20x; the split holds it about 100x inside (the CPU tests
// emulate both).  X splits in registers; three warps of the producer split
// A's tile in place in shared memory, its lo half beside it, before the
// consumers read either.
//
// The ring.  Up to kMaxStages stages (as many as shared memory holds) of A's
// tile, its lo tile (f32) and X's (KT x FC) tile, each under three mbarriers:
// full (the loads landed), ready (f32: A split) and empty (both consumers
// done).  One producer warp issues every load by TMA.  TMA needs row strides
// that are multiples of 16 bytes, and X's is not at Cora's F = 1433 (5732
// bytes).  So X's map takes R = 16 / gcd(16, F * elem) rows as one row of
// R * F elements (a stride of R * F * elem bytes, a multiple of 16): source k
// = R * m + r is row m, columns r * F ... r * F + F - 1, and a stage's X tile
// arrives as boxes of KT / R rows, one set per residue r.  A box must also
// start on 16 bytes (boxes that did not stopped the kernel with an illegal
// instruction on the H100), and row r's first feature lies s_r = r * F mod
// (16 / elem) elements
// past a boundary.  So residue r's boxes start s_r elements early and may
// take one box more: at Cora layer 1 (f32, R = 4) a chunk's row is 9 boxes of
// 32 features where 8 hold it.  Those elements, and a last box's reach past
// feature F - 1, are never kept (their rows of M are discarded); they are the
// only bytes read that the traced schedule does not count, all from L2.
//
// Clusters (grid: ranks x destination blocks).
//   * Several feature chunks: each rank of a cluster takes whole chunks
//     (chunk r, r + ranks, ...; Cora layer 1: 6 chunks, 88 x 6 = 528 CTAs).
//     K1 folds each chunk's aggregate into its (Bn, T) partial through the
//     chunk's rows of W; the leader sums the ranks' partials from distributed
//     shared memory in rank order and writes the tile once.  K2 spills each
//     (Bn, chunk) tile and needs no cluster.
//   * One feature chunk: the ranks split the source blocks, in whole blocks
//     (runs of 64 sources at least), as many ranks (a power of two) as fit
//     the 132 SMs in one wave (Cora layer 2: 11 blocks as 6/5, 44 x 2 = 88
//     CTAs).  The leader sums the partial aggregates from distributed shared
//     memory in rank order, then combines (K1) or spills (K2).
// So EnGN's inter-phase buffer now spans the cluster's SMs: in K1 the
// aggregate never reaches device memory.  Which CTA moves which block is
// repro_torch.kernels.edge_aggregate.fused_grid_spec / edge_aggregate_unfused.
// aggregate_grid_spec, which the conformance harness traces: every byte count
// equals the one-CTA-per-row-block schedule's, because work splits only along
// whole chunks and whole source blocks.  plan() and source_range() below are
// that schedule's rule; the wrappers check the two agree before each launch.
//
// ptxas serializes a wgmma behind a branch it cannot prove warpgroup-uniform,
// so the warpgroup index is broadcast with __shfl_sync and every branch
// around a wgmma depends on it, on loop counters and on kernel arguments only.
// A uniform branch between two wgmma of one batch still made ptxas fence each
// one (C7519) and cost a quarter of the time, so the count of M tiles that
// run is a compile-time constant inside a chunk (with_count).
//
// What holds it on the H100 (PERF.md): at Cora layer 1 a stage takes about
// 2 us against 0.1 us of tensor-core work; the loads alone take a third of
// the time and the products alone even less, so what remains is the latency
// of small (N = Bn = 32) register-operand wgmma in a chain.  K1's clusters of
// 6 CTAs, at one CTA an SM, fit 17 at a time where 22 would fill the SMs, so
// its 88 clusters run in 6 rounds where K2's 528 free CTAs run in 4.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "block_spmm.cuh"
#include "hopper.cuh"

namespace agg_hopper {

using namespace hopper;
using block_spmm::from_f32;
using block_spmm::to_f32;
namespace cg = cooperative_groups;

constexpr int kConsumers = 2;                     // warpgroups of the product
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer warpgroup
constexpr int kMaxStages = 8;
constexpr int kSms = 132;                         // H100 SXM
constexpr int kMaxCluster = 8;                    // the portable cluster size
constexpr int kSplitSources = 64;                 // a rank's sources: a multiple
constexpr int kConsumerBarrier = 1;               // named barrier of the consumers

template <typename T, int BN>
struct Geo {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kElem = sizeof(T);
  // Bytes of A's row in one stage: 128 (the 128-byte swizzle), but 64 for
  // f32 at Bn = 512, whose hi and lo tiles would not fit two stages.
  static constexpr int kARow = kF32 && BN >= 512 ? 64 : 128;
  static constexpr uint64_t kASwizzle = kARow == 128 ? 1 : 2;  // descriptor code
  static constexpr int kKT = kARow / kElem;       // sources per stage
  static constexpr int kWK = 32 / kElem;          // sources per wgmma: k8 tf32, k16 bf16
  static constexpr int kKSteps = kKT / kWK;
  static constexpr int kFC = block_spmm::kAccElems / BN;
  static constexpr int kMT = kFC >= 64 ? kFC / 64 : 1;          // M tiles of a chunk
  static constexpr bool kSplitM = kMT >= kConsumers;
  static constexpr int kMW = kSplitM ? kMT / kConsumers : 1;    // M tiles per warpgroup
  static constexpr int kNW = kSplitM ? BN : BN / kConsumers;    // rows per warpgroup
  static constexpr int kNC = kNW < 64 ? kNW : 64;               // rows per wgmma
  static constexpr int kNChunks = kNW / kNC;
  static constexpr int kAccRegs = kMW * kNChunks * kNC / 2;
  static constexpr int kFragRegs = kMW * 4 * (kF32 ? 2 : 1);    // per k step
  // k steps of one batch of X fragments; two batches are live at a time.
  static constexpr int kBatch = kAccRegs + 2 * kKSteps * kFragRegs <= 80 ? kKSteps
                                : kAccRegs + 4 * kFragRegs <= 80         ? 2
                                                                         : 1;
  static constexpr int kBatches = kKSteps / kBatch;             // per stage
  static constexpr int kXW = kFC < 64 ? 64 : kFC;  // X columns of a stage (M tiles padded)
  static constexpr int kXB = kFC * kElem < 128 ? kFC : 128 / kElem;  // features per X box
  static constexpr int kXBBytes = kXB * kElem;
  static constexpr int kBoxStride = kKT * kXBBytes;
  static constexpr int kXBoxes = kXW / kXB + 1;   // one more for a residue's offset
  static constexpr int kABytes = BN * kARow;
  static constexpr int kXOffset = kABytes * (kF32 ? 2 : 1);     // X's tile in a stage
  static constexpr int kStageBytes =
      (kXOffset + kXBoxes * kBoxStride + 1023) / 1024 * 1024;
  static constexpr int kAggStride = kFC + 4;
  static_assert(kNW % kNC == 0 && kNC % 16 == 0 && kKSteps % kBatch == 0,
                "unsupported geometry");
  static_assert(kABytes % 1024 == 0 && kXOffset % 1024 == 0, "swizzle atoms must align");

  // 1024 bytes of slack align the ring to the swizzle period; then the ring
  // and the staged (Bn, FC) aggregate, which takes the ring's place where
  // every CTA has one chunk (the ring is idle by then), the (Bn, T) partial
  // (K1) and the 3 x stages mbarriers.
  static size_t smem_bytes(int stages, bool alias, bool fused, int t) {
    const size_t ring = (size_t)stages * kStageBytes, agg = 4 * (size_t)BN * kAggStride;
    return 1024 + (alias ? (ring > agg ? ring : agg) : ring + agg) +
           (fused ? 4 * (size_t)BN * t : 0) + 24 * (size_t)stages;
  }
  static int stages(bool alias, bool fused, int t) {
    for (int s = kMaxStages; s >= 2; --s)
      if (smem_bytes(s, alias, fused, t) <= kMaxSmemBytes) return s;
    return 0;
  }
};

// Ranks per destination block, and whether they split the sources (one
// chunk) or the chunks.  Mirrored by kernels/edge_aggregate.py::cta_plan.
struct Plan {
  int ranks;
  bool split_sources;
  int cluster;
};

__host__ __device__ inline int gcd(int a, int b) {
  while (b) {
    const int m = a % b;
    a = b;
    b = m;
  }
  return a;
}

inline Plan plan(int n, int f, int bn, int bk, int fc, bool fused) {
  const int nfc = (f + fc - 1) / fc, nrb = n / bn, nbk = n / bk;
  if (nfc > 1) {
    const int ranks = fused ? (nfc < kMaxCluster ? nfc : kMaxCluster) : nfc;
    return {ranks, false, fused ? ranks : 1};
  }
  // The most ranks, a power of two, that keep every CTA in one wave: clusters
  // of 3 or 6 leave SMs of each GPC idle on the H100 (at one CTA an SM, 39
  // clusters of 3 fit at once, 17 of 6; of 2, all 66).
  const int g = kSplitSources / gcd(bk, kSplitSources);  // source blocks per unit
  const int units = (nbk + g - 1) / g;
  int ranks = 1;
  while (2 * ranks <= units && 2 * ranks <= kMaxCluster && 2 * ranks * nrb <= kSms) ranks *= 2;
  return {ranks, true, ranks};
}

// Sources [lo, hi) of rank r of `ranks` when they split the source blocks:
// whole units of g blocks, the first units % ranks ranks one unit more.
__host__ __device__ inline void source_range(int n, int bk, int ranks, int r, int& lo, int& hi) {
  const int g = kSplitSources / gcd(bk, kSplitSources), nbk = n / bk;
  const int units = (nbk + g - 1) / g, base = units / ranks, extra = units % ranks;
  const int u0 = r * base + (r < extra ? r : extra), u1 = u0 + base + (r < extra ? 1 : 0);
  lo = (u0 * g < nbk ? u0 * g : nbk) * bk;
  hi = (u1 * g < nbk ? u1 * g : nbk) * bk;
}


template <typename T>
struct Params {
  const T* w;  // K1 only
  T* out;      // K1: (n, t) output; K2: (n, f) aggregate
  int n, f, t, bk, stages, ranks, split_sources, cluster;
  int alias;          // the staged aggregate takes the ring's place
  int log2_residues;  // X's map takes R = 1 << log2_residues source rows as one
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBarrier), "n"(128 * kConsumers) : "memory");
}

// D (64 x N, fp32) += A (64 x K, registers) . B (K x N, K-major in shared
// memory, 128-byte swizzle); K = 8 (tf32) or 16 (bf16).
#define AGG_D8(o)                                                                       \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),           \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define AGG_IN "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
#define AGG_WGMMA_N16(KIND, TAIL)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                              \
               "wgmma.mma_async.sync.aligned.m64n16" KIND " "                           \
               "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1" TAIL \
               ";\n}\n"                                                                  \
               : AGG_D8(0)                                                               \
               : AGG_IN)
#define AGG_WGMMA_N32(KIND, TAIL)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                              \
               "wgmma.mma_async.sync.aligned.m64n32" KIND " "                           \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
               "{%16, %17, %18, %19}, %20, p, 1, 1" TAIL ";\n}\n"                        \
               : AGG_D8(0), AGG_D8(8)                                                    \
               : AGG_IN)
#define AGG_WGMMA_N64(KIND, TAIL)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                              \
               "wgmma.mma_async.sync.aligned.m64n64" KIND " "                           \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
               "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1" TAIL ";\n}\n"            \
               : AGG_D8(0), AGG_D8(8), AGG_D8(16), AGG_D8(24)                            \
               : AGG_IN)

template <int N, bool F32>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (F32) {
    if constexpr (N == 16) AGG_WGMMA_N16("k8.f32.tf32.tf32", "");
    else if constexpr (N == 32) AGG_WGMMA_N32("k8.f32.tf32.tf32", "");
    else AGG_WGMMA_N64("k8.f32.tf32.tf32", "");
  } else {
    if constexpr (N == 16) AGG_WGMMA_N16("k16.f32.bf16.bf16", ", 0");
    else if constexpr (N == 32) AGG_WGMMA_N32("k16.f32.bf16.bf16", ", 0");
    else AGG_WGMMA_N64("k16.f32.bf16.bf16", ", 0");
  }
}

#undef AGG_WGMMA_N64
#undef AGG_WGMMA_N32
#undef AGG_WGMMA_N16
#undef AGG_IN
#undef AGG_D8

// Elements by which residue r's X boxes start before the chunk's first
// feature: r * F mod (16 / elem).
template <typename T>
__device__ __forceinline__ int x_lead(int r, int f) {
  return (r * f) & (16 / (int)sizeof(T) - 1);
}

// Byte offset of X element (source k of a stage, chunk feature fe) in the
// stage's X tile: boxes of kXB columns kBoxStride apart, each R sub-boxes of
// KT / R rows (source k is row k / R of sub-box k % R, its features x_lead
// columns along), swizzled as TMA swizzles them (16-byte unit u of a row
// XORed with address bits 7 and up).
template <typename T, int BN>
__device__ __forceinline__ uint32_t x_offset(int k, int fe, int log2r, int f) {
  using G = Geo<T, BN>;
  const int r = k & ((1 << log2r) - 1), m = k >> log2r, c = fe + x_lead<T>(r, f);
  const uint32_t o = (c / G::kXB) * G::kBoxStride +
                     r * ((G::kKT >> log2r) * G::kXBBytes) + m * G::kXBBytes +
                     (c % G::kXB) * G::kElem;
  return o ^ (((o >> 7) & (G::kXBBytes / 16 - 1)) << 4);
}

// Feature (of 64) that row R of an M tile holds.  bf16: R.  f32: rows 0-3 of
// a warp's 16 take 16-byte unit 0 of a 32-feature box, rows 4-7 unit 4,
// 8-11 unit 2, 12-15 unit 6 (odd warps the next unit), so the 32 lanes of one
// fragment load, 8 rows in 4 sources, hit 32 distinct banks.
template <typename T>
__device__ __forceinline__ int feature_of(int R) {
  if constexpr (std::is_same<T, float>::value) {
    const int w = R >> 4, r = R & 15;
    const int unit = ((0x6240 >> (4 * (r >> 2))) & 0xF) + (w & 1);
    return 32 * (w >> 1) + 4 * unit + (r & 3);
  } else {
    return R;
  }
}

// out_s[r][j] += sum_{c < fv} agg_s[r][c] * W[f0 + c][j].  Each thread owns
// the same out_s elements on every call, so the running sum takes a fixed
// order.  The combine is 1 / FC of the product's work: fp32 FMA, W's chunk
// rows read through L1 (the ring keeps the shared memory).
template <typename T, int BN>
__device__ void combine_chunk(const float* agg_s, const T* __restrict__ w, float* out_s, int f0,
                              int fv, int t) {
  using G = Geo<T, BN>;
  const T* wc = w + (size_t)f0 * t;
  for (int e = threadIdx.x; e < BN * t; e += 128 * kConsumers) {
    const int r = e / t, j = e % t;
    float s = out_s[e];
    for (int c = 0; c < fv; ++c) s = fmaf(agg_s[r * G::kAggStride + c], to_f32(wc[c * t + j]), s);
    out_s[e] = s;
  }
  consumer_sync();
}

// The inter-phase spill: Y[row0 + r, f0 + c] = agg_s[r][c], in the input type.
template <typename T, int BN>
__device__ void spill_chunk(const float* agg_s, T* __restrict__ y, int row0, int f, int f0,
                            int fv) {
  using G = Geo<T, BN>;
  for (int e = threadIdx.x; e < BN * fv; e += 128 * kConsumers) {
    const int r = e / fv, c = e % fv;
    y[(size_t)(row0 + r) * f + f0 + c] = from_f32<T>(agg_s[r * G::kAggStride + c]);
  }
}

// A's f32 tile of one stage to hi in place and lo beside it, by the 96
// threads of the producer's splitting warps (i0 = 0 ... 95).
template <int BN>
__device__ __forceinline__ void split_a(uint8_t* a_s, int i0) {
  using G = Geo<float, BN>;
  float4* hi = reinterpret_cast<float4*>(a_s);
  float4* lo = reinterpret_cast<float4*>(a_s + G::kABytes);
  for (int i = i0; i < G::kABytes / 16; i += 96) {
    const float4 v = hi[i];
    float4 h, l;
    h.x = __uint_as_float(tf32_rna(v.x));
    h.y = __uint_as_float(tf32_rna(v.y));
    h.z = __uint_as_float(tf32_rna(v.z));
    h.w = __uint_as_float(tf32_rna(v.w));
    l.x = __uint_as_float(tf32_rna(v.x - h.x));
    l.y = __uint_as_float(tf32_rna(v.y - h.y));
    l.z = __uint_as_float(tf32_rna(v.z - h.z));
    l.w = __uint_as_float(tf32_rna(v.w - h.w));
    hi[i] = h;
    lo[i] = l;
  }
  fence_proxy_async();
}

// Calls f(std::integral_constant<int, min(n, NA)>): a count of M tiles as
// a compile-time constant, so no branch sits between two wgmma (ptxas fences
// and serializes them around one).
template <int NA, typename F>
__device__ __forceinline__ void with_count(int n, F&& f) {
  if constexpr (NA == 0) {
    f(std::integral_constant<int, 0>{});
  } else {
    if (n >= NA)
      f(std::integral_constant<int, NA>{});
    else
      with_count<NA - 1>(n, f);
  }
}

// One batch of a warpgroup's X fragments: kBatch k steps of its M tiles, as
// wgmma A-operand registers (f32: hi and lo).
template <typename T, int BN>
struct Frags {
  using G = Geo<T, BN>;
  uint32_t h[G::kBatch][G::kMW][4];
  uint32_t l[G::kBatch][G::kMW][4];

  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int b = 0; b < G::kBatch; ++b)
#pragma unroll
      for (int mw = 0; mw < G::kMW; ++mw) {
        fence_regs(h[b][mw]);
        if constexpr (G::kF32) fence_regs(l[b][mw]);
      }
  }

  // Batch `batch` of the stage whose X tile is at x_s.
  __device__ __forceinline__ void load(const uint8_t* x_s, int batch, int wg, int log2r,
                                       int f) {
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, c4 = lane % 4;
#pragma unroll
    for (int b = 0; b < G::kBatch; ++b)
#pragma unroll
      for (int mw = 0; mw < G::kMW; ++mw) {
        const int mt = G::kSplitM ? wg * G::kMW + mw : 0;
        const int fe0 = mt * 64 + feature_of<T>(16 * warp + g);
        const int fe1 = mt * 64 + feature_of<T>(16 * warp + g + 8);
        const int k = (batch * G::kBatch + b) * G::kWK;
        if constexpr (G::kF32) {
          const int kk[4] = {k + c4, k + c4, k + c4 + 4, k + c4 + 4};
          const int ff[4] = {fe0, fe1, fe0, fe1};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float v =
                *reinterpret_cast<const float*>(x_s + x_offset<T, BN>(kk[i], ff[i], log2r, f));
            h[b][mw][i] = tf32_rna(v);
            l[b][mw][i] = tf32_rna(v - __uint_as_float(h[b][mw][i]));
          }
        } else {
          const int kk[4] = {k + 2 * c4, k + 2 * c4, k + 2 * c4 + 8, k + 2 * c4 + 8};
          const int ff[4] = {fe0, fe1, fe0, fe1};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t lo16 = *reinterpret_cast<const uint16_t*>(
                x_s + x_offset<T, BN>(kk[i], ff[i], log2r, f));
            const uint32_t hi16 = *reinterpret_cast<const uint16_t*>(
                x_s + x_offset<T, BN>(kk[i] + 1, ff[i], log2r, f));
            h[b][mw][i] = lo16 | (hi16 << 16);
          }
        }
      }
  }

  // acc += this batch's product with the stage's A tile at a_addr (already
  // offset to this warpgroup's rows) for the first NA of its M tiles (those
  // that hold a feature below F); f32 takes hi.hi + lo.hi + hi.lo.
  template <int NA>
  __device__ __forceinline__ void issue_tiles(float (&acc)[G::kMW][G::kNChunks][G::kNC / 2],
                                              uint32_t a_addr, int batch) const {
#pragma unroll
    for (int b = 0; b < G::kBatch; ++b)
#pragma unroll
      for (int mw = 0; mw < NA; ++mw)
#pragma unroll
        for (int nc = 0; nc < G::kNChunks; ++nc) {
          const uint32_t off = nc * G::kNC * G::kARow + (batch * G::kBatch + b) * 32;
          const uint64_t d_hi = smem_desc(a_addr + off, 16, 8 * G::kARow, G::kASwizzle);
          wgmma_rs<G::kNC, G::kF32>(acc[mw][nc], h[b][mw], d_hi);
          if constexpr (G::kF32) {
            wgmma_rs<G::kNC, true>(acc[mw][nc], l[b][mw], d_hi);
            wgmma_rs<G::kNC, true>(
                acc[mw][nc], h[b][mw],
                smem_desc(a_addr + G::kABytes + off, 16, 8 * G::kARow, G::kASwizzle));
          }
        }
  }
};

template <typename T, int BN, bool Fused>
__global__ void __launch_bounds__(kThreads, 1)
    aggregate_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap x_map, const __grid_constant__ Params<T> p) {
  using G = Geo<T, BN>;
  extern __shared__ uint8_t smem_raw[];
  // Offsetting smem_raw (not rounding its integer address) keeps the pointer
  // in the shared window for the compiler: the X fragments load with LDS.
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int stages = p.stages, t = p.t, n = p.n, f = p.f;
  const size_t ring_bytes = (size_t)stages * G::kStageBytes;
  const size_t agg_bytes = 4 * (size_t)BN * G::kAggStride;
  float* agg_s = reinterpret_cast<float*>(ring + (p.alias ? 0 : ring_bytes));
  float* out_s = reinterpret_cast<float*>(
      ring + (p.alias ? (ring_bytes > agg_bytes ? ring_bytes : agg_bytes) : ring_bytes + agg_bytes));
  uint64_t* full = reinterpret_cast<uint64_t*>(out_s + BN * t);
  uint64_t* empty = full + stages;
  uint64_t* ready = empty + stages;

  const int rank = blockIdx.x, row0 = blockIdx.y * BN;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int nfc = (f + G::kFC - 1) / G::kFC;
  int c_first = rank, c_step = p.ranks, s_lo = 0, s_hi = n;
  if (p.split_sources) {
    c_first = 0;
    c_step = 1;
    source_range(n, p.bk, p.ranks, rank, s_lo, s_hi);
  }
  const int steps = (s_hi - s_lo + G::kKT - 1) / G::kKT;
  const int my_chunks = (nfc - 1 - c_first) / c_step + 1;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128 * kConsumers);
      mbar_init(&ready[i], 96);
    }
    mbar_init_fence();
  }
  if (Fused)
    for (int e = threadIdx.x; e < BN * t; e += kThreads) out_s[e] = 0.f;
  __syncthreads();

  if (wg == kConsumers) {
    const int pwarp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    if (pwarp == 0) {
      // The loads: A's tile (in boxes of at most 256 rows), then X's boxes of
      // kXB columns, each as R sub-boxes of KT / R rows (residue r's from
      // x_lead elements before the chunk); the warp's lanes share the issue.
      const int log2r = p.log2_residues, rows_r = G::kKT >> log2r;
      const int na = (BN + 255) / 256, lead_max = 16 / G::kElem - 1;
      int q = 0;
      for (int ci = 0; ci < my_chunks; ++ci) {
        const int f0 = (c_first + ci * c_step) * G::kFC, fv = min(G::kFC, f - f0);
        const int nb_max = (fv + lead_max + G::kXB - 1) / G::kXB;
        uint32_t bytes = G::kABytes;
        for (int r = 0; r < (1 << log2r); ++r)
          bytes += (fv + x_lead<T>(r, f) + G::kXB - 1) / G::kXB * rows_r * G::kXBBytes;
        for (int st = 0; st < steps; ++st, ++q) {
          const int s = q % stages, k0 = s_lo + st * G::kKT;
          if (q >= stages) mbar_wait(&empty[s], (q / stages - 1) & 1);
          uint8_t* a_s = ring + (size_t)s * G::kStageBytes;
          uint8_t* x_s = a_s + G::kXOffset;
          if (lane == 0) mbar_expect_tx(&full[s], bytes);
          __syncwarp();
          for (int i = lane; i < na + (nb_max << log2r); i += 32) {
            if (i < na) {
              tma_load_2d(a_s + i * 256 * G::kARow, &a_map, &full[s], k0, row0 + i * 256);
            } else {
              const int b = (i - na) >> log2r, r = (i - na) & ((1 << log2r) - 1);
              const int lead = x_lead<T>(r, f);
              if (b * G::kXB < fv + lead)
                tma_load_2d(x_s + b * G::kBoxStride + r * rows_r * G::kXBBytes, &x_map,
                            &full[s], r * f + f0 - lead + b * G::kXB, k0 >> log2r);
            }
          }
        }
      }
    } else if (G::kF32) {
      const int total = my_chunks * steps;
      for (int q = 0; q < total; ++q) {
        const int s = q % stages;
        mbar_wait(&full[s], (q / stages) & 1);
        split_a<BN>(ring + (size_t)s * G::kStageBytes, threadIdx.x - 128 * kConsumers - 32);
        mbar_arrive(&ready[s]);
      }
    }
  } else {
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, c4 = lane % 4;
    const int nbase = G::kSplitM ? 0 : wg * G::kNW;
    const int units = steps * G::kBatches;
    int q0 = 0;
    for (int ci = 0; ci < my_chunks; ++ci, q0 += steps) {
      const int f0 = (c_first + ci * c_step) * G::kFC, fv = min(G::kFC, f - f0);
      float acc[G::kMW][G::kNChunks][G::kNC / 2];
#pragma unroll
      for (int mw = 0; mw < G::kMW; ++mw)
#pragma unroll
        for (int nc = 0; nc < G::kNChunks; ++nc)
#pragma unroll
          for (int i = 0; i < G::kNC / 2; ++i) acc[mw][nc][i] = 0.f;
      auto stage_of = [&](int u) { return (q0 + u / G::kBatches) % stages; };
      // Loads unit u's fragments, waiting for its stage first.
      auto load = [&](Frags<T, BN>& fr, int u) {
        const int q = q0 + u / G::kBatches, s = q % stages;
        if (u % G::kBatches == 0) {
          mbar_wait(&full[s], (q / stages) & 1);
          if (G::kF32) mbar_wait(&ready[s], (q / stages) & 1);
          __syncwarp();  // the warp leaves the polls together for the wgmma that follow
        }
        fr.load(ring + (size_t)s * G::kStageBytes + G::kXOffset, u % G::kBatches, wg,
                p.log2_residues, f);
      };
      auto retire = [&](Frags<T, BN>& fr, int u) {
        fr.fence();
        if (u % G::kBatches == G::kBatches - 1) mbar_arrive(&empty[stage_of(u)]);
      };
      // M tiles of this warpgroup that hold a feature below F (a narrow layer
      // computes 64 columns, not FC).  Units run in order with one commit
      // group in flight behind the one being issued: unit u + 1's fragments
      // load and issue while unit u runs; a stage is freed once its last unit
      // has completed.
      const int active =
          G::kSplitM ? max(0, min(G::kMW, (fv - wg * G::kMW * 64 + 63) / 64)) : 1;
      with_count<G::kMW>(active, [&](auto na) {
        constexpr int NA = decltype(na)::value;
        auto issue = [&](Frags<T, BN>& fr, int u) {
          wgmma_fence();
          fr.template issue_tiles<NA>(
              acc, smem_u32(ring + (size_t)stage_of(u) * G::kStageBytes) + nbase * G::kARow,
              u % G::kBatches);
          wgmma_commit();
        };
        Frags<T, BN> fa, fb;
        load(fa, 0);
        issue(fa, 0);
        for (int u = 1; u < units; u += 2) {
          load(fb, u);
          issue(fb, u);
          wgmma_wait_one();
          retire(fa, u - 1);
          if (u + 1 < units) {
            load(fa, u + 1);
            issue(fa, u + 1);
            wgmma_wait_one();
            retire(fb, u);
          }
        }
        wgmma_wait_all();
#pragma unroll
        for (int mw = 0; mw < G::kMW; ++mw)
#pragma unroll
          for (int nc = 0; nc < G::kNChunks; ++nc) fence_regs(acc[mw][nc]);
        if (units % 2)
          retire(fa, units - 1);
        else
          retire(fb, units - 1);
      });
      // Stage the chunk's aggregate as agg_s[row][feature], valid features only.
      consumer_sync();
#pragma unroll
      for (int mw = 0; mw < G::kMW; ++mw) {
        const int mt = G::kSplitM ? wg * G::kMW + mw : 0;
#pragma unroll
        for (int nc = 0; nc < G::kNChunks; ++nc)
#pragma unroll
          for (int i = 0; i < G::kNC / 2; ++i) {
            const int fe = mt * 64 + feature_of<T>(16 * warp + g + 8 * ((i >> 1) & 1));
            const int r = nbase + nc * G::kNC + 8 * (i >> 2) + 2 * c4 + (i & 1);
            if (fe < fv) agg_s[r * G::kAggStride + fe] = acc[mw][nc][i];
          }
      }
      consumer_sync();
      if (!p.split_sources) {
        if (Fused)
          combine_chunk<T, BN>(agg_s, p.w, out_s, f0, fv, t);
        else
          spill_chunk<T, BN>(agg_s, p.out, row0, f, f0, fv);
      }
    }
  }

  // The cluster's reduction, in rank order, by the leader's consumers; the
  // producer warpgroup takes part in the cluster barriers only.
  cg::cluster_group cluster = cg::this_cluster();
  const bool leader = rank == 0 && wg < kConsumers;
  const int tid = threadIdx.x, nthr = 128 * kConsumers;
  if (p.split_sources) {
    const int fv = min(G::kFC, f);
    if (p.cluster > 1) {
      cluster.sync();
      if (leader)
        for (int e = tid; e < BN * fv; e += nthr) {
          const int idx = (e / fv) * G::kAggStride + e % fv;
          float s = agg_s[idx];
          for (int r = 1; r < p.cluster; ++r) s += cluster.map_shared_rank(agg_s, r)[idx];
          agg_s[idx] = s;
        }
      cluster.sync();
    }
    if (leader) {
      consumer_sync();
      if (Fused)
        combine_chunk<T, BN>(agg_s, p.w, out_s, 0, fv, t);
      else
        spill_chunk<T, BN>(agg_s, p.out, row0, f, 0, fv);
    }
  }
  if (Fused) {
    const bool sum_ranks = !p.split_sources && p.cluster > 1;
    if (sum_ranks) cluster.sync();
    if (leader)
      for (int e = tid; e < BN * t; e += nthr) {
        float s = out_s[e];
        if (sum_ranks)
          for (int r = 1; r < p.cluster; ++r) s += cluster.map_shared_rank(out_s, r)[e];
        p.out[(size_t)row0 * t + e] = from_f32<T>(s);
      }
    if (sum_ranks) cluster.sync();
  }
}

// The map of a (rows x cols) matrix of T whose rows lie row_stride bytes
// apart, with boxes of box_cols x box_rows, swizzled to match box_cols' bytes
// (32, 64 or 128).
template <typename T>
int encode_2d(CUtensorMap* map, const void* ptr, int rows, int cols, size_t row_stride,
              int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return kNoEncodeEntry;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_stride};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const int bytes = box_cols * (int)sizeof(T);
  const CUtensorMapSwizzle swizzle = bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r =
      fn(map, std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
         2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

// Launches K1 (Fused) or K2 on `stream`; returns a cudaError_t or a
// tensor-map code.  out is K1's (n, t) output or K2's (n, f) aggregate.  A
// and X must start on 16 bytes (the wrappers check).
template <typename T, int BN, bool Fused>
int launch(const void* a, const void* x, const void* w, void* out, int n, int f, int t, int bk,
           cudaStream_t stream) {
  using G = Geo<T, BN>;
  const Plan pl = plan(n, f, BN, bk, G::kFC, Fused);
  const bool alias = pl.split_sources || pl.ranks * G::kFC >= f;  // one chunk a CTA
  const int stages = G::stages(alias, Fused, Fused ? t : 0);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  Params<T> p{static_cast<const T*>(w), static_cast<T*>(out), n, f, Fused ? t : 0, bk, stages,
              pl.ranks, pl.split_sources ? 1 : 0, pl.cluster, alias ? 1 : 0, 0};
  CUtensorMap a_map, x_map;
  int err = encode_2d<T>(&a_map, a, n, n, (size_t)n * sizeof(T), G::kKT, BN < 256 ? BN : 256);
  if (err) return err;
  // X as (n / R) rows of R * F elements; n is a multiple of 16, so of R.
  const int residues = 16 / gcd(16, (int)((size_t)f * sizeof(T) % 16));
  while ((1 << p.log2_residues) < residues) ++p.log2_residues;
  err = encode_2d<T>(&x_map, x, n / residues, residues * f, (size_t)residues * f * sizeof(T),
                     G::kXB, G::kKT / residues);
  if (err) return err;
  auto kernel = aggregate_kernel<T, BN, Fused>;
  const size_t smem = G::smem_bytes(stages, alias, Fused, p.t);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.ranks, n / BN, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a_map, x_map, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of the launch fit on the card at once
// (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
template <typename T, int BN, bool Fused>
int active_clusters(int n, int f, int t, int bk) {
  using G = Geo<T, BN>;
  const Plan pl = plan(n, f, BN, bk, G::kFC, Fused);
  const bool alias = pl.split_sources || pl.ranks * G::kFC >= f;
  const int stages = G::stages(alias, Fused, Fused ? t : 0);
  if (stages == 0) return -(int)cudaErrorInvalidValue;
  auto kernel = aggregate_kernel<T, BN, Fused>;
  const size_t smem = G::smem_bytes(stages, alias, Fused, Fused ? t : 0);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.ranks, n / BN, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int count = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
  return e == cudaSuccess ? count : -(int)e;
}

template <bool Fused>
int dispatch_active_clusters(int n, int f, int t, int bn, int bk, int fc, int dtype) {
  if (!block_spmm::geometry_ok(n, f, bn, bk, fc)) return -(int)cudaErrorInvalidValue;
  return block_spmm::dispatch_dtype(dtype, [&](auto type) {
    using T = typename decltype(type)::type;
    return block_spmm::dispatch_bn(bn, [&](auto bn_c) {
      return active_clusters<T, decltype(bn_c)::value, Fused>(n, f, t, bk);
    });
  });
}

// The ranks per destination block of a launch (the grid's first axis).
inline int ranks(int n, int f, int bn, int bk, int fc, bool fused) {
  if (!block_spmm::geometry_ok(n, f, bn, bk, fc)) return -1;
  return plan(n, f, bn, bk, fc, fused).ranks;
}

// Launches K1 or K2 for the dtype code and block height.
template <bool Fused>
int dispatch(const void* a, const void* x, const void* w, void* out, int n, int f, int t, int bn,
             int bk, int fc, int dtype, void* stream) {
  if (!block_spmm::geometry_ok(n, f, bn, bk, fc) || (Fused && t <= 0))
    return (int)cudaErrorInvalidValue;
  return block_spmm::dispatch_dtype(dtype, [&](auto type) {
    using T = typename decltype(type)::type;
    return block_spmm::dispatch_bn(bn, [&](auto bn_c) {
      constexpr int BN = decltype(bn_c)::value;
      return launch<T, BN, Fused>(a, x, w, out, n, f, t, bk, static_cast<cudaStream_t>(stream));
    });
  });
}

}  // namespace agg_hopper
