// K5 for f32 inputs on Hopper: causal online-softmax (flash) attention with
// both products on the tensor cores as 3xTF32 wgmma, q and the K tiles
// brought in by the Tensor Memory Accelerator (TMA), V transposed into
// K-major tiles in shared memory.  Included by flash_attention.cu, whose C
// entry point sends f32 calls here (bf16 calls go to
// flash_attention_hopper.cuh).
//
// Replaces, like the bf16 kernel: src/repro/kernels/flash_attention.py::_kernel.
//
// What bounds it on the H100: operations.  At the serving path's shape
// (B = 8, S = 1920, H = 9, Hk = 3, D = 64) the causal triangle needs
// 2*D*S*(S+1) operations per (batch, head), 3.40e10 per layer: 0.507 ms at
// the fp32 CUDA-core rate, 0.206 ms for three TF32 products at the TF32
// tensor-core rate, against 0.028 ms for its 94.4 MB of f32 q, k, v and o.
//
// What the design does about it:
// - 3xTF32.  Each operand v splits into hi = cvt.rna.tf32(v) and lo =
//   cvt.rna.tf32(v - hi), and each product takes hi.hi + lo.hi + hi.lo with
//   fp32 sums, as K1 and K2 do (aggregate_hopper.cuh).  One TF32 term alone
//   misses f32's 2e-5 gate; the CPU tests emulate both.
// - A CTA owns 64 * NC query rows of one (batch, head): NC consumer
//   warpgroups of 64 rows each and one producer warpgroup.  The producer's
//   first thread issues the TMA loads: q once, then each K chunk into a ring
//   of shared-memory entries.  Its other three warps split q (scaled by
//   D^-1/2 first, as the reference does) and each K chunk in place, their lo
//   halves beside them, and build each V chunk.  Four-dimensional tensor maps
//   over (D, heads, S, B) address one head's rows in place, so GQA reads kv
//   head h / (H / Hk) with no copy; rows past S and columns past D arrive as
//   zeros.  A tile is 128-byte swizzled rows of 32 f32 (atoms), D padded with
//   zero columns to DP.
// - S = Q.K^T is wgmma m64nKTk8 with both operands K-major in shared memory
//   (q's hi and lo tiles, the K chunk's hi and lo).
// - O += P.V is wgmma m64nCWk8 with P from registers.  TF32 wgmma reads
//   shared-memory operands only K-major, and V is stored kv-major, so the
//   producer transposes each V chunk into (d, kv) rows, split hi/lo on the
//   same pass.  V is read for that with plain 16-byte loads (a TMA landing
//   tile would take the shared memory the ring needs).  The transpose also
//   permutes kv within each group of 8: the S accumulator holds kv columns
//   2t, 2t+1 of each group where the k8 A fragment wants k slots t, t+4, so
//   kv 2t is stored at slot t and kv 2t+1 at slot t+4.  Then the accumulator
//   registers are P's A fragment as they stand, split hi/lo in registers,
//   and P never visits shared memory.
// - The ring's entries each hold one chunk of CW <= 128 columns of K or of
//   V^T, hi and lo; a tile takes D / CW of each (two at D = 256).  Each entry
//   has a full (TMA landed; K only), ready (split) and empty (every consumer
//   done) mbarrier.
// - The softcap c*tanh(s/c) (tanhf, not tanh.approx), then the causal and
//   window masks, then the online softmax in the log2 domain as the bf16
//   kernel: running max from -1e30, a masked weight exactly 0 (its score is
//   -inf), corr = exp2(m_prev - m_new), l summed in fp32, output
//   acc / max(l, 1e-30) in f32.
// - kv tiles wholly above the diagonal or outside the window are skipped; a
//   warpgroup also releases unread a tile wholly masked for its own rows.
//   The heaviest q blocks launch first.
// - Geometry per DP: accumulators in registers with no spill, the ring in
//   shared memory.  q's hi and lo tiles stay resident, 8 * DP bytes a row,
//   and a kv row of a K and a V entry takes 16 * DP:
//     DP = 32, 64:  3 consumers, 64-row kv tiles, 8 and 4 entries;
//     DP = 128:     2 consumers, 32-row kv tiles, 3 entries;
//     DP = 256:     1 consumer, 32-row kv tiles, 3 entries of 128 columns.
//   D = 96 runs at DP = 128 and D = 160-240 at DP = 256 (zero columns).
// What holds it (PERF.md): the producer.  Variants of this file timed on
// the H100 ran the serving shape much faster with the producer's work
// removed (wrong results), so the producer keeps 104 registers
// (setmaxnreg), enough for every V load of an entry to be in flight at once,
// and stores V^T 16 bytes at a time.  Holding q's fragments in registers (2
// consumers at D = 64, or 3 that spill) and loading K by plain loads instead
// of TMA were slower or no faster.
#pragma once

#include "hopper.cuh"

namespace flash_tf32 {

using namespace hopper;

constexpr int kAtomCols = 32;  // f32 columns of one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr int kSplitWarps = 3;  // producer warps that split and transpose
constexpr int kSplitters = 32 * kSplitWarps;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Geometry {
  static constexpr int kConsumers = DP <= 64 ? 3 : DP == 128 ? 2 : 1;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kBlockRows = 64 * kConsumers;  // query rows per CTA
  static constexpr int kKT = DP <= 64 ? 64 : 32;      // kv rows per tile
  static constexpr int kCW = DP < 128 ? DP : 128;     // columns of a chunk
  static constexpr int kChunks = DP / kCW;
  static constexpr int kEntries = DP == 32 ? 8 : DP == 64 ? 4 : 3;
  // setmaxnreg moves registers between the roles within the CTA's launch
  // share (65,536 / kThreads a thread, in steps of 8).  The producer keeps
  // 104: its V loads for a whole entry in flight at once.
  static constexpr int kProducerRegs = 104;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 136 : kConsumers == 2 ? 200 : 240;
  static constexpr int kQBytes = kBlockRows * DP * 4;  // q's hi tile; lo follows
  static constexpr int kHalfBytes = kKT * kCW * 4;     // an entry's hi; lo follows
  static constexpr int kEntryBytes = 2 * kHalfBytes;
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte period,
  // q's hi and lo, the ring, and 3 mbarriers an entry and q's two.
  static constexpr size_t kSmem =
      1024 + 2 * (size_t)kQBytes + (size_t)kEntries * kEntryBytes + 8 * (3 * kEntries + 2);
  static_assert(kSmem <= kMaxSmemBytes, "q and the ring must fit shared memory");
  static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <=
                    65536 / kThreads / 8 * 8 * kThreads,
                "setmaxnreg must fit the CTA's registers");
};

// wgmma m64nNk8, tf32 in and fp32 out: D (64 x N) += A (64 x 8) . B (8 x N),
// B K-major in shared memory; A K-major in shared memory (ss) or in
// registers (rs).  ss zeroes D first when `accumulate` is 0.
#define TF32_D8(o)                                                                      \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),           \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define TF32_R16                                                                        \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define TF32_R32                                                                        \
  TF32_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
           "%30, %31"
#define TF32_R64                                                                        \
  TF32_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "   \
           "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
           "%61, %62, %63"
#define TF32_SS(N, REGS, DA, DB, ACC, ...)                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #ACC ", 0;\n"                       \
               "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" REGS "}, %" #DA \
               ", %" #DB ", p, 1, 1;\n}\n"                                              \
               : __VA_ARGS__                                                            \
               : "l"(da), "l"(db), "r"(accumulate))
#define TF32_RS(N, REGS, A0, A1, A2, A3, DB, ONE, ...)                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #ONE ", 0;\n"                       \
               "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" REGS "}, {%" #A0 \
               ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DB ", p, 1, 1;\n}\n"               \
               : __VA_ARGS__                                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 32) TF32_SS(32, TF32_R16, 16, 17, 18, TF32_D8(0), TF32_D8(8));
  else if constexpr (N == 64)
    TF32_SS(64, TF32_R32, 32, 33, 34, TF32_D8(0), TF32_D8(8), TF32_D8(16), TF32_D8(24));
  else
    TF32_SS(128, TF32_R64, 64, 65, 66, TF32_D8(0), TF32_D8(8), TF32_D8(16), TF32_D8(24),
            TF32_D8(32), TF32_D8(40), TF32_D8(48), TF32_D8(56));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 32) TF32_RS(32, TF32_R16, 16, 17, 18, 19, 20, 21, TF32_D8(0), TF32_D8(8));
  else if constexpr (N == 64)
    TF32_RS(64, TF32_R32, 32, 33, 34, 35, 36, 37, TF32_D8(0), TF32_D8(8), TF32_D8(16),
            TF32_D8(24));
  else
    TF32_RS(128, TF32_R64, 64, 65, 66, 67, 68, 69, TF32_D8(0), TF32_D8(8), TF32_D8(16),
            TF32_D8(24), TF32_D8(32), TF32_D8(40), TF32_D8(48), TF32_D8(56));
}

#undef TF32_RS
#undef TF32_SS
#undef TF32_R64
#undef TF32_R32
#undef TF32_R16
#undef TF32_D8

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// 2^x to about 2 ulp; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 tf32_hi(float4 v) {
  return make_float4(__uint_as_float(tf32_rna(v.x)), __uint_as_float(tf32_rna(v.y)),
                     __uint_as_float(tf32_rna(v.z)), __uint_as_float(tf32_rna(v.w)));
}

__device__ __forceinline__ float4 tf32_lo(float4 v, float4 h) {
  return make_float4(__uint_as_float(tf32_rna(v.x - h.x)), __uint_as_float(tf32_rna(v.y - h.y)),
                     __uint_as_float(tf32_rna(v.z - h.z)), __uint_as_float(tf32_rna(v.w - h.w)));
}

// A tile of `bytes` f32 (times `mul`) to hi in place and lo `bytes` further,
// by the splitting threads (i0 = 0 ... 95).  Element order does not matter:
// the split is elementwise, so the swizzle is kept.
__device__ __forceinline__ void split_tile(uint8_t* base, int bytes, float mul, int i0) {
  float4* hi = reinterpret_cast<float4*>(base);
  float4* lo = reinterpret_cast<float4*>(base + bytes);
  for (int i = i0; i < bytes / 16; i += kSplitters) {
    float4 v = hi[i];
    v.x *= mul;
    v.y *= mul;
    v.z *= mul;
    v.w *= mul;
    const float4 h = tf32_hi(v);
    hi[i] = h;
    lo[i] = tf32_lo(v, h);
  }
  fence_proxy_async();
}

// Byte offset of (row, column) in a tile of 128-byte swizzled rows of
// `rows` rows an atom: 16-byte unit u of row r sits at unit u ^ (r % 8).
__device__ __forceinline__ uint32_t swizzled(int row, int col, int rows) {
  const int a = col / kAtomCols, c = col % kAtomCols;
  return a * rows * kRowBytes + row * kRowBytes + ((((c >> 2) ^ row) & 7) << 4) + (c & 3) * 4;
}

// Chunk c (columns c * CW ...) of V's kv tile t, transposed to (column,
// slot) rows and split: hi at dst, lo kHalfBytes further.  Within each group
// of 8, kv row 2t sits at slot t and 2t + 1 at slot t + 4, so k slots t and
// t + 4 of P's A fragment are its accumulator columns 2t and 2t + 1.
// A unit is 32 kv rows (one atom of slots) by 16 columns.  Lane gp = lane %
// 8 takes the 4 kv rows of one parity in one group of 8 (slots 4 * gp ...
// 4 * gp + 3 of the atom) and lane / 8 takes 4 columns: 4 row loads of 16
// bytes (4 lanes read 64 contiguous bytes of a row), then one 16-byte store
// a column for hi and for lo.  The 8 lanes of a quarter-warp store to
// distinct 16-byte units after the swizzle, so no two share a bank.
template <int DP>
__device__ __forceinline__ void transpose_v(uint8_t* dst, const float* __restrict__ v, int b,
                                            int s, int hk, int kv_head, int d, int t, int c,
                                            int i0) {
  using G = Geometry<DP>;
  // A warp's units of an entry all in one batch: their loads in flight at once.
  constexpr int kAtoms = G::kKT / kAtomCols, kUnits = kAtoms * (G::kCW / 16);
  constexpr int kBatch = (kUnits + kSplitWarps - 1) / kSplitWarps;
  const int warp = i0 / 32, lane = i0 % 32, gp = lane % 8;
  const int r0 = 8 * (gp / 2) + gp % 2;  // the group's kv rows: r0 + 2i
  for (int u0 = warp; u0 < kUnits; u0 += kSplitWarps * kBatch) {
    float4 val[kBatch][4];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int u = u0 + kSplitWarps * j;
      const int col = c * G::kCW + (u / kAtoms) * 16 + 4 * (lane / 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kv = t * G::kKT + (u % kAtoms) * kAtomCols + r0 + 2 * i;
        val[j][i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (u < kUnits && kv < s && col < d)
          val[j][i] = *reinterpret_cast<const float4*>(
              v + (((size_t)b * s + kv) * hk + kv_head) * d + col);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int u = u0 + kSplitWarps * j;
      if (u >= kUnits) continue;
      const int x = (u / kAtoms) * 16 + 4 * (lane / 8), slot = (u % kAtoms) * kAtomCols + 4 * gp;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 raw = e == 0   ? make_float4(val[j][0].x, val[j][1].x, val[j][2].x, val[j][3].x)
                           : e == 1 ? make_float4(val[j][0].y, val[j][1].y, val[j][2].y, val[j][3].y)
                           : e == 2 ? make_float4(val[j][0].z, val[j][1].z, val[j][2].z, val[j][3].z)
                                    : make_float4(val[j][0].w, val[j][1].w, val[j][2].w, val[j][3].w);
        const float4 h = tf32_hi(raw);
        const uint32_t off = swizzled(x + e, slot, G::kCW);
        *reinterpret_cast<float4*>(dst + off) = h;
        *reinterpret_cast<float4*>(dst + G::kHalfBytes + off) = tf32_lo(raw, h);
      }
    }
  }
  fence_proxy_async();
}

template <int DP>
__global__ void __launch_bounds__(Geometry<DP>::kThreads, 1)
    flash_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map, const float* __restrict__ v,
                      float* __restrict__ o, int s, int h, int hk, int d, int causal, int window,
                      float softcap, float scale) {
  using G = Geometry<DP>;
  constexpr int KT = G::kKT, CW = G::kCW, kChunks = G::kChunks, kEntries = G::kEntries;
  constexpr int kBlockRows = G::kBlockRows, kConsumers = G::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = q_s + 2 * G::kQBytes;  // entry i at ring + i * kEntryBytes
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kEntries * G::kEntryBytes);
  uint64_t* ready = full + kEntries;
  uint64_t* empty = ready + kEntries;
  uint64_t* q_full = empty + kEntries;
  uint64_t* q_ready = q_full + 1;

  const int bh = blockIdx.x;
  const int b = bh / h, head = bh % h, kv_head = head / (h / hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // heaviest q blocks first
  // kv tiles of this q block: up to its last row if causal, from its first
  // row's window start if windowed.  Tile t's K chunks, then its V chunks,
  // are entries n = (t - t_begin) * 2 * kChunks + ... of the ring: entry
  // n sits in slot n % kEntries, its use number n / kEntries.
  const int q_last = min(q0 + kBlockRows, s) - 1;
  const int kv_end = causal ? q_last + 1 : s;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / KT, t_end = (kv_end + KT - 1) / KT;
  auto entry = [&](int t, int kind, int c) { return (t - t_begin) * 2 * kChunks + kind * kChunks + c; };
  // The warpgroup, broadcast from lane 0 so the compiler sees it is uniform.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kEntries; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&ready[i], kSplitters);
      mbar_init(&empty[i], kConsumers * 128);
    }
    mbar_init(q_full, 1);
    mbar_init(q_ready, kSplitters);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: the roles never reconverge.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::kProducerRegs));
    const int i0 = threadIdx.x - kConsumers * 128 - 32;
    if (threadIdx.x == kConsumers * 128) {
      // The loads: q, then every K chunk once its slot is free.
      mbar_expect_tx(q_full, G::kQBytes);
#pragma unroll
      for (int a = 0; a < DP / kAtomCols; ++a)
        tma_load(q_s + a * kBlockRows * kRowBytes, &q_map, q_full, a * kAtomCols, head, q0, b);
      for (int t = t_begin; t < t_end; ++t)
        for (int c = 0; c < kChunks; ++c) {
          const int n = entry(t, 0, c), slot = n % kEntries;
          if (n >= kEntries) mbar_wait(&empty[slot], (n / kEntries - 1) & 1);
          mbar_expect_tx(&full[slot], G::kHalfBytes);
          uint8_t* dst = ring + slot * G::kEntryBytes;
#pragma unroll
          for (int a = 0; a < CW / kAtomCols; ++a)
            tma_load(dst + a * KT * kRowBytes, &k_map, &full[slot], c * CW + a * kAtomCols,
                     kv_head, t * KT, b);
        }
    } else if (i0 >= 0) {
      // The splitters: q, then each entry in order.  full's phases count a
      // slot's K uses only, so its parity is kept per slot.
      mbar_wait(q_full, 0);
      split_tile(q_s, G::kQBytes, scale, i0);
      mbar_arrive(q_ready);
      uint32_t k_parity = 0;
      for (int t = t_begin; t < t_end; ++t)
        for (int kind = 0; kind < 2; ++kind)
          for (int c = 0; c < kChunks; ++c) {
            const int n = entry(t, kind, c), slot = n % kEntries;
            uint8_t* dst = ring + slot * G::kEntryBytes;
            if (kind == 0) {
              mbar_wait(&full[slot], (k_parity >> slot) & 1);
              k_parity ^= 1u << slot;
              split_tile(dst, G::kHalfBytes, 1.f, i0);
            } else {
              if (n >= kEntries) mbar_wait(&empty[slot], (n / kEntries - 1) & 1);
              transpose_v<DP>(dst, v, b, s, hk, kv_head, d, t, c, i0);
            }
            mbar_arrive(&ready[slot]);
          }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::kConsumerRegs));
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    // This thread's rows (row0 and row0 + 8), its first column in every
    // 8-column group of a fragment, and its warpgroup's rows.
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4, col_in = 2 * (lane % 4);
    const int w_first = q0 + wg * 64, w_last = min(w_first + 64, s) - 1;
    // The tiles this warpgroup's rows need (none if its rows are all past s);
    // it releases the CTA's other tiles unread.
    int wt_begin = t_begin, wt_end = t_begin;
    if (w_first < s) {
      wt_begin = window > 0 ? max(0, w_first - window + 1) / KT : 0;
      wt_end = ((causal ? w_last + 1 : s) + KT - 1) / KT;
    }
    auto wait_ready = [&](int n) {
      mbar_wait(&ready[n % kEntries], (n / kEntries) & 1);
    };
    auto release = [&](int n) { mbar_arrive(&empty[n % kEntries]); };
    auto skip = [&](int t) {
      for (int n = entry(t, 0, 0); n < entry(t + 1, 0, 0); ++n) {
        wait_ready(n);
        release(n);
      }
    };
    for (int t = t_begin; t < wt_begin; ++t) skip(t);

    float acc[kChunks][CW / 2];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < CW / 2; ++i) acc[c][i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    float sc[KT / 2];
    uint32_t p_hi[KT / 2], p_lo[KT / 2];
    const uint32_t q_addr = smem_u32(q_s) + wg * 64 * kRowBytes;
    mbar_wait(q_ready, 0);

    // Per tile: S = Q . K^T, the softmax, O rescaled by corr, P split, O +=
    // P . V, each entry released once its products are done.  Every wgmma
    // sits in warpgroup-uniform code (the loop bounds derive from the
    // broadcast warpgroup), or ptxas serializes them.
    for (int t = wt_begin; t < wt_end; ++t) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) wait_ready(entry(t, 0, c));
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint32_t k_addr = smem_u32(ring + (entry(t, 0, c) % kEntries) * G::kEntryBytes);
        // A k step moves 32 bytes inside a swizzle atom; an atom is the next
        // 32 columns.
#pragma unroll
        for (int j = 0; j < CW / 8; ++j) {
          const uint32_t qa = q_addr + (c * (CW / kAtomCols) + j / 4) * kBlockRows * kRowBytes +
                              (j % 4) * 32;
          const uint32_t ka = k_addr + (j / 4) * KT * kRowBytes + (j % 4) * 32;
          const uint64_t q_hi = smem_desc(qa, 16, 8 * kRowBytes);
          const uint64_t q_lo = smem_desc(qa + G::kQBytes, 16, 8 * kRowBytes);
          const uint64_t k_hi = smem_desc(ka, 16, 8 * kRowBytes);
          const uint64_t k_lo = smem_desc(ka + G::kHalfBytes, 16, 8 * kRowBytes);
          wgmma_ss<KT>(sc, q_hi, k_hi, c > 0 || j > 0);
          wgmma_ss<KT>(sc, q_lo, k_hi, 1);
          wgmma_ss<KT>(sc, q_hi, k_lo, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) release(entry(t, 0, c));

      // sc[i] holds row row0 + 8 * ((i / 2) % 2), column t * KT + 8 * (i /
      // 4) + col_in + i % 2.  Scores to weights in the log2 domain: q was
      // scaled before the dot, so without a softcap log2(e) is the one
      // factor.  The mask runs only on tiles that cross an edge.
      float mul = kLog2e;
      if (softcap > 0.f) {
        const float in = 1.f / softcap, out = softcap * kLog2e;
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) sc[i] = out * tanhf(sc[i] * in);
        mul = 1.f;
      }
      const int c0 = t * KT;
      if (c0 + KT > s || (causal && c0 + KT - 1 > w_first) ||
          (window > 0 && w_last - c0 >= window)) {
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) {
          const int row = row0 + 8 * ((i / 2) % 2), col = c0 + 8 * (i / 4) + col_in + i % 2;
          if (!(col < s && (!causal || col <= row) && (window <= 0 || row - col < window)))
            sc[i] = neg_inf();
        }
      }
      float mx[2] = {neg_inf(), neg_inf()}, corr[2];
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * mul);
        corr[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        const float p = ex2(fmaf(sc[i], mul, -m[(i / 2) % 2]));
        rs[(i / 2) % 2] += p;
        p_hi[i] = tf32_rna(p);
        p_lo[i] = tf32_rna(p - __uint_as_float(p_hi[i]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int i = 0; i < CW / 2; ++i) acc[c][i] *= corr[(i / 2) % 2];

      // O += P_hi . V_hi + P_lo . V_hi + P_hi . V_lo over KT / 8 k steps; the
      // A fragment of step j is accumulator registers 4j, 4j+2, 4j+1, 4j+3
      // (rows g, g + 8 at slot t; rows g, g + 8 at slot t + 4).
#pragma unroll
      for (int c = 0; c < kChunks; ++c) wait_ready(entry(t, 1, c));
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint32_t v_addr = smem_u32(ring + (entry(t, 1, c) % kEntries) * G::kEntryBytes);
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          const uint32_t a_hi[4] = {p_hi[4 * j], p_hi[4 * j + 2], p_hi[4 * j + 1], p_hi[4 * j + 3]};
          const uint32_t a_lo[4] = {p_lo[4 * j], p_lo[4 * j + 2], p_lo[4 * j + 1], p_lo[4 * j + 3]};
          const uint32_t va = v_addr + (j / 4) * CW * kRowBytes + (j % 4) * 32;
          const uint64_t v_hi = smem_desc(va, 16, 8 * kRowBytes);
          const uint64_t v_lo = smem_desc(va + G::kHalfBytes, 16, 8 * kRowBytes);
          wgmma_rs<CW>(acc[c], a_hi, v_hi);
          wgmma_rs<CW>(acc[c], a_lo, v_hi);
          wgmma_rs<CW>(acc[c], a_hi, v_lo);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) fence_regs(acc[c]);
      fence_regs(p_hi);
      fence_regs(p_lo);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) release(entry(t, 1, c));
    }
    for (int t = wt_end; t < t_end; ++t) skip(t);

    // acc / max(l, 1e-30); l is summed over the 4 lanes of a row.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      lr = fmaxf(lr, 1e-30f);
      const int row = row0 + 8 * r;
      if (row >= s) continue;
      float* orow = o + (((size_t)b * s + row) * h + head) * d;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int g = 0; g < CW / 8; ++g) {
          const int col = c * CW + 8 * g + col_in;
          if (col < d)
            *reinterpret_cast<float2*>(orow + col) =
                make_float2(acc[c][4 * g + 2 * r] / lr, acc[c][4 * g + 2 * r + 1] / lr);
        }
    }
  }
}

// The map of one (B, S, heads, D) f32 tensor as (D, heads, S, B), with boxes
// of 32 columns x `rows` rows of one head, 128-byte swizzled; columns past D
// and rows past S read as zeros.
inline int encode(CUtensorMap* map, const void* ptr, int b, int s, int heads, int d, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return kNoEncodeEntry;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 4, (cuuint64_t)heads * d * 4,
                                 (cuuint64_t)s * heads * d * 4};
  const cuuint32_t box[4] = {kAtomCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s, int h, int hk,
           int d, int causal, int window, float softcap, float scale, cudaStream_t stream) {
  using G = Geometry<DP>;
  CUtensorMap q_map, k_map;
  int err = encode(&q_map, q, b, s, h, d, G::kBlockRows);
  if (!err) err = encode(&k_map, k, b, s, hk, d, G::kKT);
  if (err) return err;
  auto kernel = flash_tf32_kernel<DP>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(b * h, (s + G::kBlockRows - 1) / G::kBlockRows);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(q_map, k_map, static_cast<const float*>(v),
                                                 static_cast<float*>(o), s, h, hk, d, causal,
                                                 window, softcap, scale);
  return (int)cudaGetLastError();
}

// D padded to DP = 32, 64, 128 or 256.  q, k, v must be 16-byte aligned
// (the tensor maps' rule and V's 16-byte loads).
inline int dispatch(const void* q, const void* k, const void* v, void* o, int b, int s, int h,
                    int hk, int d, int causal, int window, float softcap, float scale,
                    cudaStream_t stream) {
#define FLASH_TF32(DP) \
  launch<DP>(q, k, v, o, b, s, h, hk, d, causal, window, softcap, scale, stream)
  if (d <= 32) return FLASH_TF32(32);
  if (d <= 64) return FLASH_TF32(64);
  if (d <= 128) return FLASH_TF32(128);
  if (d <= 256) return FLASH_TF32(256);
#undef FLASH_TF32
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash_tf32
