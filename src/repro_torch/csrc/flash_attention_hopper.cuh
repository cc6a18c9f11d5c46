// K5 for bf16 inputs on Hopper: causal online-softmax (flash) attention with
// both products on the tensor cores (wgmma) and the K and V tiles brought in
// by the Tensor Memory Accelerator (TMA).  Included by flash_attention.cu,
// whose C entry point sends bf16 calls here; f32 calls keep its CUDA-core
// kernel.
//
// Replaces, like that kernel: src/repro/kernels/flash_attention.py::_kernel.
//
// What bounds it on the H100: operations.  At the serving path's shape
// (B = 8, S = 1920, H = 9, Hk = 3, D = 64) the causal triangle needs
// 2*D*S*(S+1) operations per (batch, head), 3.40e10 per layer: 34.4 us at the
// bf16 tensor-core rate, against 14 us for its 47.2 MB of q, k, v and o.
//
// What the design does about it:
// - A CTA owns 64 * NC query rows of one (batch, head): NC consumer
//   warpgroups of 64 rows each (3 at D = 64, 2 above) and one producer
//   warpgroup, one thread of which issues the TMA loads: the CTA's q block
//   once, then the K and V tiles it needs into a 2-stage ring of
//   shared-memory buffers, each stage signalled by a "full" mbarrier with
//   expect_tx and released by an "empty" one that every consumer thread
//   arrives on.  The consumers compute on one stage while the next lands.
//   setmaxnreg gives the producer's registers to the consumers.
// - Four-dimensional tensor maps over (D, heads, S, B) address one head's
//   rows in place (row stride heads*D*2 bytes), so GQA reads kv head
//   h / (H / Hk) with no copy.  Rows past S arrive as zeros; the mask alone
//   handles the ragged edge.  Every tile is stored as 64-column atoms of
//   128-byte rows with the 128-byte swizzle; D is padded with zero columns to
//   DP, a multiple of 64 (zero columns change neither q.k nor the kept output
//   columns).
// - S = Q.K^T is wgmma m64nKTk16 from shared memory (both operands K-major),
//   bf16 in and fp32 out.  Products of bf16 values are exact in fp32, so it
//   matches the plain version's widened dot up to summation order.  The scale
//   D^-1/2 is applied to the fp32 sum, as the reference does.
// - The softcap c*tanh(s/c) (tanhf, not tanh.approx: its error times c = 50
//   would move scores by ~0.03), then the causal and window masks, then the
//   online softmax in the log2 domain (log2(e) folded into the scale, ex2 to
//   about 2 ulp): running max from -1e30, a masked weight exactly 0, corr =
//   exp2(m_prev - m_new), l summed in fp32 from the fp32 weights.  The mask is
//   evaluated only on tiles that cross an edge.
// - O += P.V takes P straight from registers: the S accumulator's fragment
//   is the A-register fragment of the next wgmma, so p never visits shared
//   memory.  p is split into two bf16 terms, hi (p with its low 16 bits
//   cleared) and lo = bf16(p - hi), and O accumulates hi.V + lo.V: p rounded
//   once to bf16 moves outputs by more than one bf16 step, the split does not.
//   V is the B operand MN-major (the transpose bit), as it is stored kv-major.
// - Output acc / max(l, 1e-30), rounded to nearest bf16, stored from
//   registers.
// - kv tiles wholly above the diagonal or outside the window are skipped; a
//   warpgroup also skips, and releases unread, a tile wholly masked for its
//   own 64 rows.  The heaviest q blocks launch first.  The kv tile is 64 rows
//   at D = 64, 128 at D = 128 and 64 above, so the accumulators fit the
//   consumers' registers with no spill and the ring fits shared memory.
//   Measured on the H100 (PERF.md): at the serving shape a third
//   consumer warpgroup and 64-row tiles beat two warpgroups and 128-row
//   tiles; a 3-stage ring gained nothing; overlapping a tile's softmax with
//   the previous tile's P.V (FlashAttention-3's pipelining) gained at most 5%
//   at D = 64, lost 12-24% at D = 128 and 256, and spilled there.
#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace flash_hopper {

using namespace hopper;

constexpr int kAtomCols = 64;  // bf16 columns of one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP, int KT>
struct Geometry {
  // Consumer warpgroups of 64 query rows (three at D = 64, whose
  // accumulators are small), and one producer warpgroup.
  static constexpr int kConsumers = DP == 64 ? 3 : 2;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kBlockRows = 64 * kConsumers;  // query rows per CTA
  // setmaxnreg: the producer's registers go to the consumers (65,536 a CTA).
  static constexpr int kProducerRegs = kConsumers == 2 ? 40 : 24;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 232 : 160;
  static constexpr int kStages = 2;
  static constexpr int kAtoms = DP / kAtomCols;
  static constexpr int kQBytes = kBlockRows * DP * 2;
  static constexpr int kTileBytes = KT * DP * 2;
  static constexpr int kCW = DP % 128 == 0 ? 128 : 64;  // O columns per P.V wgmma
  static constexpr int kChunks = DP / kCW;
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte period,
  // then q, the K and V rings, and the 2 * kStages + 1 mbarriers.
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * (size_t)kStages * kTileBytes + 64;
  static_assert(kSmem <= kMaxSmemBytes, "the ring must fit shared memory");
};

// D (64 x 64, fp32) += A (64 x 16) . B (16 x 64), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers) . B (16 x 64), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// D (64 x 128, fp32) += A (64 x 16) . B (16 x 128), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 registers) . B (16 x 128), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 128) wgmma_ss_n128(d, da, db, acc);
  else wgmma_ss_n64(d, da, db, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128) wgmma_rs_n128(d, a, db, 1);
  else wgmma_rs_n64(d, a, db, 1);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// 2^x to about 2 ulp; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The per-tile work of one consumer warpgroup, for the kernel below.
template <int DP, int KT>
struct Consumer {
  using G = Geometry<DP, KT>;
  static constexpr int kBlockRows = G::kBlockRows;
  // This thread's rows (row0 and row0 + 8), its first column in every
  // 8-column group of a fragment, and its warpgroup's rows.
  int row0, col_in, w_first, w_last, s, causal, window;
  float softcap, scale;
  float m[2], l[2];

  // S = Q . K^T over DP / 16 steps of 16 columns; a step moves 32 bytes inside
  // a swizzle atom, an atom is the next 64 columns.
  __device__ __forceinline__ static void qk(float (&sc)[KT / 2], uint32_t q_addr,
                                            uint32_t k_addr) {
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const uint64_t da =
          smem_desc(q_addr + (j / 4) * kBlockRows * kRowBytes + (j % 4) * 32, 16, 8 * kRowBytes);
      const uint64_t db =
          smem_desc(k_addr + (j / 4) * KT * kRowBytes + (j % 4) * 32, 16, 8 * kRowBytes);
      wgmma_ss<KT>(sc, da, db, j > 0);
    }
  }

  // O += P_hi . V + P_lo . V over KT / 16 steps of 16 kv rows (two 8-row
  // groups, 1024 bytes apart); V is the MN-major B operand, its 64-column
  // atoms KT * 128 bytes apart.  Fragment pair k of S is register k of A.
  __device__ __forceinline__ static void pv(float (&acc)[G::kChunks][G::kCW / 2],
                                            const uint32_t (&p_hi)[KT / 4],
                                            const uint32_t (&p_lo)[KT / 4], uint32_t v_addr) {
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      const uint32_t a_hi[4] = {p_hi[4 * j], p_hi[4 * j + 1], p_hi[4 * j + 2], p_hi[4 * j + 3]};
      const uint32_t a_lo[4] = {p_lo[4 * j], p_lo[4 * j + 1], p_lo[4 * j + 2], p_lo[4 * j + 3]};
#pragma unroll
      for (int c = 0; c < G::kChunks; ++c) {
        const uint64_t db =
            smem_desc(v_addr + c * (G::kCW / kAtomCols) * KT * kRowBytes + j * 16 * kRowBytes,
                      KT * kRowBytes, 8 * kRowBytes);
        wgmma_rs<G::kCW>(acc[c], a_hi, db);
        wgmma_rs<G::kCW>(acc[c], a_lo, db);
      }
    }
  }

  // sc[i] holds row row0 + 8 * ((i / 2) % 2), column c0 + 8 * (i / 4) +
  // col_in + i % 2.
  __device__ __forceinline__ bool keep(int i, int c0) const {
    const int row = row0 + 8 * ((i / 2) % 2), col = c0 + 8 * (i / 4) + col_in + i % 2;
    return col < s && (!causal || col <= row) && (window <= 0 || row - col < window);
  }

  // Scores of kv tile t to fp32 weights p in place; updates m and l and
  // returns each row's corr.  Scores are scaled after the dot, softcapped,
  // masked (only on tiles that cross an edge), and exponentiated in the log2
  // domain: without a softcap the scale and log2(e) fold into one FMA.  A
  // masked score is -inf, so its weight is exactly 0 (ex2(-inf) = +0) while
  // m stays finite: a row with nothing unmasked yet keeps m = -1e30 and
  // corr = 1, as in the reference.
  __device__ __forceinline__ void softmax(float (&sc)[KT / 2], int t, float (&corr)[2]) {
    float mul = scale * kLog2e;
    if (softcap > 0.f) {
      const float in = scale / softcap, out = softcap * kLog2e;
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) sc[i] = out * tanhf(sc[i] * in);
      mul = 1.f;
    }
    const int c0 = t * KT;
    if (c0 + KT > s || (causal && c0 + KT - 1 > w_first) ||
        (window > 0 && w_last - c0 >= window)) {
#pragma unroll
      for (int i = 0; i < KT / 2; ++i)
        if (!keep(i, c0)) sc[i] = neg_inf();
    }
    float mx[2] = {neg_inf(), neg_inf()};
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
      sc[i] = ex2(fmaf(sc[i], mul, -m[(i / 2) % 2]));
      rs[(i / 2) % 2] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
  }

  // p = hi + lo in two bf16 terms: hi is p with its low 16 bits cleared
  // (exact, no conversion), lo = bf16(p - hi) rounded to nearest, so hi + lo
  // is within 2^-15 of p.
  __device__ __forceinline__ static void split(const float (&p)[KT / 2], uint32_t (&p_hi)[KT / 4],
                                               uint32_t (&p_lo)[KT / 4]) {
#pragma unroll
    for (int k = 0; k < KT / 4; ++k) {
      const uint32_t b0 = __float_as_uint(p[2 * k]), b1 = __float_as_uint(p[2 * k + 1]);
      p_hi[k] = __byte_perm(b0, b1, 0x7632);
      p_lo[k] = pack_bf16(__floats2bfloat162_rn(p[2 * k] - __uint_as_float(b0 & 0xFFFF0000u),
                                                p[2 * k + 1] - __uint_as_float(b1 & 0xFFFF0000u)));
    }
  }
};

template <int DP, int KT>
__global__ void __launch_bounds__(Geometry<DP, KT>::kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                       int s, int h, int hk, int d, int causal, int window, float softcap,
                       float scale) {
  using G = Geometry<DP, KT>;
  constexpr int kStages = G::kStages, kConsumers = G::kConsumers, kBlockRows = G::kBlockRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* k_s = q_s + G::kQBytes;  // stage i at k_s + i * kTileBytes
  uint8_t* v_s = k_s + kStages * G::kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + kStages * G::kTileBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int bh = blockIdx.x;
  const int b = bh / h, head = bh % h, kv_head = head / (h / hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // heaviest q blocks first
  // kv tiles of this q block: up to its last row if causal, from its first
  // row's window start if windowed.  Tile t sits in stage (t - t_begin) %
  // kStages, and its use of that stage has parity (t - t_begin) / kStages.
  const int q_last = min(q0 + kBlockRows, s) - 1;
  const int kv_end = causal ? q_last + 1 : s;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / KT, t_end = (kv_end + KT - 1) / KT;
  // The warpgroup, broadcast from lane 0 so the compiler sees it is uniform.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * 128);
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one thread issues every load; the roles never reconverge.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(q_bar, G::kQBytes);
#pragma unroll
      for (int a = 0; a < G::kAtoms; ++a)
        tma_load(q_s + a * kBlockRows * kRowBytes, &q_map, q_bar, a * kAtomCols, head, q0, b);
      for (int t = t_begin; t < t_end; ++t) {
        const int n = t - t_begin, stage = n % kStages;
        if (n >= kStages) mbar_wait(&empty[stage], (n / kStages - 1) & 1);
        mbar_expect_tx(&full[stage], 2 * G::kTileBytes);
#pragma unroll
        for (int a = 0; a < G::kAtoms; ++a) {
          const int off = stage * G::kTileBytes + a * KT * kRowBytes;
          tma_load(k_s + off, &k_map, &full[stage], a * kAtomCols, kv_head, t * KT, b);
          tma_load(v_s + off, &v_map, &full[stage], a * kAtomCols, kv_head, t * KT, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::kConsumerRegs));
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    Consumer<DP, KT> cs;
    cs.row0 = q0 + wg * 64 + warp * 16 + lane / 4;
    cs.col_in = 2 * (lane % 4);
    cs.w_first = q0 + wg * 64;
    cs.w_last = min(cs.w_first + 64, s) - 1;
    cs.s = s;
    cs.causal = causal;
    cs.window = window;
    cs.softcap = softcap;
    cs.scale = scale;
    cs.m[0] = cs.m[1] = kNeg;
    cs.l[0] = cs.l[1] = 0.f;
    // The tiles this warpgroup's rows need (none if its rows are all past s);
    // it releases the CTA's other tiles unread.
    int wt_begin = t_begin, wt_end = t_begin;
    if (cs.w_first < s) {
      wt_begin = window > 0 ? max(0, cs.w_first - window + 1) / KT : 0;
      wt_end = ((causal ? cs.w_last + 1 : s) + KT - 1) / KT;
    }
    auto stage_of = [&](int t) { return (t - t_begin) % kStages; };
    auto wait_full = [&](int t) {
      mbar_wait(&full[stage_of(t)], ((t - t_begin) / kStages) & 1);
    };
    for (int t = t_begin; t < wt_begin; ++t) {
      wait_full(t);
      mbar_arrive(&empty[stage_of(t)]);
    }

    float acc[G::kChunks][G::kCW / 2];
#pragma unroll
    for (int c = 0; c < G::kChunks; ++c)
#pragma unroll
      for (int i = 0; i < G::kCW / 2; ++i) acc[c][i] = 0.f;
    float sc[KT / 2];
    uint32_t p_hi[KT / 4], p_lo[KT / 4];
    const uint32_t q_addr = smem_u32(q_s) + wg * 64 * kRowBytes;
    mbar_wait(q_bar, 0);

    // Per tile: S = Q . K^T, the softmax, O rescaled by corr, P split, O +=
    // P . V, the stage released.  Every wgmma sits in warpgroup-uniform code
    // (the loop bounds derive from the broadcast warpgroup), or ptxas
    // serializes them.
    for (int t = wt_begin; t < wt_end; ++t) {
      wait_full(t);
      wgmma_fence();
      cs.qk(sc, q_addr, smem_u32(k_s + stage_of(t) * G::kTileBytes));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      float corr[2];
      cs.softmax(sc, t, corr);
#pragma unroll
      for (int c = 0; c < G::kChunks; ++c)
#pragma unroll
        for (int i = 0; i < G::kCW / 2; ++i) acc[c][i] *= corr[(i / 2) % 2];
      cs.split(sc, p_hi, p_lo);
      wgmma_fence();
      cs.pv(acc, p_hi, p_lo, smem_u32(v_s + stage_of(t) * G::kTileBytes));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < G::kChunks; ++c) fence_regs(acc[c]);
      fence_regs(p_hi);
      fence_regs(p_lo);
      mbar_arrive(&empty[stage_of(t)]);
    }
    for (int t = wt_end; t < t_end; ++t) {
      wait_full(t);
      mbar_arrive(&empty[stage_of(t)]);
    }

    // acc / max(l, 1e-30) to bf16; l is summed over the 4 lanes of a row.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = cs.l[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l = fmaxf(l, 1e-30f);
      const int row = cs.row0 + 8 * r;
      if (row >= s) continue;
      __nv_bfloat16* orow = o + (((size_t)b * s + row) * h + head) * d;
#pragma unroll
      for (int c = 0; c < G::kChunks; ++c)
#pragma unroll
        for (int g = 0; g < G::kCW / 8; ++g) {
          const int col = c * G::kCW + 8 * g + cs.col_in;
          if (col < d)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
                acc[c][4 * g + 2 * r] / l, acc[c][4 * g + 2 * r + 1] / l);
        }
    }
  }
}

// The map of one (B, S, heads, D) bf16 tensor as (D, heads, S, B), with
// boxes of 64 columns x `rows` rows of one head, 128-byte swizzled; columns
// past D and rows past S read as zeros.
inline int encode(CUtensorMap* map, const void* ptr, int b, int s, int heads, int d, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return kNoEncodeEntry;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s * heads * d * 2};
  const cuuint32_t box[4] = {kAtomCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

template <int DP, int KT>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s, int h, int hk,
           int d, int causal, int window, float softcap, float scale, cudaStream_t stream) {
  using G = Geometry<DP, KT>;
  CUtensorMap q_map, k_map, v_map;
  int err = encode(&q_map, q, b, s, h, d, G::kBlockRows);
  if (!err) err = encode(&k_map, k, b, s, hk, d, KT);
  if (!err) err = encode(&v_map, v, b, s, hk, d, KT);
  if (err) return err;
  auto kernel = flash_wgmma_kernel<DP, KT>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(b * h, (s + G::kBlockRows - 1) / G::kBlockRows);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(q_map, k_map, v_map,
                                               static_cast<__nv_bfloat16*>(o), s, h, hk, d,
                                               causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

// D padded to DP, a multiple of 64; the kv tile is 128 rows up to DP = 128, 64
// above.  q, k, v must be 16-byte aligned (the tensor maps' rule).
inline int dispatch(const void* q, const void* k, const void* v, void* o, int b, int s, int h,
                    int hk, int d, int causal, int window, float softcap, float scale,
                    cudaStream_t stream) {
#define FLASH_WGMMA(DP, KT) \
  launch<DP, KT>(q, k, v, o, b, s, h, hk, d, causal, window, softcap, scale, stream)
  switch ((d + kAtomCols - 1) / kAtomCols) {
    case 1: return FLASH_WGMMA(64, 64);
    case 2: return FLASH_WGMMA(128, 128);
    case 3: return FLASH_WGMMA(192, 64);
    case 4: return FLASH_WGMMA(256, 64);
  }
#undef FLASH_WGMMA
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash_hopper
