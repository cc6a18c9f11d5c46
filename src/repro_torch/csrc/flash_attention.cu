// K5: causal online-softmax (flash) attention, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel, launched by
// flash_attention_bhsd (pl.pallas_call over the grid (B*H, S/BQ, S/BK), whose
// innermost kv axis a TPU walks in order, carrying the running max m, sum l and
// (BQ, D) accumulator in VMEM scratch across it).
//
// bf16 inputs, the serving path's, go to flash_attention_hopper.cuh: wgmma
// for both products, K and V tiles by TMA into a ring, a producer warpgroup
// and two consumer warpgroups.  This file keeps the f32 kernel below.
//
// What bounds the f32 kernel on the H100: operations.  At the serving shape
// (B = 8, S = 1920, H = 9, Hk = 3, D = 64) the causal triangle needs
// 2*D*S*(S+1) operations per (batch, head), 3.40e10 per layer: 0.51 ms at the
// fp32 CUDA-core rate it computes at.
//
// What its design does about it: one CTA of 256 threads owns 64 query rows of
// one (batch, head) and walks the kv tiles itself (CTAs run in no order here,
// so nothing carries over between them).  q, scaled by D^-1/2 before the dot,
// the K and V tiles and the tile of weights p are staged in shared memory, so
// every staged value feeds 4 rows or columns of FMAs.  Each thread keeps a
// 4 x KT/16 score tile, a 4 x D/16 output accumulator and the running max and
// sum of its 4 rows in registers; the 16 threads that share rows combine their
// maxima and sums with half-warp shuffles.  kv tiles that lie wholly above the
// diagonal or wholly outside the window are skipped, which halves the causal
// work; their p would be 0.  CTAs of the last q blocks, which walk the most
// tiles, are launched first.  GQA: query head h reads kv head h / (H / Hk) in
// place, with no repeated copy.
//
// The numbers follow the TPU kernel: the softcap is applied before the mask; a
// masked weight is set to 0 explicitly (not left to exp underflow), so a row
// whose first tiles are all masked keeps m = -1e30 and corr = 1 until its first
// unmasked tile; l is clamped at 1e-30 before the divide.  All arithmetic is
// fp32 FMA on the CUDA cores.  3xTF32 on the tensor cores is later work.
#include <cuda_runtime.h>

#include "flash_attention_hopper.cuh"

namespace flash {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kBlockRows = 16 * kRowsPerThread;  // query rows per CTA
constexpr float kNeg = -1e30f;
constexpr size_t kMaxSmemBytes = 232448;

enum DType { kF32 = 0, kBF16 = 1 };

// Shared-memory row strides.  D + 4 keeps rows 16-byte aligned for the float4
// reads and puts the 8 rows one quarter-warp reads on distinct banks.
__host__ __device__ constexpr int qk_stride(int d) { return d + 4; }
__host__ __device__ constexpr int p_stride(int kt) { return kt + 4; }

__host__ __device__ constexpr size_t smem_floats(int d, int kt) {
  return (size_t)kBlockRows * qk_stride(d) + (size_t)kt * qk_stride(d) + (size_t)kt * d +
         (size_t)kBlockRows * p_stride(kt);
}

// Max over the 16 lanes of a half-warp (the threads that share a row).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Loads rows [r0, r0 + rows) of one head of a (B, S, heads, D) tensor into
// dst (row stride `stride`), times `mul`; rows at or past s load as 0.
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int b, int s, int heads,
                                           int head, int d, int r0, int rows, int stride,
                                           float mul, float* dst) {
  for (int e = threadIdx.x; e < rows * d; e += kThreads) {
    const int r = e / d, col = e % d;
    const int row = r0 + r;
    float val = 0.f;
    if (row < s) val = src[(((size_t)b * s + row) * heads + head) * d + col] * mul;
    dst[r * stride + col] = val;
  }
}

// DV: accumulator columns per thread (D <= 16 * DV); KT: kv rows per tile.
template <int DV, int KT>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int s, int h, int hk, int d, int causal, int window,
                 float softcap, float scale) {
  constexpr int CJ = KT / 16;  // score columns per thread
  extern __shared__ __align__(16) float smem[];
  const int qst = qk_stride(d);
  constexpr int pst = p_stride(KT);
  float* qs = smem;
  float* ks = qs + kBlockRows * qst;
  float* vs = ks + KT * qst;
  float* ps = vs + KT * d;

  const int bh = blockIdx.x;
  const int b = bh / h, head = bh % h, kv_head = head / (h / hk);
  const int qb = gridDim.y - 1 - blockIdx.y;  // heaviest q blocks first
  const int q0 = qb * kBlockRows;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nd = d / 16;

  // kv tiles this q block needs: up to its last row if causal, from its first
  // row's window start if windowed.
  const int q_last = min(q0 + kBlockRows, s) - 1;
  const int kv_end = causal ? q_last + 1 : s;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / KT, t_end = (kv_end + KT - 1) / KT;

  stage_rows(q, b, s, h, head, d, q0, kBlockRows, qst, scale, qs);

  float acc[kRowsPerThread][DV];
  float m[kRowsPerThread], l[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DV; ++jj) acc[i][jj] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * KT;
    __syncthreads();  // the previous tile's K, V and p are consumed
    stage_rows(k, b, s, hk, kv_head, d, c0, KT, qst, 1.f, ks);
    stage_rows(v, b, s, hk, kv_head, d, c0, KT, d, 1.f, vs);
    __syncthreads();

    // scores = (q * scale) . k
    float sc[kRowsPerThread][CJ];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
    for (int dd = 0; dd < d; dd += 4) {
      float4 qv[kRowsPerThread], kv[CJ];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * qst + dd]);
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * qst + dd]);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

    // softcap, mask, online softmax; p goes to shared memory.
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = q0 + ty + 16 * i;
      bool ok[CJ];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = c0 + tx + 16 * j;
        float val = sc[i][j];
        if (softcap > 0.f) val = softcap * tanhf(val / softcap);
        ok[j] = c < s && (!causal || c <= r) && (window <= 0 || r - c < window);
        sc[i][j] = ok[j] ? val : kNeg;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        rs += p;
        ps[(ty + 16 * i) * pst + tx + 16 * j] = p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DV; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

    // acc += p . v
    for (int c = 0; c < KT; c += 4) {
      float4 pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * i) * pst + c]);
#pragma unroll
      for (int jj = 0; jj < DV; ++jj) {
        if (jj < nd) {
          const float* vc = &vs[c * d + tx + 16 * jj];
          const float v0 = vc[0], v1 = vc[d], v2 = vc[2 * d], v3 = vc[3 * d];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            float a = acc[i][jj];
            a = fmaf(pv[i].x, v0, a);
            a = fmaf(pv[i].y, v1, a);
            a = fmaf(pv[i].z, v2, a);
            a = fmaf(pv[i].w, v3, a);
            acc[i][jj] = a;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    float* orow = o + (((size_t)b * s + r) * h + head) * d;
#pragma unroll
    for (int jj = 0; jj < DV; ++jj)
      if (jj < nd) orow[tx + 16 * jj] = acc[i][jj] / l_safe;
  }
}

template <int DV, int KT>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s, int h, int hk,
           int d, int causal, int window, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(d, KT);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  auto kernel = flash_kernel<DV, KT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * h, (s + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), s, h, hk, d, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

// The kv tile: 64 rows for D <= 128, 32 above, so the fp32 staging of a
// D = 256 tile fits the CTA's shared memory.
int dispatch_d(const void* q, const void* k, const void* v, void* o, int b, int s, int h,
               int hk, int d, int causal, int window, float softcap, float scale,
               cudaStream_t stream) {
  const int nd = d / 16;
#define FLASH_LAUNCH(DV, KT) \
  launch<DV, KT>(q, k, v, o, b, s, h, hk, d, causal, window, softcap, scale, stream)
  if (nd <= 1) return FLASH_LAUNCH(1, 64);
  if (nd <= 2) return FLASH_LAUNCH(2, 64);
  if (nd <= 4) return FLASH_LAUNCH(4, 64);
  if (nd <= 8) return FLASH_LAUNCH(8, 64);
  if (nd <= 16) return FLASH_LAUNCH(16, 32);
#undef FLASH_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash

// q, o: (B, S, H, D); k, v: (B, S, Hk, D); all contiguous, one dtype
// (0 f32, 1 bf16), bf16 ones 16-byte aligned.  window <= 0 means none,
// softcap <= 0 means none.  This file and its header alone decide the
// geometry: the grid, the kv tile, the kv tiles each CTA walks and the shared
// memory it takes.  Returns a cudaError_t, or for bf16 one of
// flash_hopper's tensor-map codes (kNoEncodeEntry, kEncodeFailed + CUresult).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int b,
                               int s, int h, int hk, int d, int causal, int window,
                               float softcap, float scale, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || hk <= 0 || h % hk || d <= 0 || d % 16 || d > 256 ||
      s > 65535 * flash::kBlockRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == flash::kF32)
    return flash::dispatch_d(q, k, v, o, b, s, h, hk, d, causal, window, softcap, scale, st);
  if (dtype == flash::kBF16)
    return flash_hopper::dispatch(q, k, v, o, b, s, h, hk, d, causal, window, softcap, scale,
                                  st);
  return (int)cudaErrorInvalidValue;
}
