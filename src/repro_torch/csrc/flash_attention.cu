// K5: causal online-softmax (flash) attention, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel, launched by
// flash_attention_bhsd (pl.pallas_call over the grid (B*H, S/BQ, S/BK), whose
// innermost kv axis a TPU walks in order, carrying the running max m, sum l and
// (BQ, D) accumulator in VMEM scratch across it).
//
// Both dtypes run on the tensor cores (wgmma), with tiles brought in by TMA
// into a ring of shared-memory stages, a producer warpgroup and consumer
// warpgroups of 64 query rows:
// - bf16, the serving path's: flash_attention_hopper.cuh (bf16 products,
//   exact in fp32; p split into two bf16 terms for p.v).
// - f32: flash_attention_tf32.cuh (3xTF32 products; V transposed K-major in
//   shared memory).
//
// The numbers follow the TPU kernel in both: q is scaled by D^-1/2 (bf16: its
// fp32 sum); the softcap c*tanh(s/c) (tanhf) is applied before the mask; a
// masked weight is exactly 0 (not left to exp underflow), so a row whose first
// tiles are all masked keeps m = -1e30 and corr = 1 until its first unmasked
// tile; l is clamped at 1e-30 before the divide.  GQA: query head h reads kv
// head h / (H / Hk) in place, with no repeated copy.
#include <cuda_runtime.h>

#include "flash_attention_hopper.cuh"
#include "flash_attention_tf32.cuh"

namespace flash {

enum DType { kF32 = 0, kBF16 = 1 };

// The fewest query rows a CTA of either kernel owns (the grid's y extent is
// at most 65535 blocks of them).
constexpr int kMinBlockRows = 64;

}  // namespace flash

// q, o: (B, S, H, D); k, v: (B, S, Hk, D); all contiguous, one dtype
// (0 f32, 1 bf16), 16-byte aligned.  window <= 0 means none, softcap <= 0
// means none.  This file and its headers alone decide the geometry: the
// grid, the kv tile, the kv tiles each CTA walks and the shared memory it
// takes.  Returns a cudaError_t, or one of hopper's tensor-map codes
// (kNoEncodeEntry, kEncodeFailed + CUresult).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int b,
                               int s, int h, int hk, int d, int causal, int window,
                               float softcap, float scale, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || hk <= 0 || h % hk || d <= 0 || d % 16 || d > 256 ||
      s > 65535 * flash::kMinBlockRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == flash::kF32)
    return flash_tf32::dispatch(q, k, v, o, b, s, h, hk, d, causal, window, softcap, scale, st);
  if (dtype == flash::kBF16)
    return flash_hopper::dispatch(q, k, v, o, b, s, h, hk, d, causal, window, softcap, scale,
                                  st);
  return (int)cudaErrorInvalidValue;
}
