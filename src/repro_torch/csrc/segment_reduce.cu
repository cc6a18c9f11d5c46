// K4: the trace schedule's segment reduce for sm_90a, one fused pass.
//
// Replaces src/repro/kernels/segment_reduce.py::_hist_kernel (launched by
// tile_histogram, twice per capacity, from schedule_counts_pallas) and its
// jitted twin _schedule_counts_jnp.  For a tile stride K and n_tiles bins it
// reads the trace's U unique (sender, receiver) pairs, in sender-major order,
// once and computes both histograms of a capacity together:
//
//   tile     = u_rcv[i] / K
//   remote   = u_snd[i] / K != tile
//   new_pair = u_new_src[i] || i == 0 || tile != u_rcv[i - 1] / K
//   halo[tile] += new_pair && remote      (unique remote sources per tile)
//   cut[tile]  += remote ? mult[i] : 0    (cut edges per tile)
//
// The TPU kernel one-hot-expands a block of tile ids and accumulates
// weights @ onehot on the MXU in float32, exact below 2^24.  Here the counts
// are int64 throughout (unsigned 64-bit atomics; every count is non-negative,
// so the reinterpretation is exact), so no 2^24 guard and no int32 wrap.
//
// Bound on the H100: bytes.  Each pair is read once (two indices, one flag
// byte, one int64 multiplicity) and each bin written once, at 3.35 TB/s;
// the work per byte is a division and a compare.  What limits it in
// practice is atomics.  Design: one pair per thread, coalesced loads, and
// enough CTAs (U / 256) to keep the SMs' memory pipes full.  The flag of
// pair i reads u_rcv[i - 1] from global memory, which may belong to the
// previous CTA.  Before the atomics each warp combines the lanes that hit
// the same tile (__match_any_sync, then a shuffle sum inside each group),
// so one lane per (warp, tile) adds: at the largest capacities n_tiles is
// 2-4, and a million pairs would otherwise hit a handful of addresses.
// Where tiles are many and distinct the combine finds nothing to merge and
// the pass is bound by the global atomics themselves.  Per-CTA histograms
// in shared memory were slower than this on the 10^7-edge sweep at every
// capacity tried, so there are none.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullWarp = 0xffffffffu;

typedef unsigned long long u64;

template <typename I>
__global__ void __launch_bounds__(kThreads)
    schedule_counts_kernel(const I* __restrict__ u_snd, const I* __restrict__ u_rcv,
                           const uint8_t* __restrict__ new_src, const int64_t* __restrict__ mult,
                           int64_t n, I k, int n_tiles, u64* __restrict__ halo,
                           u64* __restrict__ cut) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  // key -1: this lane adds nothing (past the end, local, or out of range;
  // the caller's geometry, n_tiles * K >= V > every receiver, excludes the
  // last).  Every lane reaches the warp collectives below.
  long long key = -1;
  u64 h = 0, c = 0;
  if (i < n) {
    const I tile = u_rcv[i] / k;
    if (tile < (I)n_tiles && u_snd[i] / k != tile) {
      key = (long long)tile;
      h = (new_src[i] != 0 || i == 0 || u_rcv[i - 1] / k != tile) ? 1ull : 0ull;
      c = (u64)mult[i];
    }
  }
  const unsigned peers = __match_any_sync(kFullWarp, key);
  u64 hs = 0, cs = 0;
  for (unsigned m = peers; m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    hs += __shfl_sync(peers, h, src);
    cs += __shfl_sync(peers, c, src);
  }
  if (key >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1) {
    if (hs) atomicAdd(&halo[key], hs);
    if (cs) atomicAdd(&cut[key], cs);
  }
}

template <typename I>
int launch(const void* u_snd, const void* u_rcv, const void* new_src, const void* mult,
           int64_t n, int64_t k, int n_tiles, void* halo, void* cut, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  schedule_counts_kernel<I><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const I*>(u_snd), static_cast<const I*>(u_rcv),
      static_cast<const uint8_t*>(new_src), static_cast<const int64_t*>(mult), n, (I)k, n_tiles,
      static_cast<u64*>(halo), static_cast<u64*>(cut));
  return (int)cudaGetLastError();
}

}  // namespace

// Adds the halo and cut counts of stride k over n pairs into the zeroed
// int64 arrays halo and cut (n_tiles each).  idx_bytes is 4 or 8: the width
// of u_snd and u_rcv.  k must fit the index type (k <= V).  Launches on
// stream; returns cudaGetLastError() after the launch.
extern "C" int schedule_counts(const void* u_snd, const void* u_rcv, const void* new_src,
                               const void* mult, void* halo, void* cut, int64_t n, int64_t k,
                               int n_tiles, int idx_bytes, void* stream) {
  if (n <= 0 || k <= 0 || n_tiles <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4) {
    if (k > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    return launch<int32_t>(u_snd, u_rcv, new_src, mult, n, k, n_tiles, halo, cut, s);
  }
  if (idx_bytes == 8) {
    return launch<int64_t>(u_snd, u_rcv, new_src, mult, n, k, n_tiles, halo, cut, s);
  }
  return (int)cudaErrorInvalidValue;
}
