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
// Integer sums are exact in any order, so every route below gives the plain
// version's counts bit for bit.
//
// Bound on the H100: bytes.  Each pair is read once (two ids, one flag byte,
// one int64 multiplicity) and each bin written once, at 3.35 TB/s.  The
// design keeps the work per byte small and the atomics few:
//   * A persistent grid (as many CTAs as fit the SMs at once, fewer when U is
//     small).  Each thread takes a run of kRun = 8 consecutive pairs, a warp
//     256, and the grid strides over the runs.  A run is read with vector
//     loads (two of four int32 ids, one of 8 flag bytes, four of two
//     multiplicities) where the operands start on 16 bytes, else element by
//     element.  Longer runs were slower on the 10^7-edge sweep: their
//     registers let fewer CTAs share an SM.
//   * No division: x / K is a multiply and a shift by the host's magic
//     constants (repro_torch.kernels.segment_reduce.div_magic, exact for every
//     id the index type holds).  A run divides u_rcv[i0 - 1] once for its
//     first flag and then reuses the previous pair's tile.
//   * Run-length accumulation: receivers are sorted within each sender, so
//     consecutive remote pairs mostly share a tile (on the 10^7-edge sweep the
//     tile changes 2 to 390,715 times in 1,345,825 pairs).  A thread adds
//     into one register (tile, halo, cut) triple and flushes it only when the
//     tile changes; at the end the warp sums equal tiles of neighbouring lanes
//     with a log-depth segmented scan, and the last lane of each segment
//     flushes.
//   * The flush target is the host's route per capacity: with few tiles a
//     per-CTA histogram in shared memory (64 KB), added to device memory once
//     per CTA and non-zero bin; with many, device memory directly.
//   * Packed counts: where the host proves that halo and cut stay below 2^32
//     (U bounds the first, the caller's total multiplicity the second), the
//     shared histogram holds them as two 32-bit words (8 bytes a bin, so 8192
//     bins fit), added with 32-bit shared atomics; the 64-bit shared atomic
//     add compiles to a compare-and-swap loop (ATOMS.CAST.SPIN.64), which
//     nearly doubled the shared route's time.  On the direct route
//     the two travel as one 64-bit word (halo << 32 | cut) in the cut array,
//     so a flush is one atomic, and a second small kernel splits the words
//     in place.  Otherwise, as at the 2^53-scale multiplicities, halo and cut
//     take a 64-bit atomic each.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;                        // consecutive pairs a thread takes
constexpr int kHistBytes = 65536;              // the shared-memory histogram, at most
constexpr unsigned kFullWarp = 0xffffffffu;

typedef unsigned long long u64;

// Route bits; repro_torch.kernels.segment_reduce.k4_route chooses them.
enum Route { kShared = 1, kPacked = 2 };

struct Magic {
  u64 m;      // x / K == (x * m) >> shift for every id of the index type
  int shift;
};

__device__ __forceinline__ int32_t div_k(int32_t x, Magic g) {
  // x < 2^31 and m <= 2^32, so the product fits 63 bits.
  return (int32_t)(((u64)(uint32_t)x * g.m) >> g.shift);
}

__device__ __forceinline__ int64_t div_k(int64_t x, Magic g) {
  // x < 2^63; shift is 63 + ceil(log2 K), from 63 to 126.
  const u64 hi = __umul64hi((u64)x, g.m), lo = (u64)x * g.m;
  return (int64_t)(g.shift >= 64 ? hi >> (g.shift - 64)
                                 : (hi << (64 - g.shift)) | (lo >> g.shift));
}

// kRun elements of v from v[i0], by loads of up to 16 bytes when `vec`, else
// one by one (zero past n).
template <typename T>
__device__ __forceinline__ void load_run(T (&r)[kRun], const T* __restrict__ v, int64_t i0,
                                         int64_t n, bool vec) {
  constexpr int kBytes = kRun * (int)sizeof(T) < 16 ? kRun * (int)sizeof(T) : 16;
  using V = typename std::conditional<kBytes == 16, uint4,
                                      typename std::conditional<kBytes == 8, uint2,
                                                                unsigned>::type>::type;
  static_assert(kBytes >= 4 && sizeof(V) == kBytes, "unsupported run length");
  if (vec && i0 + kRun <= n) {
    constexpr int kPer = kBytes / sizeof(T);
    const V* p = reinterpret_cast<const V*>(v + i0);
#pragma unroll
    for (int q = 0; q < kRun / kPer; ++q) {
      const V w = __ldg(p + q);
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int j = 0; j < kPer; ++j) r[q * kPer + j] = e[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) r[j] = i0 + j < n ? v[i0 + j] : T(0);
  }
}

struct Params {
  const void* u_snd;
  const void* u_rcv;
  const uint8_t* new_src;
  const int64_t* mult;
  u64* halo;
  u64* cut;  // the packed words, on the direct packed route
  int64_t n;
  Magic magic;
  int n_tiles;
  int pack_shift;
  int vec;
};

template <bool Packed, bool Shared>
struct Sink {
  u64* bins;  // Shared: n_tiles (halo, cut) pairs of u32 (Packed) or u64
  const Params& p;

  __device__ __forceinline__ void add(long long tile, u64 h, u64 c) const {
    if (Packed && Shared) {
      // Both fields stay below 2^32: 32-bit shared atomics.
      unsigned* b = reinterpret_cast<unsigned*>(bins) + 2 * tile;
      if (h) atomicAdd(b, (unsigned)h);
      if (c) atomicAdd(b + 1, (unsigned)c);
    } else if (Packed) {
      atomicAdd(&p.cut[tile], (h << p.pack_shift) | c);
    } else {
      u64* hb = Shared ? &bins[2 * tile] : &p.halo[tile];
      u64* cb = Shared ? &bins[2 * tile + 1] : &p.cut[tile];
      if (h) atomicAdd(hb, h);
      if (c) atomicAdd(cb, c);
    }
  }
};

template <typename I, bool Packed, bool Shared>
__global__ void __launch_bounds__(kThreads)
    schedule_counts_kernel(const __grid_constant__ Params p) {
  extern __shared__ u64 bins[];
  const Sink<Packed, Shared> sink{bins, p};
  const int words = Packed ? p.n_tiles : 2 * p.n_tiles;
  if (Shared) {
    for (int b = threadIdx.x; b < words; b += kThreads) bins[b] = 0;
    __syncthreads();
  }
  const I* u_snd = static_cast<const I*>(p.u_snd);
  const I* u_rcv = static_cast<const I*>(p.u_rcv);
  const bool vec = p.vec != 0;
  long long cur = -1;  // the tile of the register run, -1 for none
  u64 h = 0, c = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads * kRun;
  for (int64_t i0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kRun; i0 < p.n;
       i0 += stride) {
    I rcv[kRun], snd[kRun];
    uint8_t flag[kRun];
    int64_t mult[kRun];
    load_run(rcv, u_rcv, i0, p.n, vec);
    load_run(snd, u_snd, i0, p.n, vec);
    load_run(flag, p.new_src, i0, p.n, vec);
    load_run(mult, p.mult, i0, p.n, vec);
    // The tile before the run; -1 makes pair 0 start a run.
    I prev = i0 > 0 ? div_k(u_rcv[i0 - 1], p.magic) : I(-1);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (i0 + j >= p.n) break;
      const I tile = div_k(rcv[j], p.magic);
      const bool new_pair = flag[j] != 0 || tile != prev;
      prev = tile;
      // Tiles past n_tiles cannot occur (n_tiles * K >= V > every id).
      if (tile != div_k(snd[j], p.magic) && tile < (I)p.n_tiles) {
        if ((long long)tile != cur) {
          if (cur >= 0) sink.add(cur, h, c);
          cur = tile;
          h = c = 0;
        }
        h += new_pair ? 1ull : 0ull;
        c += (u64)mult[j];
      }
    }
  }
  // The last runs: a segmented inclusive scan over lanes with equal tiles
  // (each lane's partial covers lanes back to its segment's head once `head`
  // is set), then the last lane of each segment flushes.
  const int lane = threadIdx.x & 31;
  const long long left = __shfl_up_sync(kFullWarp, cur, 1);
  const long long right = __shfl_down_sync(kFullWarp, cur, 1);
  bool head = lane == 0 || left != cur;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 hu = __shfl_up_sync(kFullWarp, h, d), cu = __shfl_up_sync(kFullWarp, c, d);
    const bool fu = __shfl_up_sync(kFullWarp, head, d);
    if (lane >= d && !head) {
      h += hu;
      c += cu;
      head = fu;
    }
  }
  if (cur >= 0 && (lane == 31 || right != cur)) sink.add(cur, h, c);
  if (Shared) {
    // The CTA's histogram into device memory, once per non-zero bin.
    __syncthreads();
    for (int b = threadIdx.x; b < p.n_tiles; b += kThreads) {
      u64 hb, cb;
      if (Packed) {
        const unsigned* w = reinterpret_cast<const unsigned*>(bins) + 2 * b;
        hb = w[0];
        cb = w[1];
      } else {
        hb = bins[2 * b];
        cb = bins[2 * b + 1];
      }
      if (hb) atomicAdd(&p.halo[b], hb);
      if (cb) atomicAdd(&p.cut[b], cb);
    }
  }
}

// The direct packed route's second pass: cut[b] holds halo << S | cut.
__global__ void __launch_bounds__(kThreads)
    unpack_kernel(u64* __restrict__ halo, u64* __restrict__ cut, int n_tiles, int shift) {
  for (int b = blockIdx.x * kThreads + threadIdx.x; b < n_tiles; b += gridDim.x * kThreads) {
    const u64 w = cut[b];
    halo[b] = w >> shift;
    cut[b] = w & ((1ull << shift) - 1);
  }
}

template <typename I, bool Packed, bool Shared>
int launch(const Params& p, cudaStream_t stream) {
  auto kernel = schedule_counts_kernel<I, Packed, Shared>;
  const size_t smem = Shared ? (size_t)p.n_tiles * (Packed ? 8 : 16) : 0;
  if (smem > (size_t)kHistBytes) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      Shared ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
             : cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t runs = (p.n + (int64_t)kThreads * kRun - 1) / ((int64_t)kThreads * kRun);
  const int64_t fit = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(runs < fit ? runs : fit);
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || Shared || !Packed) return (int)e;
  const int ub = (p.n_tiles + kThreads - 1) / kThreads;
  unpack_kernel<<<ub < 4 * sms ? ub : 4 * sms, kThreads, 0, stream>>>(p.halo, p.cut, p.n_tiles,
                                                                     p.pack_shift);
  return (int)cudaGetLastError();
}

template <typename I>
int dispatch(const Params& p, int route, cudaStream_t s) {
  switch (route) {
    case 0: return launch<I, false, false>(p, s);
    case kShared: return launch<I, false, true>(p, s);
    case kPacked: return launch<I, true, false>(p, s);
    case kShared | kPacked: return launch<I, true, true>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Adds the halo and cut counts of stride k over n pairs into the zeroed
// int64 arrays halo and cut (n_tiles each).  idx_bytes is 4 or 8: the width
// of u_snd and u_rcv; k must fit the index type (k <= V).  magic and
// div_shift divide an id by k (div_magic); route is k4_route's: bit 0 the
// shared-memory histogram, bit 1 packed counts with halo above bit
// pack_shift.  Launches on stream; returns cudaGetLastError() after the
// launches.
extern "C" int schedule_counts(const void* u_snd, const void* u_rcv, const void* new_src,
                               const void* mult, void* halo, void* cut, int64_t n, int64_t k,
                               int64_t magic, int n_tiles, int idx_bytes, int div_shift,
                               int route, int pack_shift, void* stream) {
  if (n <= 0 || k <= 0 || n_tiles <= 0) return (int)cudaErrorInvalidValue;
  if ((route & kPacked) && (pack_shift < 1 || pack_shift > 63)) return (int)cudaErrorInvalidValue;
  const int lo = idx_bytes == 4 ? 31 : 63, hi = idx_bytes == 4 ? 62 : 126;
  if (div_shift < lo || div_shift > hi) return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)u_snd | (uintptr_t)u_rcv | (uintptr_t)new_src |
                          (uintptr_t)mult;
  const Params p{u_snd, u_rcv, static_cast<const uint8_t*>(new_src),
                 static_cast<const int64_t*>(mult), static_cast<u64*>(halo),
                 static_cast<u64*>(cut), n, Magic{(u64)magic, div_shift}, n_tiles,
                 (route & kPacked) ? pack_shift : 0, (align & 15) == 0 ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4) {
    if (k > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    return dispatch<int32_t>(p, route, s);
  }
  if (idx_bytes == 8) return dispatch<int64_t>(p, route, s);
  return (int)cudaErrorInvalidValue;
}
