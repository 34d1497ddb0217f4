// One-dimensional int32 cumulative scans for Hopper (sm_90a): the reverse
// cumulative min and the forward cumulative max.
//
// Replaces rejit_tpu/kernels/scan1d.py:_scan1d (_scan_kernel, through
// rcummin and cummax): out[p] = min(x[p:]) or max(x[:p+1]). The TPU kernel
// carried the running value across its sequential grid in SMEM. CUDA blocks
// run in no order, so the carry crosses tiles by a single-pass chained scan
// with decoupled look-back (Merrill and Garland), in one launch after one
// memset of the tile counter and the status words:
//   1. each block takes the next tile in scan order from an atomic counter
//      (a reverse scan hands out the last tile first), so every tile it
//      waits on belongs to a block that has already started;
//   2. it loads its tile once, with 16-byte vector loads (neighbouring
//      lanes on neighbouring int4s, kVecs in flight a lane), reduces it
//      and publishes the tile's aggregate;
//   3. it scans the tile in registers: each lane its own 4 elements of a
//      128-element chunk, then the warp's lanes by shuffles, chunk after
//      chunk;
//   4. warp 0 looks back over the tiles before it in scan order,
//      kLookback * 32 status words a round (lane l's k-th load the word
//      l + 32 k back), combining aggregates up to the nearest inclusive
//      value; at a word not yet published, lane 0 waits on that one word,
//      backing off from 32 ns up to kSleepMax; the block then publishes
//      its inclusive value;
//   5. every element takes the tile's carry and the warps before it
//      (through shared memory), and the tile is stored with 16-byte stores.
// A status word is 64 bits, the flag (not ready / aggregate / inclusive) in
// the high half and the value in the low half, since values span the whole
// int32 range: one release store writes it, relaxed (volatile-strength)
// loads read it and a fence follows the look-back. Each status word has a
// 128-byte line of its own (kStatusStride), so the writes of neighbouring
// tiles and the look-backs reading them do not contend for one line. min
// and max are exact, commutative and idempotent, so the result does not
// depend on which predecessors a tile combines. Any length and any 4-byte
// aligned base work: a base or output off a 16-byte boundary takes scalar
// loads and stores for the whole call, no element past P is read, and the
// identity (INT_MAX for min, INT_MIN for max) fills the ragged end.
// Results equal torch.cummin / torch.cummax for every int32 input;
// rejit_tpu_torch/kernels/scan_cuda.py holds the wrapper and the plain
// PyTorch versions the kernel is held against.
//
// What bounds it on an H100: 8 bytes per element (4 read, 4 written) at
// 3.35 TB/s; a min or max and a few shuffles per element are far below the
// lane rate. The tile is read once and written once, so the kernel moves
// those 8 bytes in one launch. What it does not hide is the look-back: a
// block holds its tile in registers from its loads to its stores, through
// the look-back's L2 round trips and any wait on a predecessor still
// loading, and while it waits it keeps no loads in flight.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8192;                  // elements per tile
constexpr int kItems = kTile / kThreads;     // elements per lane
constexpr int kVecs = kItems / 4;            // int4s per lane
constexpr int kWarpSpan = 32 * kItems;       // a warp's contiguous span
constexpr int kLookback = 2;                 // status words a lane a round
constexpr unsigned kSleepMax = 256;          // ns, the longest back-off
constexpr int kStatusStride = 16;            // 64-bit words: a 128-byte line
static_assert(kThreads % 32 == 0 && kWarps <= 32, "1 to 32 warps a block");
static_assert(kTile % (4 * kThreads) == 0, "whole int4s per lane");

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

template <bool kMin>
__device__ __forceinline__ int identity() {
  return kMin ? INT_MAX : INT_MIN;
}

template <bool kMin>
__device__ __forceinline__ int comb(int a, int b) {
  return kMin ? min(a, b) : max(a, b);
}

template <bool kMin>
__device__ __forceinline__ int warp_reduce(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = comb<kMin>(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long status_word(
    unsigned long long flag, int v) {
  return flag | (unsigned long long)(unsigned)v;
}

__device__ __forceinline__ int status_value(unsigned long long w) {
  return (int)(unsigned)w;
}

// Four elements from g on, the identity past P.
template <bool kMin>
__device__ __forceinline__ int4 load4_checked(const int* __restrict__ x,
                                              long long g, long long P) {
  const int id = identity<kMin>();
  int4 v;
  v.x = g < P ? __ldg(x + g) : id;
  v.y = g + 1 < P ? __ldg(x + g + 1) : id;
  v.z = g + 2 < P ? __ldg(x + g + 2) : id;
  v.w = g + 3 < P ? __ldg(x + g + 3) : id;
  return v;
}

__device__ __forceinline__ void store4_checked(int* __restrict__ out,
                                               long long g, long long P,
                                               int4 v) {
  if (g < P) out[g] = v.x;
  if (g + 1 < P) out[g + 1] = v.y;
  if (g + 2 < P) out[g + 2] = v.z;
  if (g + 3 < P) out[g + 3] = v.w;
}

// Warp 0 of the tile at scan position s > 0: the combine of every tile
// before it in scan order. A round reads kLookback * 32 status words back
// from `top`, word top - l - 32 k in lane l's k-th load (neighbouring
// lanes on neighbouring words), and combines them, nearest first, up to
// the nearest one that is not an aggregate. An inclusive word ends the
// look-back; with none, the next round starts past the window; at a word
// not yet published, lane 0 waits on that one word, backing off from
// 32 ns up to kSleepMax, and the next round starts at it.
template <bool kMin>
__device__ int look_back(const unsigned long long* status, int s, int lane) {
  int excl = identity<kMin>();
  for (int top = s - 1;;) {
    unsigned long long w[kLookback];
#pragma unroll
    for (int k = 0; k < kLookback; ++k) {
      const int i = top - lane - 32 * k;
      w[k] = i >= 0 ? load_relaxed(status + (long long)i * kStatusStride)
                    : status_word(kInclusive, identity<kMin>());
    }
    // The nearest word that is not an aggregate: load k, lane `first`.
    int k = 0, first = 32;
    unsigned stop = 0;
#pragma unroll
    for (int j = kLookback - 1; j >= 0; --j) {
      const unsigned b =
          __ballot_sync(kFull, (unsigned)(w[j] >> 32) != 1u);
      if (b) {
        stop = b;
        k = j;
      }
    }
    if (stop) first = __ffs(stop) - 1;
    unsigned long long wk = w[0];
#pragma unroll
    for (int j = 1; j < kLookback; ++j)
      if (j == k) wk = w[j];
    // Every word nearer than it, and it too when it is inclusive.
    const unsigned flag =
        (unsigned)(__shfl_sync(kFull, wk, first & 31) >> 32);
    int v = identity<kMin>();
#pragma unroll
    for (int j = 0; j < kLookback; ++j)
      if (j < k || !stop ||
          (j == k && (lane < first || (lane == first && flag == 2u))))
        v = comb<kMin>(v, status_value(w[j]));
    excl = comb<kMin>(excl, warp_reduce<kMin>(v));
    if (!stop) {
      top -= 32 * kLookback;
      continue;
    }
    if (flag == 2u) {
      __threadfence();
      return excl;
    }
    top -= first + 32 * k;
    if (lane == 0) {
      const unsigned long long* word = status + (long long)top * kStatusStride;
      for (unsigned ns = 32; (unsigned)(load_relaxed(word) >> 32) == 0;
           ns = min(2 * ns, kSleepMax))
        __nanosleep(ns);
    }
    __syncwarp();
  }
}

template <bool kRev, bool kMin, bool kVec>
__global__ void __launch_bounds__(kThreads)
scan1d_kernel(const int* __restrict__ x, int* __restrict__ out,
              unsigned* __restrict__ counter,
              unsigned long long* __restrict__ status, long long P,
              int ntiles) {
  __shared__ int s_pos;
  __shared__ int s_excl;
  __shared__ int s_warp[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) s_pos = (int)atomicAdd(counter, 1u);
  __syncthreads();
  const int s = s_pos;                          // position in scan order
  const int t = kRev ? ntiles - 1 - s : s;      // tile in memory order
  const long long tile0 = (long long)t * kTile;
  // Lane's int4 j holds elements base + 128 j .. + 3.
  const long long base = tile0 + warp * kWarpSpan + 4 * lane;
  const bool full = kVec && tile0 + kTile <= P;
  int4 v[kVecs];
  if (full) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      v[j] = __ldg(reinterpret_cast<const int4*>(x + base + 128 * j));
  } else {
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      v[j] = load4_checked<kMin>(x, base + 128 * j, P);
  }
  // The tile's aggregate first, published before the scan so that the
  // tiles after it find it early.
  int agg = identity<kMin>();
#pragma unroll
  for (int j = 0; j < kVecs; ++j)
    agg = comb<kMin>(agg, comb<kMin>(comb<kMin>(v[j].x, v[j].y),
                                     comb<kMin>(v[j].z, v[j].w)));
  agg = warp_reduce<kMin>(agg);
  if (lane == 0) s_warp[warp] = agg;
  __syncthreads();
  if (warp == 0) {
    agg = warp_reduce<kMin>(lane < kWarps ? s_warp[lane] : identity<kMin>());
    if (lane == 0)
      store_release(status + (long long)s * kStatusStride,
                    status_word(s == 0 ? kInclusive : kAggregate, agg));
  }
  // The warp's inclusive scan in scan order, chunk (128 elements) after
  // chunk: the lane's 4, then its lanes by shuffles, from the running
  // value of the chunks before.
  int run = identity<kMin>();
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = kRev ? kVecs - 1 - i : i;
    int4 a = v[j];
    if (kRev) {
      a.z = comb<kMin>(a.z, a.w);
      a.y = comb<kMin>(a.y, a.z);
      a.x = comb<kMin>(a.x, a.y);
    } else {
      a.y = comb<kMin>(a.x, a.y);
      a.z = comb<kMin>(a.y, a.z);
      a.w = comb<kMin>(a.z, a.w);
    }
    int incl = kRev ? a.x : a.w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      if (kRev) {
        const int o = __shfl_down_sync(kFull, incl, d);
        if (lane + d < 32) incl = comb<kMin>(incl, o);
      } else {
        const int o = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl = comb<kMin>(incl, o);
      }
    }
    int before = kRev ? __shfl_down_sync(kFull, incl, 1)
                      : __shfl_up_sync(kFull, incl, 1);
    if (lane == (kRev ? 31 : 0)) before = identity<kMin>();
    before = comb<kMin>(before, run);
    a.x = comb<kMin>(a.x, before);
    a.y = comb<kMin>(a.y, before);
    a.z = comb<kMin>(a.z, before);
    a.w = comb<kMin>(a.w, before);
    v[j] = a;
    run = comb<kMin>(run, __shfl_sync(kFull, incl, kRev ? 0 : 31));
  }
  if (warp == 0) {
    int excl = identity<kMin>();
    if (s > 0) {
      excl = look_back<kMin>(status, s, lane);
      if (lane == 0)
        store_release(status + (long long)s * kStatusStride,
                      status_word(kInclusive, comb<kMin>(excl, agg)));
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  // The warp's carry: the tiles before, then the warps before it in scan
  // order.
  int carry = s_excl;
  if (kRev) {
    for (int w = kWarps - 1; w > warp; --w) carry = comb<kMin>(carry, s_warp[w]);
  } else {
    for (int w = 0; w < warp; ++w) carry = comb<kMin>(carry, s_warp[w]);
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    int4 a = v[j];
    a.x = comb<kMin>(a.x, carry);
    a.y = comb<kMin>(a.y, carry);
    a.z = comb<kMin>(a.z, carry);
    a.w = comb<kMin>(a.w, carry);
    if (full)
      *reinterpret_cast<int4*>(out + base + 128 * j) = a;
    else
      store4_checked(out, base + 128 * j, P, a);
  }
}

template <bool kRev, bool kMin>
cudaError_t launch(const int* x, int* out, void* scratch, long long P,
                   cudaStream_t stream) {
  const long long nt = (P + kTile - 1) / kTile;
  if (nt > INT_MAX) return cudaErrorInvalidValue;
  const int ntiles = (int)nt;
  // scratch: the tile counter in line 0, then a status word a tile, each
  // in a line of its own.
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(
      words, 0, (size_t)(ntiles + 1) * kStatusStride * sizeof(*words), stream);
  if (err != cudaSuccess) return err;
  unsigned* counter = reinterpret_cast<unsigned*>(words);
  unsigned long long* status = words + kStatusStride;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  if (vec)
    scan1d_kernel<kRev, kMin, true><<<ntiles, kThreads, 0, stream>>>(
        x, out, counter, status, P, ntiles);
  else
    scan1d_kernel<kRev, kMin, false><<<ntiles, kThreads, 0, stream>>>(
        x, out, counter, status, P, ntiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements per tile.
int scan1d_tile_elems() { return kTile; }

// 64-bit words of scratch a call of P elements takes: the tile counter's
// line, then a status line a tile.
long long scan1d_scratch_words(long long P) {
  return ((P + kTile - 1) / kTile + 1) * kStatusStride;
}

// op 0: reverse cumulative min; op 1: forward cumulative max. x and out
// are 4-byte aligned. Returns the memset's error, else cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for an unknown
// op or more than INT_MAX tiles. scratch holds scan1d_scratch_words(P)
// words.
int scan1d(const int* x, int* out, void* scratch, long long P, int op,
           cudaStream_t stream) {
  if (P <= 0) return 0;
  if (op == 0) return (int)launch<true, true>(x, out, scratch, P, stream);
  if (op == 1) return (int)launch<false, false>(x, out, scratch, P, stream);
  return (int)cudaErrorInvalidValue;
}

const char* scan1d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
