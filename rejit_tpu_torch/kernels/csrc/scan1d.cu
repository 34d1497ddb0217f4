// One-dimensional int32 cumulative scans for Hopper (sm_90a): the reverse
// cumulative min and the forward cumulative max.
//
// Replaces rejit_tpu/kernels/scan1d.py:_scan1d (_scan_kernel, through
// rcummin and cummax): out[p] = min(x[p:]) or max(x[:p+1]). The TPU kernel
// carried the running value across its sequential grid in SMEM; CUDA blocks
// run in no order, so the carry is explicit, in three launches:
//   1. scan1d_tile_agg: each block reduces one tile of kTile elements;
//   2. scan1d_carry:    one block scans the tile aggregates in scan order,
//                       giving each tile its exclusive carry-in;
//   3. scan1d_tile:     each block scans its tile from its carry-in.
// Exactness does not depend on block order. Any length works (no padding
// to the TPU's 65,536-element grain); the identity (INT_MAX for min,
// INT_MIN for max) fills the ragged end, so results equal torch.cummin /
// torch.cummax for any int32 input.
// rejit_tpu_torch/kernels/scan_cuda.py holds the wrapper and the plain
// PyTorch versions the kernel is held against.
//
// What bounds it on an H100: 8 bytes per element (4 read, 4 written) at
// 3.35 TB/s; one min or max per element is far below the lane rate. The
// three launches move 12 bytes per element (the tile is read twice), and
// tile reads are coalesced 128-byte warp loads. In scan3 a warp holds its
// 512 elements in registers (16 per lane) and scans them as 16 chunks of
// 32 by shuffles, carrying chunk to chunk; the block's 8 warps combine
// their aggregates through shared memory.
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;                    // 8 warps per tile block
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 16;                     // elements per lane
constexpr int kWarpSpan = 32 * kPerLane;         // 512 elements per warp
constexpr int kTile = kWarps * kWarpSpan;        // 4096 elements per tile
constexpr int kCarryThreads = 1024;

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
    v = comb<kMin>(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

// Load the warp's 16 chunks of 32 elements (identity past P).
template <bool kMin>
__device__ __forceinline__ void load_span(const int* __restrict__ x,
                                          long long start, long long P,
                                          int lane, int (&v)[kPerLane]) {
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    const long long g = start + c * 32 + lane;
    v[c] = g < P ? __ldg(x + g) : identity<kMin>();
  }
}

template <bool kMin>
__global__ void __launch_bounds__(kThreads)
scan1d_tile_agg(const int* __restrict__ x, int* __restrict__ agg,
                long long P) {
  __shared__ int s_w[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int v[kPerLane];
  load_span<kMin>(x, (long long)blockIdx.x * kTile + warp * kWarpSpan, P,
                  lane, v);
  int a = identity<kMin>();
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) a = comb<kMin>(a, v[c]);
  a = warp_reduce<kMin>(a);
  if (lane == 0) s_w[warp] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = identity<kMin>();
    for (int w = 0; w < kWarps; ++w) t = comb<kMin>(t, s_w[w]);
    agg[blockIdx.x] = t;
  }
}

// One block: carry[t] = the combine of the aggregates of every tile before
// t in scan order (after t for a reverse scan); the identity for the first.
template <bool kRev, bool kMin>
__global__ void __launch_bounds__(kCarryThreads)
scan1d_carry(const int* __restrict__ agg, int* __restrict__ carry,
             int ntiles) {
  __shared__ int s_w[kCarryThreads / 32];
  __shared__ int s_excl[kCarryThreads];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int run = identity<kMin>();
  for (int s0 = 0; s0 < ntiles; s0 += kCarryThreads) {
    const int s = s0 + threadIdx.x;                    // scan-order index
    const int t = kRev ? ntiles - 1 - s : s;           // tile index
    const int a = s < ntiles ? agg[t] : identity<kMin>();
    int incl = a;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl = comb<kMin>(incl, o);
    }
    if (lane == 31) s_w[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = s_w[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w = comb<kMin>(w, o);
      }
      s_w[lane] = w;                                   // inclusive by warp
    }
    __syncthreads();
    if (warp > 0) incl = comb<kMin>(incl, s_w[warp - 1]);
    s_excl[threadIdx.x] = incl;
    __syncthreads();
    const int before = threadIdx.x > 0 ? s_excl[threadIdx.x - 1]
                                       : identity<kMin>();
    if (s < ntiles) carry[t] = comb<kMin>(run, before);
    run = comb<kMin>(run, s_excl[kCarryThreads - 1]);
    __syncthreads();                                   // s_w, s_excl reused
  }
}

template <bool kRev, bool kMin>
__global__ void __launch_bounds__(kThreads)
scan1d_tile(const int* __restrict__ x, const int* __restrict__ carry,
            int* __restrict__ out, long long P) {
  __shared__ int s_w[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long start = (long long)blockIdx.x * kTile + warp * kWarpSpan;
  int v[kPerLane];
  load_span<kMin>(x, start, P, lane, v);
  int a = identity<kMin>();
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) a = comb<kMin>(a, v[c]);
  a = warp_reduce<kMin>(a);
  if (lane == 0) s_w[warp] = a;
  __syncthreads();
  // The warp's carry-in: the tile's, then the warps before it in scan order.
  int run = carry[blockIdx.x];
  if (kRev) {
    for (int w = kWarps - 1; w > warp; --w) run = comb<kMin>(run, s_w[w]);
  } else {
    for (int w = 0; w < warp; ++w) run = comb<kMin>(run, s_w[w]);
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = kRev ? kPerLane - 1 - i : i;
    int s = v[c];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      if (kRev) {
        const int o = __shfl_down_sync(0xffffffffu, s, d);
        if (lane + d < 32) s = comb<kMin>(s, o);
      } else {
        const int o = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s = comb<kMin>(s, o);
      }
    }
    s = comb<kMin>(s, run);
    const long long g = start + c * 32 + lane;
    if (g < P) out[g] = s;
    run = __shfl_sync(0xffffffffu, s, kRev ? 0 : 31);
  }
}

template <bool kRev, bool kMin>
cudaError_t launch(const int* x, int* out, int* scratch, long long P,
                   cudaStream_t stream) {
  const int ntiles = (int)((P + kTile - 1) / kTile);
  int* agg = scratch;
  int* carry = scratch + ntiles;
  scan1d_tile_agg<kMin><<<ntiles, kThreads, 0, stream>>>(x, agg, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan1d_carry<kRev, kMin><<<1, kCarryThreads, 0, stream>>>(agg, carry,
                                                            ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan1d_tile<kRev, kMin><<<ntiles, kThreads, 0, stream>>>(x, carry, out, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements per tile: the wrapper allocates 2 * ceil(P / tile) int32 of
// scratch (tile aggregates and carries).
int scan1d_tile_elems() { return kTile; }

// op 0: reverse cumulative min; op 1: forward cumulative max. Returns
// cudaGetLastError() after the last launch (0 = launched), the first
// failing launch's error, or cudaErrorInvalidValue for an unknown op.
int scan1d(const int* x, int* out, int* scratch, long long P, int op,
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
