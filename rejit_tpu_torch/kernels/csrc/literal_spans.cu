// Fused literal MatchAll -> packed span keys for Hopper (sm_90a).
//
// Replaces rejit_tpu/kernels/extract_pallas.py:literal_spans_pallas
// (_kernel): over a (Rows, 128) uint8 text, each position takes the first
// literal of the claim order (longest, then lowest pid, then index) that
// occurs there with pos + len <= n; each 128-byte row then gets up to `cap`
// int32 keys, lane << (ebits+pbits) | (lane + len) << pbits | pid, in
// increasing lane order, BIG = 1 << 30 in the empty slots, and its exact
// count of hits (exact past `cap`; cap = 0 writes the counts only).
// rejit_tpu_torch/kernels/extract_cuda.py holds the wrapper and the plain
// PyTorch version the kernel is held against.
//
// What bounds it on an H100: the function reads each text byte once and
// writes (cap + 1) * 4 bytes per 128-byte row, about 1.1 B per text byte at
// cap = 4 (3.35 TB/s); its operations are the byte compares of the claim,
// at least one per literal per position and one more per matched prefix
// byte, so a set of k literals needs about k compares per byte, about as
// costly as the bytes at a dozen literals (chip_smoke.py computes both from
// each run's text and takes the larger).
//
// Design: no cross-block state, so block order does not matter (the TPU's
// clamped next-row halo is not needed). A CUDA block stages kRowsPerBlock
// rows and the next kHalo bytes (pad_rows leaves at least max_len zero bytes
// past n; bytes past the array read as 0 and only feed positions that the
// validity rule rejects) in shared memory with 16-byte loads, and the
// literal table (bytes, offsets, lengths, pids, in claim order) beside them.
// One warp takes one row at a time, four neighbouring positions per lane,
// so the lanes' text reads hit distinct banks and each literal byte is a
// broadcast. A lane's hits become its rank by a warp prefix sum of
// popcounts (__shfl_up_sync), and each key is stored at its rank when that
// is below cap.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChl = 128;                       // bytes per row (lanes)
constexpr int kRowsPerBlock = 32;               // rows staged per block
constexpr int kThreads = 256;                   // 8 warps
constexpr int kHalo = 128;                      // literals are <= 128 bytes
constexpr int kTileBytes = kRowsPerBlock * kChl + kHalo;
constexpr int kBig = 1 << 30;
constexpr size_t kSmemLimit = 232448;           // 227 KB per block on sm_90
constexpr size_t kSmemDefault = 48 * 1024;      // above: opt-in attribute

__host__ __device__ inline size_t meta_bytes(int nlit) {
  return ((size_t)3 * nlit * sizeof(int) + 15) / 16 * 16;
}

__host__ inline size_t smem_bytes(int nlit, int lit_total) {
  return meta_bytes(nlit) + kTileBytes + (size_t)lit_total;
}

// lit_meta: offsets[nlit], lengths[nlit], pids[nlit] (claim order).
__global__ void __launch_bounds__(kThreads)
literal_spans_kernel(const uint8_t* __restrict__ text,
                     const uint8_t* __restrict__ lit_bytes,
                     const int* __restrict__ lit_meta, int nlit,
                     int lit_total, int* __restrict__ keys,
                     int* __restrict__ counts, int rows, int n, int cap,
                     int ebits, int pbits) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_meta = reinterpret_cast<int*>(smem);
  uint8_t* s_text = smem + meta_bytes(nlit);
  uint8_t* s_lit = s_text + kTileBytes;
  const long long P = (long long)rows * kChl;
  const long long row0 = (long long)blockIdx.x * kRowsPerBlock;
  const long long base = row0 * kChl;

  // P is a multiple of 128, so a 16-byte word is either all inside or all
  // past the text.
  for (int v = threadIdx.x; v < kTileBytes / 16; v += kThreads) {
    const long long g = base + 16LL * v;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (g < P) w = __ldg(reinterpret_cast<const uint4*>(text + g));
    reinterpret_cast<uint4*>(s_text)[v] = w;
  }
  for (int x = threadIdx.x; x < 3 * nlit; x += kThreads) s_meta[x] = lit_meta[x];
  for (int x = threadIdx.x; x < lit_total; x += kThreads) s_lit[x] = lit_bytes[x];
  __syncthreads();

  const int* s_off = s_meta;
  const int* s_len = s_meta + nlit;
  const int* s_pid = s_meta + 2 * nlit;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned full = 0xffffffffu;
  for (int r = warp; r < kRowsPerBlock; r += kThreads / 32) {
    const long long row = row0 + r;
    if (row >= rows) break;  // the same for every lane of the warp
    int wlen[4], pid[4];
    unsigned hits = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = r * kChl + lane * 4 + k;
      const long long pos = base + i;
      wlen[k] = -1;
      pid[k] = 0;
      for (int L = 0; L < nlit; ++L) {
        const int len = s_len[L];
        if (pos + len > n) continue;
        const uint8_t* lit = s_lit + s_off[L];
        int j = 0;
        while (j < len && s_text[i + j] == lit[j]) ++j;
        if (j == len) {
          wlen[k] = len;
          pid[k] = s_pid[L];
          hits |= 1u << k;
          break;
        }
      }
    }
    const int c = __popc(hits);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(full, incl, d);
      if (lane >= d) incl += t;
    }
    const int total = __shfl_sync(full, incl, 31);
    if (cap > 0) {
      int* krow = keys + row * cap;
      int rank = incl - c;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((hits >> k) & 1u) {
          if (rank < cap) {
            const int l = lane * 4 + k;
            krow[rank] = (l << (ebits + pbits)) | ((l + wlen[k]) << pbits) |
                         pid[k];
          }
          ++rank;
        }
      }
      for (int j = total + lane; j < cap; j += 32) krow[j] = kBig;
    }
    if (lane == 0) counts[row] = total;
  }
}

}  // namespace

extern "C" {

// keys may be null when cap == 0. Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue when the literal table
// does not fit a block's shared memory.
int literal_spans(const uint8_t* text, const uint8_t* lit_bytes,
                  const int* lit_meta, int nlit, int lit_total, int* keys,
                  int* counts, int rows, int n, int cap, int ebits, int pbits,
                  cudaStream_t stream) {
  if (rows <= 0) return 0;
  const size_t smem = smem_bytes(nlit, lit_total);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > kSmemDefault) {
    cudaError_t err = cudaFuncSetAttribute(
        literal_spans_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  literal_spans_kernel<<<blocks, kThreads, smem, stream>>>(
      text, lit_bytes, lit_meta, nlit, lit_total, keys, counts, rows, n, cap,
      ebits, pbits);
  return (int)cudaGetLastError();
}

const char* literal_spans_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
