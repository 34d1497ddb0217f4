// Fused literal MatchAll -> packed span keys for Hopper (sm_90a).
//
// Replaces rejit_tpu/kernels/extract_pallas.py:literal_spans_pallas
// (_kernel): over a (Rows, 128) uint8 text, each position takes the first
// literal of the claim order (longest, then lowest pid, then index) that
// occurs there with pos + len <= n; each 128-byte row then gets up to `cap`
// int32 keys, lane << (ebits+pbits) | (lane + len) << pbits | pid, in
// increasing lane order, BIG = 1 << 30 in the empty slots, and its exact
// count of hits (exact past `cap`; cap = 0 writes the counts only).
// rejit_tpu_torch/kernels/extract_cuda.py holds the wrapper, the literal
// table (table_arrays) and the plain PyTorch version the kernel is held
// against.
//
// What bounds it on an H100: the function reads each text byte once and
// writes (cap + 1) * 4 bytes per 128-byte row, about 1.1 B per text byte at
// cap = 4 (3.35 TB/s); its operations are at least one compare per literal
// per position, about as costly as the bytes at a dozen literals
// (chip_smoke.py computes both from each run's text and takes the larger).
//
// Design: no cross-block state, so block order does not matter. A CUDA
// block stages kRowsPerBlock rows and the next kHalo bytes (pad_rows leaves
// at least max_len zero bytes past n; bytes past the array read as 0 and
// only feed positions that the validity rule rejects) in shared memory with
// 16-byte loads, and the literal table beside them. One warp takes one row
// at a time, four neighbouring positions per lane. A lane builds the
// 8-byte window at each of its positions from aligned words of the tile
// with __funnelshift_r, so every position is two registers. Each literal
// carries its first min(len, 8) bytes as two packed words with byte masks
// (two 16-byte broadcast loads per literal); a position tests it with one
// AND-XOR per word and one compare (masked bytes decide literals of 1-8
// bytes exactly), and the prefix test
// (with the validity rule on rows that reach n) selects (len, pid).
// Literals are visited in reverse claim order, so the first hit in claim
// order is the last select and wins without a branch. Only a literal
// longer than the prefix whose prefix matched compares its tail, a word at
// a time. A lane's hits become its rank by a warp prefix sum of popcounts
// (__shfl_up_sync), and each key is stored at its rank when that is below
// cap.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChl = 128;                       // bytes per row (lanes)
constexpr int kRowsPerBlock = 32;               // rows staged per block
constexpr int kThreads = 256;                   // 8 warps
constexpr int kHalo = 128;                      // literals are <= 128 bytes
constexpr int kTileBytes = kRowsPerBlock * kChl + kHalo;
constexpr int kTileWords = kTileBytes / 4;
constexpr int kMetaInts = 8;                    // ints per literal in lit_meta
constexpr int kWords = 2;                       // prefix words (8 bytes)
constexpr int kBig = 1 << 30;
constexpr size_t kSmemLimit = 232448;           // 227 KB per block on sm_90
constexpr size_t kSmemDefault = 48 * 1024;      // above: opt-in attribute

__host__ inline size_t smem_bytes(int nlit, int nwords) {
  return ((size_t)kMetaInts * nlit + kTileWords + nwords) * sizeof(int);
}

// Text bytes [i, i + len) equal the literal's bytes past its prefix, from
// byte 4 * kWords on; the literal's words are zero-padded past len.
__device__ inline bool tail_equal(const uint32_t* s_text, int i,
                                  const uint32_t* lit, int len) {
  for (int j = kWords; 4 * j < len; ++j) {
    const int b = i + 4 * j;
    const uint32_t w = __funnelshift_r(s_text[b >> 2], s_text[(b >> 2) + 1],
                                       8 * (b & 3));
    const int rem = len - 4 * j;
    const uint32_t m = rem >= 4 ? 0xffffffffu : (1u << (8 * rem)) - 1u;
    if ((w & m) != lit[j]) return false;
  }
  return true;
}

// The claim of one row's 4 positions per lane: win holds each position's
// kWords-word window, room n - pos (clamped); with kRoom the validity rule
// is tested (rows that reach n), else every literal fits.
template <bool kRoom>
__device__ __forceinline__ void claim_row(const int4* s_meta, int nlit,
                                          const uint32_t (&win)[4][kWords],
                                          const int (&room)[4],
                                          const uint32_t* s_text,
                                          const uint32_t* s_lit, int i0,
                                          int (&wlen)[4], int (&pid)[4]) {
  for (int L = nlit - 1; L >= 0; --L) {
    const int4 a = s_meta[2 * L];
    const int4 b = s_meta[2 * L + 1];
    const int len = a.z & 255;
    const int lp = a.z >> 8;
    uint32_t d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      d[k] = ((win[k][0] & (uint32_t)a.y) ^ a.x) |
             ((win[k][1] & (uint32_t)b.y) ^ b.x);
    bool hit[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      hit[k] = d[k] == 0 && (!kRoom || len <= room[k]);
    if (len > 4 * kWords) {  // the same for every lane of the warp
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (hit[k])
          hit[k] = tail_equal(s_text, i0 + k, s_lit + a.w, len);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wlen[k] = hit[k] ? len : wlen[k];
      pid[k] = hit[k] ? lp : pid[k];
    }
  }
}

// lit_meta: per literal in claim order, kMetaInts ints: prefix word 0, its
// mask, len | pid << 8, word offset of its bytes in lit_words, prefix word
// 1, its mask, 0, 0. lit_words: every literal's bytes, zero-padded to whole
// little-endian words.
__global__ void __launch_bounds__(kThreads)
literal_spans_kernel(const uint8_t* __restrict__ text,
                     const uint32_t* __restrict__ lit_words,
                     const int* __restrict__ lit_meta, int nlit, int nwords,
                     int* __restrict__ keys, int* __restrict__ counts,
                     int rows, int n, int cap, int ebits, int pbits) {
  extern __shared__ __align__(16) int smem[];
  int4* s_meta = reinterpret_cast<int4*>(smem);
  uint32_t* s_text = reinterpret_cast<uint32_t*>(smem + kMetaInts * nlit);
  uint32_t* s_lit = s_text + kTileWords;
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
  for (int x = threadIdx.x; x < kMetaInts * nlit; x += kThreads)
    smem[x] = lit_meta[x];
  for (int x = threadIdx.x; x < nwords; x += kThreads) s_lit[x] = lit_words[x];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned full = 0xffffffffu;
  for (int r = warp; r < kRowsPerBlock; r += kThreads / 32) {
    const long long row = row0 + r;
    if (row >= rows) break;  // the same for every lane of the warp
    // Windows at the lane's 4 positions: word j of position k holds bytes
    // 4j + k .. 4j + k + 3 past the lane's first position.
    const int w0 = r * (kChl / 4) + lane;
    uint32_t tw[kWords + 1];
#pragma unroll
    for (int j = 0; j <= kWords; ++j) tw[j] = s_text[w0 + j];
    uint32_t win[4][kWords];
    int room[4];  // n - pos, clamped: a literal fits where len <= room
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < kWords; ++j)
        win[k][j] = __funnelshift_r(tw[j], tw[j + 1], 8 * k);
      const long long left = (long long)n - (base + 4 * w0 + k);
      room[k] = (int)(left < 0 ? -1 : (left > kChl ? kChl : left));
    }
    int wlen[4] = {-1, -1, -1, -1};
    int pid[4] = {0, 0, 0, 0};
    // Every literal (<= kHalo bytes) fits at every position of a row that
    // ends kHalo bytes or more before n.
    if (base + (long long)(r + 1) * kChl + kHalo <= n)
      claim_row<false>(s_meta, nlit, win, room, s_text, s_lit, 4 * w0,
                               wlen, pid);
    else
      claim_row<true>(s_meta, nlit, win, room, s_text, s_lit, 4 * w0,
                              wlen, pid);
    unsigned hits = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) hits |= (unsigned)(wlen[k] >= 0) << k;
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
// launch (0 = launched), or cudaErrorInvalidValue for a literal table that
// does not fit a block's shared memory.
int literal_spans(const uint8_t* text, const uint32_t* lit_words,
                  const int* lit_meta, int nlit, int nwords, int* keys,
                  int* counts, int rows, int n, int cap, int ebits, int pbits,
                  cudaStream_t stream) {
  if (rows <= 0) return 0;
  const size_t smem = smem_bytes(nlit, nwords);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > kSmemDefault) {
    cudaError_t err = cudaFuncSetAttribute(
        literal_spans_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  literal_spans_kernel<<<blocks, kThreads, smem, stream>>>(
      text, lit_words, lit_meta, nlit, nwords, keys, counts, rows, n, cap,
      ebits, pbits);
  return (int)cudaGetLastError();
}

const char* literal_spans_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
