// MatchAllCount of a literal set in one pass over the text, for Hopper
// (sm_90a).
//
// Replaces rejit_tpu/kernels/literal.py:literal_count_device (:50), which
// has no Pallas kernel: XLA fuses its shifted compares, the validity mask
// and the sum into one streaming pass. rejit_tpu_torch/kernels/literal.py
// holds the wrapper, the tables (count_tables) and the plain PyTorch
// version (literal_count_plain) the kernel is held against.
//
// What it computes, for one group of the set's literals: the number of
// (literal, i) with i in [0, P), the literal at text[i, i + len) and
// i <= n - len. The wrapper launches one group after another into the same
// int64 counter, which the first launch's memset zeroes.
//
// Algorithm: multi-pattern Shift-And. The group's literals lie end to end
// in a state of KW 32-bit words, one bit a position; T[c] has the bit of
// every position that byte c may stand at (every byte of a class
// position), S the bit of each literal's first position, F that of its
// last. A byte c steps the state D = ((D << 1) | S) & T[c] (bit 31 of a
// word carries into the next), and popc(D & F) literals end there. Where
// the state has room, each literal is followed by kCheck - 1 positions
// that every byte fits (T has their bits for all c), so an end bit lives
// on for kCheck steps: the kernel then counts popc(D & C) once every
// kCheck bytes (C: F and those positions), at the last byte of each
// aligned group of kCheck bytes, and each end is seen exactly once. (A bit
// that walks on from the last of them lands on the next literal's first
// position, where | S sets it anyway, or is masked out.) A literal longer
// than the state (the group holds it alone, kCheck = 1) keeps its first
// 32 * KW positions in the state; where they end, its tail is compared
// byte by byte against a 256-bit set a position.
//   Validity: a match ending at e is counted when e < E = min(n, P + lp - 1)
// (lp: the group's longest literal in the state), and no match may start
// at or past P: there the step masks S out of the shifted state,
// D = ((D << 1) & ~S) & T[c], so the start bound of every literal holds
// with no per-literal test. (A long literal's full end is tested against n
// in its tail compare.)
//   Work split: the text is cut at 32-byte-aligned addresses into segments
// of `seg` bytes (the wrapper's segment_bytes: 64, or 4 lp where that is
// more), one a thread at a time (a grid-stride loop over a persistent
// grid), so a warp's loads cover 32 neighbouring segments. A match is
// counted by the thread whose segment holds its last byte; each segment
// first steps the lp - 1 bytes before it, counting nothing. An unaligned
// text is read from the aligned address below it, its leading bytes
// skipped. Segments that hold the text's first bytes, E or P test every
// position and count every byte by F; the others step 32 bytes (two
// 16-byte loads of one sector) a trip with no test.
//
// What bounds it on an H100: the text read once, E bytes at 3.35e12 B/s
// (2e9 bytes: 0.597 ms); the steps, about 2.5 ALU lane instructions a byte
// at KW = 1 and kCheck = 8 (the byte's extract, the step's LOP3 and an
// eighth of the count's three), beside two IMADs (table address, shift)
// and the table load on other pipes: 2e9 x 2.5 over 132 SMs x 64 INT32
// lanes x 1.755 GHz = 0.34 ms, and about 5.5 warp instructions a byte to
// issue, 2e9 / 32 x 5.5 over 132 x 4 schedulers x 1.755 GHz = 0.37 ms
// (the warm-up adds lp - 1 steps a segment: 3% at lp = 3).
// max(bytes, operations) = 0.597 ms: the bytes bound it. Each further
// state word adds a funnel shift, a LOP3 and a table load a byte.
//
// Design against that: the table sits in shared memory once per bank
// (entry (c, w) at [(c * KW + w) * 32 + lane]), so every warp lookup is one
// wavefront whatever the bytes; without it random bytes cost ~2.8
// wavefronts a lookup (PERF.md §6, gather_probe). Each thread reads its
// segment 32 bytes a trip and requests the next 32 before it steps the
// current ones. The count is branch-free where kCheck > 1; where it is 1
// it is one test a byte and a branch that is rarely taken for overlap-free
// sets. Counts are reduced over the warp with shuffles, then one 64-bit
// atomicAdd a warp: integer atomics give the same total in any order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 4;   // state words of the widest instance
constexpr int kMaxDevices = 64;

struct Masks {
  uint32_t start[kMaxWords];   // S: each literal's first position
  uint32_t accept[kMaxWords];  // F: each literal's last state position
  uint32_t check[kMaxWords];   // C: F and the kCheck - 1 positions after
};

struct Scan {
  const uint8_t* base;         // the text's address rounded down to 32
  long long head;              // text - base, 0..31
  long long P;                 // no match starts at or past P
  long long E;                 // no match ends at or past E
  long long n;                 // the text's true length (long literals)
  long long nseg;              // segments of `seg` bytes from base
  const uint32_t* tail;        // long literal: 8 words a position past lp
  int tail_len;                // 0: every literal lies in the state
  int lp;                      // the group's longest literal in the state
  int seg;                     // bytes a segment, a multiple of 32
};

__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Byte j of the 16 in v.
__device__ __forceinline__ uint32_t byte_at(const uint4& v, int j) {
  const uint32_t x = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return __byte_perm(x, 0, 0x4440 + (j & 3));
}

// One byte of the Shift-And automaton; `start` lets new matches begin.
template <int KW>
__device__ __forceinline__ void step(uint32_t (&d)[KW], const uint32_t* tl,
                                     uint32_t c, const Masks& m, bool start) {
  const uint32_t* t = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const char*>(tl) + c * (KW * 128u));
  uint32_t below = 0;  // the word below's state before the step
#pragma unroll
  for (int w = 0; w < KW; ++w) {
    const uint32_t sh = w == 0 ? d[0] << 1 : __funnelshift_l(below, d[w], 1);
    below = d[w];
    const uint32_t x = start ? (sh | m.start[w]) : (sh & ~m.start[w]);
    d[w] = x & t[w * 32];
  }
}

template <int KW>
__device__ __forceinline__ uint32_t accepted(const uint32_t (&d)[KW],
                                             const Masks& m) {
  uint32_t a = 0;
#pragma unroll
  for (int w = 0; w < KW; ++w) a |= d[w] & m.accept[w];
  return a;
}

// The long literal of a group whose first lp positions end at p: its
// tail, tail_len bytes from p + 1, against its byte sets, and its end
// against n.
__device__ __noinline__ unsigned tail_match(const uint8_t* text,
                                            const uint32_t* tail,
                                            int tail_len, long long n,
                                            long long p) {
  if (p + tail_len >= n) return 0;
  for (int j = 0; j < tail_len; ++j) {
    const uint32_t c = __ldg(text + p + 1 + j);
    if (!((__ldg(tail + 8 * j + (c >> 5)) >> (c & 31)) & 1u)) return 0;
  }
  return 1;
}

// The literals that end at p, where accepted() is not 0.
template <int KW>
__device__ __forceinline__ unsigned hits(const uint32_t (&d)[KW],
                                         const Masks& m, const Scan& s,
                                         long long p) {
  if (s.tail_len)
    return tail_match(s.base + s.head, s.tail, s.tail_len, s.n, p);
  unsigned c = 0;
#pragma unroll
  for (int w = 0; w < KW; ++w) c += __popc(d[w] & m.accept[w]);
  return c;
}

// 16 bytes at positions p0.. with every position tested: stepped where
// lo <= p < s1 (new matches only below P), counted by F where p >= s0.
template <int KW, bool kCount>
__device__ __forceinline__ void edge16(uint32_t (&d)[KW],
                                       unsigned long long& cnt, uint4 v,
                                       long long p0, long long lo,
                                       long long s0, long long s1,
                                       const uint32_t* tl, const Masks& m,
                                       const Scan& s) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const long long p = p0 + j;
    if (p < lo || p >= s1) continue;
    step<KW>(d, tl, byte_at(v, j), m, p < s.P);
    if (kCount && p >= s0 && accepted<KW>(d, m))
      cnt += hits<KW>(d, m, s, p);
  }
}

// 16 bytes at positions p0.. inside [0, min(E, P)), p0 a multiple of 16
// from the segment's start: no position test.
template <int KW, int kCheck>
__device__ __forceinline__ void fast16(uint32_t (&d)[KW],
                                       unsigned long long& cnt, uint4 v,
                                       long long p0, const uint32_t* tl,
                                       const Masks& m, const Scan& s) {
  if constexpr (kCheck == 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      step<KW>(d, tl, byte_at(v, j), m, true);
      if (accepted<KW>(d, m)) cnt += hits<KW>(d, m, s, p0 + j);
    }
  } else {
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      step<KW>(d, tl, byte_at(v, j), m, true);
      if ((j + 1) % kCheck == 0) {
#pragma unroll
        for (int w = 0; w < KW; ++w) c += __popc(d[w] & m.check[w]);
      }
    }
    cnt += c;
  }
}

template <int KW, int kCheck>
__global__ void __launch_bounds__(kThreads)
literal_count_kernel(const uint32_t* __restrict__ table, Masks m, Scan s,
                     unsigned long long* __restrict__ out) {
  extern __shared__ uint32_t s_table[];  // [256][KW][32 banks]
  for (int x = threadIdx.x; x < 256 * KW * 32; x += kThreads)
    s_table[x] = table[x >> 5];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint32_t* tl = s_table + lane;
  unsigned long long cnt = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
       k < s.nseg; k += stride) {
    const long long q0 = k * s.seg;
    const long long q1 = q0 + s.seg;
    uint32_t d[KW];
#pragma unroll
    for (int w = 0; w < KW; ++w) d[w] = 0;
    if (q0 - (s.lp - 1) >= s.head && q1 - s.head <= s.E &&
        q1 - s.head <= s.P) {
      uint4 a = load16(s.base + q0), b = load16(s.base + q0 + 16);
      for (long long q = q0 - (s.lp - 1); q < q0; ++q)
        step<KW>(d, tl, __ldg(s.base + q), m, true);
#pragma unroll 1
      for (long long q = q0; q < q1; q += 32) {
        uint4 na = a, nb = b;
        if (q + 32 < q1) {
          na = load16(s.base + q + 32);
          nb = load16(s.base + q + 48);
        }
        fast16<KW, kCheck>(d, cnt, a, q - s.head, tl, m, s);
        fast16<KW, kCheck>(d, cnt, b, q + 16 - s.head, tl, m, s);
        a = na;
        b = nb;
      }
    } else {
      const long long s0 = q0 > s.head ? q0 - s.head : 0;
      const long long s1 = q1 - s.head < s.E ? q1 - s.head : s.E;
      const long long lo = s0 > s.lp - 1 ? s0 - (s.lp - 1) : 0;
      // Warm-up: [lo, s0), which ends at q0 (s0 > 0 only where q0 > head).
      for (long long q = (lo + s.head) & ~15LL; q < q0; q += 16)
        edge16<KW, false>(d, cnt, load16(s.base + q), q - s.head, lo, s0,
                          s0, tl, m, s);
      for (long long q = (s0 + s.head) & ~15LL; q < s1 + s.head; q += 16)
        edge16<KW, true>(d, cnt, load16(s.base + q), q - s.head, s0, s0, s1,
                         tl, m, s);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(~0u, cnt, o);
  if (lane == 0 && cnt) atomicAdd(out, cnt);
}

// Resident blocks on the whole card for an instance, once a device.
template <int KW, int kCheck>
int grid_cap(size_t smem) {
  static int cap[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < kMaxDevices && cap[dev] > 0) return cap[dev];
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(literal_count_kernel<KW, kCheck>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return -(int)err;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, literal_count_kernel<KW, kCheck>, kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  if (dev < kMaxDevices) cap[dev] = per_sm * sms;
  return per_sm * sms;
}

template <int KW, int kCheck>
int launch(const uint32_t* table, const Masks& m, const Scan& s,
           unsigned long long* out, cudaStream_t stream) {
  const size_t smem = (size_t)256 * KW * 32 * sizeof(uint32_t);
  const int cap = grid_cap<KW, kCheck>(smem);
  if (cap < 0) return -cap;
  const long long want = (s.nseg + kThreads - 1) / kThreads;
  const int blocks = (int)(want < cap ? want : cap);
  literal_count_kernel<KW, kCheck><<<blocks, kThreads, smem, stream>>>(
      table, m, s, out);
  return (int)cudaGetLastError();
}

template <int KW>
int launch_check(int check, const uint32_t* table, const Masks& m,
                 const Scan& s, unsigned long long* out,
                 cudaStream_t stream) {
  switch (check) {
    case 1: return launch<KW, 1>(table, m, s, out, stream);
    case 2: return launch<KW, 2>(table, m, s, out, stream);
    case 4: return launch<KW, 4>(table, m, s, out, stream);
    case 8: return launch<KW, 8>(table, m, s, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Adds the count of one literal group to *out (zeroed first when `zero`).
// text: the device text (any alignment); positions [0, P) may start a
// match and [0, end) end one (end = min(n, P + lp - 1), computed by the
// caller; nothing is launched where end <= 0). table: device, 256 x kw
// words; masks: host, S, F then C, kw words each; check: bytes between
// counts, 1, 2, 4 or 8 (1 where tail_len > 0); tail: device, 8 words a
// position past lp (tail_len of them) or null. Returns cudaGetLastError()
// after the launch (0 = launched or nothing to launch).
int literal_count(const uint8_t* text, long long n, long long P,
                  long long end, const uint32_t* table,
                  const uint32_t* masks, int kw, int check, int lp,
                  const uint32_t* tail, int tail_len, int seg,
                  unsigned long long* out, int zero, cudaStream_t stream) {
  if (zero) {
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(*out), stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (end <= 0) return 0;
  if (lp < 1 || seg < 32 || seg % 32 || tail_len < 0 ||
      (tail_len > 0 && (tail == nullptr || check != 1)))
    return (int)cudaErrorInvalidValue;
  Masks m = {};
  for (int w = 0; w < kw && w < kMaxWords; ++w) {
    m.start[w] = masks[w];
    m.accept[w] = masks[kw + w];
    m.check[w] = masks[2 * kw + w];
  }
  Scan s;
  s.head = (long long)((uintptr_t)text & 31u);
  s.base = text - s.head;
  s.P = P;
  s.E = end;
  s.n = n;
  s.nseg = (end + s.head + seg - 1) / seg;
  s.tail = tail;
  s.tail_len = tail_len;
  s.lp = lp;
  s.seg = seg;
  switch (kw) {
    case 1: return launch_check<1>(check, table, m, s, out, stream);
    case 2: return launch_check<2>(check, table, m, s, out, stream);
    case 4: return launch_check<4>(check, table, m, s, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* literal_count_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
