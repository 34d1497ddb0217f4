// DFA L-array byte-stepping phases for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of rejit_tpu/kernels/dfa_pallas.py:
//   dfa_phase1  <- phase1_pallas (_p1_kernel): per-block (f, m, i) summaries
//   dfa_phase3  <- phase3_pallas (_p3_kernel): per-boundary (L, I) emission
// Same algebra and outputs; the inputs are the padded uint8 text and the
// tables (the TPU kernels took int32 class and start-state views, built by
// torch passes that read and wrote 4 B per byte several times).
// rejit_tpu_torch/kernels/dfa_cuda.py holds the wrappers and the plain
// PyTorch versions the kernels are held against.
//
// The packed table entry is next*256 + (accept_pid + 1), Q*C int32 words.
// A step from state S on class c reads val = tab[S*C + c]; the step accepts
// pattern (val & 255) - 1 when that is >= 0 and moves to val >> 8. Steps at
// positions >= n change nothing, so a thread stops at the first of them.
// It also stops at the dead state (`dead`, -1 when the tables have none):
// the dead state is absorbing and never accepts, so in phase 1 f is dead
// and m, i are final there, and in phase 3 the splice is skipped (the
// suffix summary holds m = -1 at the dead state). Without a dead state a
// thread runs to its block end, as the TPU kernels' do.
//
// What bounds the work. Both functions read the text once (1 B a byte) and
// write their outputs once: phase 1 3*Q*4/K B a byte, phase 3 8 B a byte
// plus the suffix entries its splices read. Their operations are the live
// steps the text needs: on word text a few per (block, state) and fewer
// than one per boundary, far below the Q steps a byte (phase 1) or (K+1)/2
// (phase 3) of running every thread to its block end. So both are bounded
// by bytes, phase 1 at large Q by writing its summaries.
//
// The design. The items (one per (text block, start state) in phase 1, one
// per boundary in phase 3) take 0 to K steps each, most of them 0 to 3 on
// word text. So a warp runs its items as a queue: a lane whose item is done
// (dead state, block end or n) hands it over and takes the next one in
// order (__ballot_sync / __popc), and the warp's time follows the sum of
// its items' live steps, not its longest lane. With items this short, the
// bookkeeping around the queue costs as much as the steps, and each kernel
// is laid out to keep it small:
// - Phase 1 works in tiles of TB text blocks (about kP1Items items) a CUDA
//   block. The tile's text is loaded into registers, 16 bytes a thread,
//   while the tile before it runs; classified into shared memory; cut into
//   one contiguous range of items a warp; and the items' outputs are kept
//   in shared memory (f and the pattern id packed as f << 8 | (pid + 1)) and
//   written in order, so the (nb, Q) summaries leave in whole lines.
// - Phase 3 works in tiles of 512 bytes a warp, with no barrier between
//   warps. Each lane loads 16 bytes (prefetched during the last tile),
//   classifies them, takes their boundaries' start states from the bytes
//   before them, and lists the boundaries that have a step to take; a warp
//   scan orders the lists, so the queue holds only live boundaries (for a
//   pattern that starts with \b, most boundaries of word text start at the
//   dead state and are final at once). The splices read the suffix
//   summary in device memory; a lane does not wait for them inside the
//   queue: after it, the warp splices its tile in order and writes (L, I)
//   as 16-byte stores.
// - The table sits in shared memory up to the 227 KB a block may opt into,
//   less what the tiles need (phase 1's tile shrinks to make room, down to
//   a quarter, and to let two blocks share an SM); larger tables are read
//   through the read-only cache (a template flag). A grid of persistent
//   blocks (as many as fit on the card) walks the tiles, so the table is
//   copied into shared memory once a block.
//
// Neither kernel carries anything across tiles, so tile order does not
// matter (the TPU grid's sequential order is not needed here).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                  // 8 warps a CUDA block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kP1Steps = 2;                    // steps between queue checks
constexpr int kP3Steps = 4;
constexpr int kP1Items = 4096;                 // (block, state) items a tile
constexpr int kP1Vecs = 4;                     // 16-byte text vectors a
constexpr int kP1TextMax = kP1Vecs * 16 * kThreads;  // thread stages: 16 KB
constexpr int kChunk = 16;                     // bytes a lane loads at once
constexpr int kP3Span = 32 * kChunk;           // a phase-3 tile: 512 bytes
constexpr int kMinBlocks = 4;                  // resident blocks an SM
constexpr size_t kSmemLimit = 232448;          // 227 KB per block on sm_90
constexpr size_t kSmemSM = 233472;             // 228 KB per SM
constexpr size_t kSmemReserved = 1024;         // per block, for the system
constexpr size_t kSmemDefault = 48 * 1024;     // above: opt-in attribute

__host__ __device__ inline size_t round16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared memory of a phase-1 tile of TB text blocks, the table excluded.
__host__ __device__ inline size_t p1_stage_bytes(int TB, int K, int Q) {
  const size_t items = (size_t)TB * Q;
  return 256                                   // byte -> class
         + round16((size_t)TB * K)             // classes
         + 2 * round16(items * 4);             // f|pid, m of each item
}

// Text blocks of a phase-3 tile, and one warp's shared memory for it.
__host__ __device__ inline int p3_blocks(int K) {
  return kP3Span / K > 0 ? kP3Span / K : 1;
}

__host__ __device__ inline size_t p3_warp_bytes(int K) {
  const size_t items = (size_t)p3_blocks(K) * K;
  return 2 * round16(items * 4)                // start then end state|pid; m
         + round16(items)                      // classes
         + round16(items * 2)                  // the queue
         + round16((size_t)p3_blocks(K) * 4);  // block bases
}

// q = x / d, r = x % d for 0 <= x < 2^24 without an integer division: the
// float quotient is off by at most one, which the two corrections fix.
__device__ __forceinline__ void divmod(int x, int d, float inv, int& q,
                                       int& r) {
  q = __float2int_rz(__int2float_rn(x) * inv);
  r = x - q * d;
  if (r < 0) { --q; r += d; }
  if (r >= d) { ++q; r -= d; }
}

template <bool kSmemTab>
__device__ __forceinline__ int table_at(const int* s_tab,
                                        const int* __restrict__ g_tab,
                                        int idx) {
  if (kSmemTab) return s_tab[idx];
  return __ldg(g_tab + idx);
}

// A lane's item `id`: it steps classes s_cls[j .. jend-1] from state S; a
// step at class index j accepts at position off + j.
struct Item {
  int id, S, j, jend, off;
};

// Run the calling warp's queue of `count` items (see the note at the
// head), kSteps steps between checks: load(q) gives its item q,
// finish(item, m, pid) takes an item at its end state with its last accept
// position and pattern id.
template <bool kSmemTab, int kSteps, class Load, class Finish>
__device__ __forceinline__ void run_queue(int count, const uint8_t* s_cls,
                                          const int* s_tab,
                                          const int* __restrict__ tab, int C,
                                          int dead, Load load, Finish finish) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  int q = lane;
  int head = 32;
  bool has = q < count;
  Item x = {0, 0, 0, 0, 0};
  int m = -1, pid = -1;
  if (has) x = load(q);
  while (__any_sync(kFull, has)) {
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (has && x.S != dead && x.j < x.jend) {
        const int val =
            table_at<kSmemTab>(s_tab, tab, x.S * C + s_cls[x.j]);
        const int acc = (val & 255) - 1;
        if (acc >= 0) {
          m = x.off + x.j;
          pid = acc;
        }
        x.S = val >> 8;
        ++x.j;
      }
    }
    const bool done = has && (x.S == dead || x.j >= x.jend);
    const unsigned fin = __ballot_sync(kFull, done);
    if (fin) {
      const int next = head + __popc(fin & lower);
      head += __popc(fin);
      if (done) {
        finish(x, m, pid);
        q = next;
        has = q < count;
        m = -1;
        pid = -1;
        if (has) x = load(q);
      }
    }
  }
}

// The text of one tile in registers, loaded while the tile before it is
// processed: V 16-byte vectors a thread, when the tile is one 16-byte
// aligned run inside the text (else `ok` is false and stage_tile reads the
// tile byte by byte).
template <int V>
struct TileText {
  uint4 v[V];
  bool ok;
};

template <int V>
__device__ __forceinline__ void prefetch_tile(TileText<V>& tt,
                                              const uint8_t* __restrict__ text,
                                              long long p0, int len,
                                              long long T) {
  tt.ok = ((reinterpret_cast<uintptr_t>(text + p0) | (uintptr_t)len) & 15) ==
              0 &&
          p0 + len <= T && len <= V * 16 * kThreads;
  if (!tt.ok) return;
  const uint4* src = reinterpret_cast<const uint4*>(text + p0);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int w = threadIdx.x + i * kThreads;
    if (w * 16 < len) tt.v[i] = __ldg(src + w);
  }
}

__device__ __forceinline__ uint32_t classes4(uint32_t v,
                                             const uint8_t* s_map) {
  return (uint32_t)s_map[v & 255u] | (uint32_t)s_map[(v >> 8) & 255u] << 8 |
         (uint32_t)s_map[(v >> 16) & 255u] << 16 |
         (uint32_t)s_map[v >> 24] << 24;
}

// Stage the tile text[p0 .. p0+len) (bytes at or past T read as 0) as
// classes cls[0 .. len) (16-byte aligned).
template <int V>
__device__ __forceinline__ void stage_tile(const TileText<V>& tt,
                                           const uint8_t* __restrict__ text,
                                           long long p0, int len, long long T,
                                           const uint8_t* s_map,
                                           uint8_t* cls) {
  if (tt.ok) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int w = threadIdx.x + i * kThreads;
      if (w * 16 < len) {
        const uint32_t words[4] = {tt.v[i].x, tt.v[i].y, tt.v[i].z,
                                   tt.v[i].w};
        reinterpret_cast<uint4*>(cls)[w] =
            make_uint4(classes4(words[0], s_map), classes4(words[1], s_map),
                       classes4(words[2], s_map), classes4(words[3], s_map));
      }
    }
  } else {
    for (int x = threadIdx.x; x < len; x += kThreads) {
      const long long p = p0 + x;
      const int byte = p < T ? text[p] : 0;
      cls[x] = s_map[byte];
    }
  }
}

// A lane's chunks of the next tile, loaded while the warp works on the
// current one: V 16-byte chunks, each when it is aligned and inside the
// text (`ok` bit i), else chunk_words reads its bytes one by one. Chunk i
// of the lane covers bytes p0 + 16*(lane + 32*i) .. +15 of a run of len
// bytes.
template <int V>
struct Prefetch {
  uint4 v[V];
  unsigned ok;
  int prev;  // the byte before the lane's first chunk, or -1 at byte 0
};

template <int V>
__device__ __forceinline__ void prefetch_chunks(
    Prefetch<V>& pf, const uint8_t* __restrict__ text, long long p0, int len,
    long long T) {
  const int lane = threadIdx.x & 31;
  pf.ok = 0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int x0 = kChunk * (lane + 32 * i);
    const long long p = p0 + x0;
    if (x0 + kChunk <= len && p + kChunk <= T &&
        (reinterpret_cast<uintptr_t>(text + p) & 15) == 0) {
      pf.v[i] = __ldg(reinterpret_cast<const uint4*>(text + p));
      pf.ok |= 1u << i;
    }
  }
  const long long p = p0 + kChunk * lane - 1;
  pf.prev = p < 0 ? -1 : (p < T ? (int)__ldg(text + p) : 0);
}

// The 16 bytes at p (chunk i of the lane) as 4 little-endian words, from
// the prefetch or from the text (0 at or past T); and the byte before
// them (-1 at byte 0).
template <int V>
__device__ __forceinline__ void chunk_words(const Prefetch<V>& pf, int i,
                                            const uint8_t* __restrict__ text,
                                            long long p, long long T,
                                            uint32_t (&w)[4], int& prev) {
  if (i < V && (pf.ok >> i & 1)) {
    w[0] = pf.v[i].x;
    w[1] = pf.v[i].y;
    w[2] = pf.v[i].z;
    w[3] = pf.v[i].w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long pe = p + 4 * q + e;
        w[q] |= (uint32_t)(pe < T ? text[pe] : 0) << (8 * e);
      }
    }
  }
  prev = i == 0 ? pf.prev : (p - 1 < T ? text[p - 1] : 0);
}


// Copy the table (when kSmemTab) and the 256-entry byte maps into shared
// memory, once per CUDA block.
template <bool kSmemTab>
__device__ __forceinline__ void stage_tables(const int* __restrict__ tab,
                                             int QC, int* s_tab,
                                             const int* __restrict__ class_of,
                                             uint8_t* s_map,
                                             const int* __restrict__ sob,
                                             int* s_sob) {
  if (kSmemTab) {
    for (int x = threadIdx.x; x < QC; x += kThreads) s_tab[x] = __ldg(tab + x);
  }
  for (int x = threadIdx.x; x < 256; x += kThreads) {
    s_map[x] = (uint8_t)__ldg(class_of + x);
    if (s_sob) s_sob[x] = __ldg(sob + x);
  }
  __syncthreads();
}

// Phase 1: one item per (text block b, start state q), in the order b*Q + q
// (the order of the outputs f, m, i, each (nb, Q)). Tile t holds text
// blocks t*TB ...; its outputs are staged in shared memory (f and the
// pattern id packed as f << 8 | (pid + 1)) and written in order.
template <bool kSmemTab>
__global__ void __launch_bounds__(kThreads) dfa_phase1_kernel(
    const uint8_t* __restrict__ text, const int* __restrict__ class_of,
    const int* __restrict__ tab, int* __restrict__ f_out,
    int* __restrict__ m_out, int* __restrict__ i_out, int Q, int C, int K,
    int nb, int n, int dead, int TB) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tab_bytes = kSmemTab ? round16((size_t)Q * C * 4) : 0;
  int* s_tab = reinterpret_cast<int*>(smem);
  uint8_t* s_map = smem + tab_bytes;
  uint8_t* s_cls = s_map + 256;
  int* s_fp = reinterpret_cast<int*>(s_cls + round16((size_t)TB * K));
  int* s_m = s_fp + round16((size_t)TB * Q * 4) / 4;
  const int warp = threadIdx.x >> 5;
  const float invQ = 1.0f / (float)Q;
  const long long T = (long long)nb * K;
  const int ntiles = (nb + TB - 1) / TB;
  auto tile_len = [&](int t) { return min(TB, nb - t * TB) * K; };

  stage_tables<kSmemTab>(tab, Q * C, s_tab, class_of, s_map, nullptr,
                         nullptr);
  TileText<kP1Vecs> tt;
  int t = blockIdx.x;
  prefetch_tile(tt, text, (long long)t * TB * K, tile_len(t), T);
  for (; t < ntiles; t += gridDim.x) {
    const int b0 = t * TB;
    const int nbk = min(TB, nb - b0);
    __syncthreads();  // the last tile is written
    stage_tile(tt, text, (long long)b0 * K, nbk * K, T, s_map, s_cls);
    __syncthreads();
    const int tn = t + gridDim.x;
    if (tn < ntiles) {
      prefetch_tile(tt, text, (long long)tn * TB * K, tile_len(tn), T);
    }

    const int items = nbk * Q;
    const int per = (items + kWarps - 1) / kWarps;
    const int lo = min(items, warp * per);
    const int hi = min(items, lo + per);
    const int off = b0 * K;
    auto load = [&](int q) {
      const int it = lo + q;
      int bl, s;
      divmod(it, Q, invQ, bl, s);
      const int j = bl * K;
      return Item{it, s, j, j + min(K, n - (off + j)), off};
    };
    auto finish = [&](const Item& x, int m, int pid) {
      s_fp[x.id] = (x.S << 8) | (pid + 1);
      s_m[x.id] = m;
    };
    run_queue<kSmemTab, kP1Steps>(hi - lo, s_cls, s_tab, tab, C, dead, load,
                                  finish);
    __syncthreads();

    const long long out0 = (long long)b0 * Q;
    for (int x = threadIdx.x; x < items; x += kThreads) {
      const int v = s_fp[x];
      f_out[out0 + x] = v >> 8;
      m_out[out0 + x] = s_m[x];
      i_out[out0 + x] = (v & 255) - 1;
    }
  }
}

// Phase 3: one item per boundary (text block b, offset k), numbered b*K + k
// (the order of L and I). Block b starts at byte posbase[b] (or b*K when
// posbase is null); boundary s starts in the start state after byte s-1
// (s = 0: `first_start`, the caller's start state for byte 0: the begin
// state start_by_ctx[0] for a whole text, the state after the byte before
// it for a stream chunk or window). A warp's tile is p3_blocks(K)
// text blocks. Staging it, each lane reads 16 bytes, classifies them, takes
// their boundaries' start states, and lists the boundaries with a step to
// take (not at the dead state, below n) for the queue, in order (a warp
// scan); the others are final at once. After the queue, boundaries whose
// end state is not dead take the block's exclusive suffix summary at that
// state, m_suf[b, S] / i_suf[b, S], when it holds a later match, and the
// tile's (L, I) are written in order, 16 bytes a store.
template <bool kSmemTab>
__global__ void __launch_bounds__(kThreads, kMinBlocks) dfa_phase3_kernel(
    const uint8_t* __restrict__ text, long long T,
    const int* __restrict__ class_of, const int* __restrict__ start_of_byte,
    int first_start, const int* __restrict__ tab,
    const int* __restrict__ m_suf, const int* __restrict__ i_suf,
    const int* __restrict__ posbase, int* __restrict__ L_out,
    int* __restrict__ I_out, int Q, int C, int K, int nb, int n, int dead) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  const size_t tab_bytes = kSmemTab ? round16((size_t)Q * C * 4) : 0;
  const int TB = p3_blocks(K);
  const int most = TB * K;
  int* s_tab = reinterpret_cast<int*>(smem);
  int* s_sob = reinterpret_cast<int*>(smem + tab_bytes);
  uint8_t* s_map = reinterpret_cast<uint8_t*>(s_sob + 256);
  unsigned char* mine = s_map + 256 + warp * p3_warp_bytes(K);
  // s_st[x]: boundary x's start state while it waits in the queue, else its
  // end state << 8 | (pid + 1); s_m[x]: its last accept (read only when the
  // pid is not -1).
  int* s_st = reinterpret_cast<int*>(mine);
  int* s_m = s_st + round16((size_t)most * 4) / 4;
  uint8_t* s_cls =
      reinterpret_cast<uint8_t*>(s_m + round16((size_t)most * 4) / 4);
  uint16_t* s_list = reinterpret_cast<uint16_t*>(s_cls + round16(most));
  int* s_base = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(s_list) + round16((size_t)most * 2));
  const float invK = 1.0f / (float)K;
  const int begin = first_start;
  const bool contiguous = posbase == nullptr;
  const long long ntiles = (nb + TB - 1) / TB;
  const long long step = (long long)gridDim.x * kWarps;

  stage_tables<kSmemTab>(tab, Q * C, s_tab, class_of, s_map, start_of_byte,
                         s_sob);
  Prefetch<1> pf;
  pf.ok = 0;
  long long w = (long long)blockIdx.x * kWarps + warp;
  if (contiguous && w < ntiles) {
    prefetch_chunks(pf, text, w * most,
                    (int)min((long long)most, T - w * most), T);
  }
  for (; w < ntiles; w += step) {
    const int b0 = (int)(w * TB);
    const int nbk = min(TB, nb - b0);
    const int items = nbk * K;
    const long long out0 = (long long)b0 * K;
    if (!contiguous) {
      for (int x = lane; x < nbk; x += 32) s_base[x] = __ldg(posbase + b0 + x);
      __syncwarp();
    }
    // Stage: classes, start states and the queue. Chunk i of the lane,
    // i = 0 from the prefetch (a constant index, so it stays in
    // registers), later ones (K > 512) from the text.
    int count = 0;
    auto stage = [&](int i, int c) {
      const int x0 = kChunk * c;
      unsigned live = 0;
      if (x0 < items && contiguous) {
        const long long p = out0 + x0;
        uint32_t wd[4];
        int prev;
        chunk_words(pf, i, text, p, T, wd, prev);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int st[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * q + e;
            const int S = prev < 0 ? begin : s_sob[prev];
            const bool go = S != dead && p + j < n && x0 + j < items;
            st[e] = go ? S : S << 8;
            live |= (unsigned)go << j;
            prev = (wd[q] >> (8 * e)) & 255;
          }
          const uint32_t cl = classes4(wd[q], s_map);
          const int x = x0 + 4 * q;
          if (x + 4 <= items) {
            reinterpret_cast<uint32_t*>(s_cls)[x / 4] = cl;
            *reinterpret_cast<int4*>(s_st + x) =
                make_int4(st[0], st[1], st[2], st[3]);
          } else {
            for (int e = 0; x + e < items; ++e) {
              s_cls[x + e] = cl >> (8 * e);
              s_st[x + e] = st[e];
            }
          }
        }
      } else if (x0 < items) {
        for (int j = 0; j < kChunk && x0 + j < items; ++j) {
          int bl, k;
          divmod(x0 + j, K, invK, bl, k);
          const long long p = (long long)s_base[bl] + k;
          const int byte = p < T ? text[p] : 0;
          const int S = p == 0 ? begin : s_sob[p - 1 < T ? text[p - 1] : 0];
          const bool go = S != dead && p < n;
          s_cls[x0 + j] = s_map[byte];
          s_st[x0 + j] = go ? S : S << 8;
          live |= (unsigned)go << j;
        }
      }
      // This lane's live boundaries go to the queue after those of the
      // lanes before it.
      const int own = __popc(live);
      int incl = own;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      int at = count + incl - own;
      for (unsigned rest = live; rest; rest &= rest - 1) {
        s_list[at++] = (uint16_t)(x0 + __ffs(rest) - 1);
      }
      count += __shfl_sync(kFull, incl, 31);
    };
    stage(0, lane);
    for (int c = lane + 32; kChunk * (c - lane) < items; c += 32) stage(1, c);
    __syncwarp();
    if (contiguous && w + step < ntiles) {
      const long long p1 = (w + step) * most;
      prefetch_chunks(pf, text, p1, (int)min((long long)most, T - p1), T);
    }

    auto load = [&](int q) {
      const int it = s_list[q];
      int bl, k;
      divmod(it, K, invK, bl, k);
      const int base = contiguous ? (int)(out0 + bl * K) : s_base[bl];
      const int j0 = bl * K;
      return Item{it, s_st[it], it, j0 + min(K, n - base), base - j0};
    };
    auto finish = [&](const Item& x, int m, int pid) {
      s_st[x.id] = (x.S << 8) | (pid + 1);
      s_m[x.id] = m;
    };
    run_queue<kSmemTab, kP3Steps>(count, s_cls, s_tab, tab, C, dead, load,
                                  finish);
    __syncwarp();

    // Splice and write: a lane takes 4 boundaries at a time (their suffix
    // loads issued together), with 16-byte stores when the tile's outputs
    // are 16-byte aligned.
    const bool vec = (items & 3) == 0 && (out0 & 3) == 0;
    for (int x0 = 4 * lane; x0 < items; x0 += 4 * 32) {
      int v[4], mt[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = x0 + e;
        v[e] = x < items ? s_st[x] : 0;
        mt[e] = -1;
        const int S = v[e] >> 8;
        if (x < items && S != dead) {
          int bl, k;
          divmod(x, K, invK, bl, k);
          mt[e] = __ldg(m_suf + (long long)(b0 + bl) * Q + S);
        }
      }
      int L[4], I[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = x0 + e;
        const int pid1 = v[e] & 255;
        L[e] = pid1 && x < items ? s_m[x] : -1;
        I[e] = pid1 - 1;
        if (mt[e] >= 0) {
          int bl, k;
          divmod(x, K, invK, bl, k);
          L[e] = mt[e];
          I[e] = __ldg(i_suf + (long long)(b0 + bl) * Q + (v[e] >> 8));
        }
      }
      if (vec) {
        *reinterpret_cast<int4*>(L_out + out0 + x0) =
            make_int4(L[0], L[1], L[2], L[3]);
        *reinterpret_cast<int4*>(I_out + out0 + x0) =
            make_int4(I[0], I[1], I[2], I[3]);
      } else {
        for (int e = 0; e < 4 && x0 + e < items; ++e) {
          L_out[out0 + x0 + e] = L[e];
          I_out[out0 + x0 + e] = I[e];
        }
      }
    }
    __syncwarp();
  }
}

// A launch's shared memory: the table (when kept there), the byte maps and
// the tiles. Phase 1's tiles are TB text blocks, at most `want`, beside the
// table in shared memory when a tile of at least want/4 blocks fits there
// (and a smaller tile, down to want/4, when that lets two blocks share an
// SM), else with the table read through the read-only cache; TB = 0 when no
// tile fits (a very large block size K). Phase 3's are one a warp.
struct Plan {
  int TB;
  bool smem_tab;
  size_t smem;
};

template <class StageBytes>
Plan plan_tile(int want, size_t tab_bytes, StageBytes stage) {
  const int least = want / 4 > 0 ? want / 4 : 1;
  const size_t tab = round16(tab_bytes);
  const bool smem_tab = tab + stage(least) <= kSmemLimit;
  const size_t fixed = smem_tab ? tab : 0;
  auto largest = [&](size_t cap) {  // the largest TB whose tile fits in cap
    int lo = 0, hi = want;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (fixed + stage(mid) <= cap) lo = mid; else hi = mid - 1;
    }
    return lo;
  };
  int tb = largest(kSmemLimit);
  const size_t half = kSmemSM / 2 - kSmemReserved;
  if (tb && fixed + stage(tb) > half && largest(half) >= least) {
    tb = largest(half);
  }
  return {tb, smem_tab, tb ? fixed + stage(tb) : 0};
}

Plan p1_plan(int Q, int C, int K) {
  int want = (kP1Items + Q - 1) / Q;
  const int cap = kP1TextMax / K > 0 ? kP1TextMax / K : 1;
  if (want > cap) want = cap;
  return plan_tile(want, (size_t)Q * C * 4,
                   [K, Q](int tb) { return p1_stage_bytes(tb, K, Q); });
}

Plan p3_plan(int Q, int C, int K) {
  const size_t rest = 256 * 4 + 256 + kWarps * p3_warp_bytes(K);
  const size_t tab = round16((size_t)Q * C * 4);
  if (tab + rest <= kSmemLimit) return {p3_blocks(K), true, tab + rest};
  return {p3_blocks(K), false, rest};
}

// Opt the kernel into `bytes` of dynamic shared memory and size its grid:
// as many persistent blocks as fit on the card, at most `blocks`.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes, long long blocks,
                    int* grid) {
  cudaError_t err = cudaSuccess;
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  if (bytes > kSmemDefault) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const long long most = (long long)per_sm * sms;
  *grid = (int)(blocks < most ? blocks : most);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// 1 when both kernels keep a Q-state, C-class table in shared memory at
// block size K, 0 when they read it through the read-only cache.
int dfa_table_in_smem(int Q, int C, int K) {
  return p1_plan(Q, C, K).smem_tab && p3_plan(Q, C, K).smem_tab;
}

// Each launcher returns cudaGetLastError() after the launch (0 = launched),
// or cudaErrorInvalidValue when a tile would need more shared memory than a
// CUDA block may have (a very large block size K), for
// K > 65535 (phase 3's queue holds 16-bit boundary indices) or Q >= 2^23
// (a state is kept above an 8-bit pattern id).
// `dead` is the tables' absorbing, never-accepting state, or -1.
int dfa_phase1(const uint8_t* text, const int* class_of, const int* tab,
               int* f, int* m, int* i, int Q, int C, int K, int nb, int n,
               int dead, void* stream) {
  if (Q <= 0 || Q >= (1 << 23) || C <= 0 || K <= 0 || nb <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan pl = p1_plan(Q, C, K);
  if (pl.TB == 0) return (int)cudaErrorInvalidValue;
  const long long ntiles = (nb + pl.TB - 1) / pl.TB;
  cudaStream_t s = (cudaStream_t)stream;
  int grid = 0;
  cudaError_t err;
  if (pl.smem_tab) {
    err = prepare(dfa_phase1_kernel<true>, pl.smem, ntiles, &grid);
    if (err != cudaSuccess) return (int)err;
    dfa_phase1_kernel<true><<<grid, kThreads, pl.smem, s>>>(
        text, class_of, tab, f, m, i, Q, C, K, nb, n, dead, pl.TB);
  } else {
    err = prepare(dfa_phase1_kernel<false>, pl.smem, ntiles, &grid);
    if (err != cudaSuccess) return (int)err;
    dfa_phase1_kernel<false><<<grid, kThreads, pl.smem, s>>>(
        text, class_of, tab, f, m, i, Q, C, K, nb, n, dead, pl.TB);
  }
  return (int)cudaGetLastError();
}

// posbase may be null: block b then starts at byte b*K. T is the text's
// length; bytes at or past it read as 0. first_start is boundary 0's start
// state (0 <= first_start < Q).
int dfa_phase3(const uint8_t* text, long long T, const int* class_of,
               const int* start_of_byte, int first_start,
               const int* tab, const int* m_suf, const int* i_suf,
               const int* posbase, int* L, int* I, int Q, int C, int K,
               int nb, int n, int dead, void* stream) {
  if (Q <= 0 || Q >= (1 << 23) || C <= 0 || K <= 0 || K > 65535 || nb <= 0 ||
      first_start < 0 || first_start >= Q) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan pl = p3_plan(Q, C, K);
  const long long ntiles = (nb + pl.TB - 1) / pl.TB;
  cudaStream_t s = (cudaStream_t)stream;
  int grid = 0;
  cudaError_t err;
  if (pl.smem_tab) {
    err = prepare(dfa_phase3_kernel<true>, pl.smem,
                  (ntiles + kWarps - 1) / kWarps, &grid);
    if (err != cudaSuccess) return (int)err;
    dfa_phase3_kernel<true><<<grid, kThreads, pl.smem, s>>>(
        text, T, class_of, start_of_byte, first_start, tab, m_suf, i_suf,
        posbase, L, I, Q, C, K, nb, n, dead);
  } else {
    err = prepare(dfa_phase3_kernel<false>, pl.smem,
                  (ntiles + kWarps - 1) / kWarps, &grid);
    if (err != cudaSuccess) return (int)err;
    dfa_phase3_kernel<false><<<grid, kThreads, pl.smem, s>>>(
        text, T, class_of, start_of_byte, first_start, tab, m_suf, i_suf,
        posbase, L, I, Q, C, K, nb, n, dead);
  }
  return (int)cudaGetLastError();
}

const char* dfa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
