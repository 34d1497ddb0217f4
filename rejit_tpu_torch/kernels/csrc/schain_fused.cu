// The fused DFA match for Hopper (sm_90a): schain_fused.
//
// Replaces rejit_tpu/kernels/schain_pallas.py:call_fused (_kernel,
// _kernel_heavy): the whole DFA match of one padded uint8 text of P bytes in
// one call, reading the text bytes themselves (no class or start-state
// arrays in device memory). For every boundary s <= P it gives L[s], the
// longest match end from s (-1 for none and for s > n), and in the
// multi-pattern mode I[s], its pattern id; or, in the count mode, the number
// of boundaries with L >= 0. The caller's buffers hold all P + 1 boundaries,
// boundary P from the seed (the EOT accepts for a standalone text). It also
// gives G, the whole text's (f, m, i) state-map summary composed with the
// caller's seed. With emit_f (the L modes; TPU: call_fused(emit_f=True),
// which packed it above L) it writes F, one byte a boundary: the state in
// which the thread started at the boundary leaves the text, composed with
// the seed (with a neutral seed, the state at the end of the text; past n,
// the seed's f at the boundary's start state). Boundary 0 starts in the
// caller's start0, every other boundary in the start state after the byte
// before it. rejit_tpu_torch/kernels/schain_cuda.py holds the wrapper and
// the plain PyTorch version the kernel is held against.
//
// The algebra is the split pipeline's (dfa_phases.cu): a summary maps each
// start state q to (f = end state, m = last accepting position, i = its
// pattern id); summaries compose associatively, the later match winning.
// The packed table entry is next*256 + (accept_pid + 1); a step at a
// position >= n changes nothing. The dead state (when the tables have one)
// absorbs and never accepts: a thread that reaches it is final.
//
// The TPU kernel ran its grid right to left on one core and carried the
// suffix across grid steps in SMEM. CUDA blocks run concurrently and in no
// order, so the carry is explicit, in three launches: each CUDA block
// summarises its segment of the text; one block composes the segment
// summaries right to left (a doubling scan seeded with `seed`) into each
// segment's exclusive suffix, and G; each CUDA block then walks its
// segment right to left from that suffix and emits L (and I) or counts.
// Two instances of the two segment passes:
//
// The sweep instance (Q <= 32; sweep_summary_kernel, sweep_carry_kernel,
// sweep_emit_kernel). A group of W lanes (W the power of two >= Q) holds
// one state per lane; a CUDA block's segment is cut into one chunk of whole
// 128-byte tiles per group. The byte table T (256 x W: next | accept+1 << 8
// | skip flags << 16 | start state after the byte << 24, built by the
// wrapper) is staged in shared memory as 32 / W copies side by side, so
// the lanes of each group read their own banks. Pass 1 runs each state
// forward through the chunk (one table load per step) and stops once every
// state is in the dead state; a doubling scan over the groups gives each
// chunk's exclusive suffix inside the segment (kept for pass 3) and the
// segment's summary. The carry pass composes segments in registers, a
// warp per run of segments. Pass 3 composes the chunk's suffix with the
// segment's carry and sweeps the chunk right to left: at byte j lane q
// reads T[byte][q] (not on the chain, so it is loaded early), takes the later
// vector's m (and i) at the next state by __shfl_sync, and keeps it if it
// is a match, else this byte's accept. The first idle lane (q = Q) steps
// to the start state after the byte, so it reads boundary j+1's L in its
// own shuffle. That is W independent steps per byte. The groups of a warp
// step in lockstep (whole-warp shuffles of width W). Text is read 16 bytes
// at a time; L values are stored 16 at a time.
//
// The tile instance (Q <= 256; tile_summary_kernel, tile_carry_kernel,
// tile_emit_kernel; the wrapper takes it for Q > 32). A vector of W >= Q
// states a byte, as the sweep takes, costs Q/32 warp steps a byte: 40 to
// 256 states would cost more than the old per-boundary design at once. On
// text, though, a thread of a real pattern dies (reaches the dead state)
// within a few bytes of its start: this instance makes the work follow the
// live threads. Tiles of 4096 bytes (their text copied into shared memory
// by cp.async, 16 bytes a thread, while the tile before is walked; classes
// staged from it 16 bytes at a time):
// - The walk path. Each boundary takes its first step as it is staged;
//   those still live join a warp queue (as dfa_phases.cu's: a lane whose
//   walk is done takes the next), with the Q state walks from the tile's
//   first byte (the tile's map, which moves the carry). A walk runs to the
//   dead state or the tile end (or n) and there takes the carry, the
//   suffix right of the tile, at its end state: L, I and F come from one
//   shared-memory lookup each. Pass 1 walks its Q states left to right
//   through the segment and stops once they are all dead, which on text
//   is within the segment's first tile. The carry pass composes the
//   segment summaries in shared memory, a group of >= 64 threads holding
//   a state vector per run of segments.
// - The grid path keeps the old worst case: a tile whose queue runs past
//   kCapRounds rounds (256 steps a lane: some thread lives that long) is
//   done in ranges of NB pieces of kPiece = 32 bytes (the wrapper's
//   PIECE): each (piece, state) is run across its piece (stopping at the
//   dead state), a doubling scan in shared memory gives each piece's
//   exclusive suffix in the range, and each boundary runs to its piece
//   end and is spliced there: 16.5 steps a byte. The next
//   tiles then take the grid path at once, for a run that doubles (up to
//   64 tiles) while the walks keep failing; and a tile through which pass
//   1 saw one of its states live takes it at once (pass 1's `hint`), so
//   a text whose threads never die pays no failed try.
// Both passes are held to kTileBlocks blocks an SM by their registers
// (the queues are latency-bound: more warps a scheduler beat more
// registers, measured on the card); a grid range holds NB pieces with
// NB*Q <= 1024 (the wrapper's GRID_STATES), its maps in the space of the
// walk path's list.
// Tensor cores have no role here: a DFA step is a data-dependent table
// lookup, not a product of dense tiles (the matmul engine's one-hot
// products, engine/matmul.py, show what forcing it costs). The tile
// instance does not depend on the fused block K.
//
// The fast-forward tile skip (the TPU's chunk skip, schain_pallas.py
// _kernel), in both instances: a tile wholly below n whose first byte
// sends every state to the dead state and whose other bytes are silent has
// the summary (dead, first-byte accept position, its pid) and L = -1
// everywhere but at its edge boundary. The emit pass takes it with no
// automaton steps when the carry's m at the dead state is -1, which makes
// the shortcut exact for any seed; the summary passes stop at the
// all-dead state instead.
//
// Bounds on an H100: the function reads 1 byte of text per text byte and
// writes 4 (L) or 8 (L and I) or nothing (count); it needs Q automaton
// steps per byte (the backward composition over the Q states). At the
// Config-3 sizes (Q = 6) the L modes are bounded by bytes, the count mode
// by operations. The sweep instance takes W steps per byte in pass 3, each
// one shared-memory load and one shuffle (three in L+I mode), and pass 1's
// steps until every state is dead; the shared-memory and shuffle pipe
// bounds it. The tile instance's walk path takes the live steps (on text
// one to a few a boundary) plus one carry lookup a boundary and Q state
// walks a tile; its grid path 2*Q + 16.5 steps a byte. Device-memory
// traffic beyond the text and the outputs: the (nseg, 3, Q) segment
// summaries and, for the sweep, 3 KB of chunk suffixes per segment, for
// the tile instance a byte a tile (hint).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCarryThreads = 1024;     // threads of a carry block, at most
constexpr int kCarryGroups = 15;        // named barriers 1..15
constexpr int kCarryAhead = 4;          // segments loaded ahead
constexpr int kSilent = 1;              // flags: class is silent
constexpr int kUniform = 2;             // flags: class sends all to dead
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemLimit = 232448;   // 227 KB per block on sm_90
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSegments = 1024;     // CUDA blocks of a segment pass

enum Mode : int { kSummary = 0, kEmitL = 1, kEmitLI = 2, kCount = 3 };

// ---------------------------------------------------------------------------
// The tile instance (Q <= 256)
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 256;               // threads of a tile block
constexpr int kTileBlocks = 5;                  // blocks an SM (registers)
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTB = 4096;                       // bytes of a tile
constexpr int kLead = 16;                       // bytes staged before a tile
constexpr int kRaw = kLead + kTB;               // a raw text buffer
constexpr int kG = 32;                          // s_cls's block of bytes
constexpr int kGP = 36;                         // a block's stride in s_cls
constexpr int kPiece = 32;                      // bytes of a grid-path piece
constexpr int kLgPiece = 5;
constexpr int kWarpBytes = kTB / kTileWarps;    // 512: 16 bytes a lane
constexpr int kWalkSteps = 4;                   // steps between queue checks
constexpr int kCapRounds = 64;                  // a warp's queue rounds a tile
constexpr int kSummaryCapRounds = 16;           // the same in pass 1
constexpr int kStreakMax = 64;                  // longest grid run, a miss
constexpr int kStateItem = 0x10000;             // walk id bit: a state walk

__host__ __device__ inline size_t round16(size_t x) {
  return (x + 15) & ~size_t(15);
}

struct TileParams {
  const uint8_t* text;   // (P,) padded text, 16-byte aligned
  const int* tab;        // (Q*C,) next*256 + accept+1
  const int* class_of;   // (256,) byte -> class
  const int* start_of;   // (256,) start state of a boundary after byte b
  const int* flags;      // (256,) kSilent | kUniform per byte
  int* seg_sum;          // (nseg, 3, Q) segment summaries (pass 1 out)
  const int* seg_x;      // (nseg, 3, Q) segment exclusive suffixes (pass 3 in)
  int* L;                // (P+1,), 16-byte aligned
  int* I;                // (P+1,) in kEmitLI, 16-byte aligned
  uint8_t* F;            // (P+1,) end states (emit_f), or null; aligned
  int* counts;           // [0] count, [1] tiles skipped by pass 3
  uint8_t* hint;         // (ntiles,) pass 1: a state lives through the tile
  int Q, C, NB, P, n;    // NB pieces of kPiece bytes a grid range
  int start0;            // start state at boundary 0 (the begin context)
  int dead;              // absorbing, never-accepting state, or -1
  int skip;              // the FF tile skip is on (needs dead >= 0)
  int ntiles, tiles_per_seg;
};

// Shared memory of a tile block, in bytes from its start.
struct TileLayout {
  size_t tab, maps, vec, walk, raw, cls, res, list, grid, total;
};

__host__ __device__ inline TileLayout tile_layout(bool emit, int Q, int C,
                                                  int NB) {
  TileLayout l;
  size_t o = 0;
  l.tab = o;  o += round16((size_t)Q * C * 4);      // the table
  l.maps = o; o += 3 * 256;                          // class, start, flags
  l.vec = o;  o += round16((size_t)6 * Q * 4);      // carries / r, m, i
  l.walk = o; o += round16((size_t)Q * 4);          // state walks
  l.raw = o;  o += 2 * (size_t)kRaw;                 // two raw tiles
  l.cls = o;  o += (size_t)(kTB / kG) * kGP;         // classes
  l.res = o;  o += emit ? (size_t)kTB * 4 : 0;       // boundary walks
  // The walk path's live boundaries and the grid path's piece maps share
  // their space: a tile takes one path at a time.
  const size_t list = emit ? (size_t)kTB * 2 : 0;
  const size_t grid = (size_t)3 * NB * Q * 4;
  l.list = l.grid = o;
  o += list > grid ? list : grid;
  l.total = o;
  return l;
}

// Index of tile byte j in s_cls: blocks of kG bytes kGP apart, so that the
// lanes of a warp reading byte k of 32 blocks hit 32 banks.
__device__ __forceinline__ int cidx(int j) { return j + ((j >> 5) << 2); }

__device__ __forceinline__ uint32_t classes4(uint32_t v, const uint8_t* m) {
  return (uint32_t)m[v & 255u] | (uint32_t)m[(v >> 8) & 255u] << 8 |
         (uint32_t)m[(v >> 16) & 255u] << 16 | (uint32_t)m[v >> 24] << 24;
}

// One automaton step at tile byte j. A walk's result is packed: end state
// | (pid + 1) << 8 | (m + 1) << 16, m the last accept's position from the
// tile's first byte (-1: none, and then pid + 1 is 0), so the identity map
// at q is q; acc holds the upper bits.
__device__ __forceinline__ void walk_step(const uint8_t* s_cls,
                                          const int* s_tab, int C, int& S,
                                          int& j, uint32_t& acc) {
  const int v = s_tab[S * C + s_cls[cidx(j)]];
  const uint32_t a1 = (uint32_t)v & 255u;
  if (a1) acc = (a1 << 8) | ((uint32_t)(j + 1) << 16);
  S = v >> 8;
  ++j;
}

// a, then the map `row` (indexed by state): the later match wins.
__device__ __forceinline__ uint32_t compose(uint32_t a, const uint32_t* row) {
  const uint32_t e = row[a & 255u];
  return (e >> 16) ? e : ((a & ~255u) | (e & 255u));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying tile t's bytes, and the kLead bytes before it, into raw
// (zeros before the text and past P), 16 bytes a thread.
__device__ __forceinline__ void prefetch_tile(const TileParams& p,
                                              uint8_t* raw, int t) {
  const long long lo = (long long)t * kTB - kLead;
  for (int c = threadIdx.x; c < kRaw / 16; c += kTileThreads) {
    const long long pos = lo + 16LL * c;
    const long long left = (long long)p.P - pos;
    const int bytes =
        pos < 0 ? 0 : (int)(left < 0 ? 0 : left < 16 ? left : 16);
    cp_async16(raw + 16 * c, bytes ? p.text + pos : p.text, bytes);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Classes of this thread's 16 bytes (tile bytes 16*tid ..) into s_cls;
// returns the bytes as four words.
__device__ __forceinline__ uint4 stage_classes(const uint8_t* rb,
                                               const uint8_t* s_map,
                                               uint8_t* s_cls) {
  const int x0 = 16 * threadIdx.x;
  const uint4 v = *reinterpret_cast<const uint4*>(rb + x0);
  uint32_t* d = reinterpret_cast<uint32_t*>(s_cls + (x0 >> 5) * kGP +
                                            (x0 & 31));
  d[0] = classes4(v.x, s_map);
  d[1] = classes4(v.y, s_map);
  d[2] = classes4(v.z, s_map);
  d[3] = classes4(v.w, s_map);
  return v;
}

__device__ __forceinline__ int byte_at(const uint4& v, int e) {
  const uint32_t w = e < 4 ? v.x : e < 8 ? v.y : e < 12 ? v.z : v.w;
  return (w >> (8 * (e & 3))) & 255;
}

struct Walk {
  int id, S, j;
  uint32_t acc;
};

// The calling warp's queue of `count` walks, each from its state at tile
// byte j until the dead state or byte lim (dfa_phases.cu's run_queue: a
// lane whose walk is done takes the next one). load(k) gives walk k,
// finish(w) takes a finished walk. Returns false when the warp gives up:
// after `cap` rounds of kWalkSteps steps, or when another warp of the
// block has given up (*s_abort), the tile then takes the grid path.
template <class Load, class Finish>
__device__ __forceinline__ bool walk_queue(int count, int lim, int dead,
                                           const uint8_t* s_cls,
                                           const int* s_tab, int C, int cap,
                                           volatile int* s_abort, Load load,
                                           Finish finish) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  int q = lane, head = 32;
  bool has = q < count;
  Walk w = {0, 0, 0, 0u};
  if (has) w = load(q);
  for (int round = 0; __any_sync(kFull, has); ++round) {
    int stop = lane == 0 ? *s_abort : 0;
    stop = __shfl_sync(kFull, stop, 0);
    if (stop || round >= cap) {
      if (lane == 0) *s_abort = 1;
      return false;
    }
#pragma unroll
    for (int u = 0; u < kWalkSteps; ++u) {
      if (has && w.S != dead && w.j < lim)
        walk_step(s_cls, s_tab, C, w.S, w.j, w.acc);
    }
    const bool done = has && (w.S == dead || w.j >= lim);
    const unsigned fin = __ballot_sync(kFull, done);
    if (fin) {
      const int next = head + __popc(fin & lower);
      head += __popc(fin);
      if (done) {
        finish(w);
        q = next;
        has = q < count;
        if (has) w = load(q);
      }
    }
  }
  return true;
}

// The grid path of one range [x0, x1) of a tile: NB pieces of kPiece
// bytes.
struct Grid {
  int Q, C, dead, NB, lgNB;
  int ppr, hp, hq;       // pieces a round, this thread's piece and state
  bool on;               // this thread has a (piece, state) slot
  const uint8_t* s_cls;
  const int* s_tab;
  uint32_t *Sp, *A, *B;  // piece maps, and two buffers of the scan
};

// Sp[b*Q + q]: piece b of [x0, x1) run from state q (bytes at or past lim
// are the identity), stopping at the dead state.
__device__ __forceinline__ void grid_pieces(const Grid& g, int x0, int x1,
                                            int lim) {
  const int nbt = (x1 - x0 + kPiece - 1) >> kLgPiece;
  if (!g.on) return;
  for (int b = g.hp; b < nbt; b += g.ppr) {
    int S = g.hq, j = x0 + (b << kLgPiece);
    const int je = min(min(j + kPiece, x1), lim);
    uint32_t acc = 0;
    while (j < je && S != g.dead) walk_step(g.s_cls, g.s_tab, g.C, S, j, acc);
    g.Sp[b * g.Q + g.hq] = (uint32_t)S | acc;
  }
}

// Exclusive suffixes X_b = S_{b+1} o ... o S_{nbt-1} inside the range (a
// doubling scan, Hillis-Steele); returns the buffer holding them. Starts
// and ends with a barrier.
__device__ __forceinline__ const uint32_t* grid_suffixes(const Grid& g,
                                                         int nbt) {
  uint32_t* A = g.A;
  uint32_t* B = g.B;
  __syncthreads();                       // Sp is written
  if (g.on) {
    for (int b = g.hp; b < nbt; b += g.ppr)
      A[b * g.Q + g.hq] =
          b + 1 < nbt ? g.Sp[(b + 1) * g.Q + g.hq] : (uint32_t)g.hq;
  }
  __syncthreads();
  for (int d = 1; d < nbt; d *= 2) {
    if (g.on) {
      for (int b = g.hp; b < nbt; b += g.ppr) {
        uint32_t a = A[b * g.Q + g.hq];
        if (b + d < nbt) a = compose(a, A + (b + d) * g.Q);
        B[b * g.Q + g.hq] = a;
      }
    }
    __syncthreads();
    uint32_t* T = A;
    A = B;
    B = T;
  }
  return A;
}

// Grid-path boundaries of [x0, x1): each runs from its start state to its
// piece end (stopping at the dead state) and takes the piece's exclusive
// suffix X at its end state; the result (end state at x1) goes to s_res.
// Slot w is offset w >> lgNB of piece w & (NB-1), so a warp's lanes read
// the same offset of different pieces.
template <class StartAt>
__device__ __forceinline__ void grid_bounds(const Grid& g, int x0, int x1,
                                            int lim, const uint32_t* X,
                                            uint32_t* s_res,
                                            StartAt start_at) {
  const int nbt = (x1 - x0 + kPiece - 1) >> kLgPiece;
  for (int w = threadIdx.x; w < g.NB << kLgPiece; w += kTileThreads) {
    const int b = w & (g.NB - 1);
    const int x = x0 + (b << kLgPiece) + (w >> g.lgNB);
    if (b >= nbt || x >= x1) continue;
    int S = start_at(x), j = x;
    const int je = min(min(x0 + ((b + 1) << kLgPiece), x1), lim);
    uint32_t acc = 0;
    while (j < je && S != g.dead) walk_step(g.s_cls, g.s_tab, g.C, S, j, acc);
    s_res[x] = compose((uint32_t)S | acc, X + b * g.Q);
  }
}

__device__ __forceinline__ Grid make_grid(const TileParams& p,
                                          const uint8_t* s_cls,
                                          const int* s_tab, uint32_t* grid) {
  Grid g;
  g.Q = p.Q;
  g.C = p.C;
  g.dead = p.dead;
  g.NB = p.NB;
  g.lgNB = __ffs(p.NB) - 1;
  g.ppr = kTileThreads / p.Q;
  g.hp = threadIdx.x / p.Q;
  g.hq = threadIdx.x - g.hp * p.Q;
  g.on = g.hp < g.ppr;
  g.s_cls = s_cls;
  g.s_tab = s_tab;
  g.Sp = grid;
  g.A = grid + p.NB * p.Q;
  g.B = g.A + p.NB * p.Q;
  return g;
}

// Tables and byte maps into shared memory.
__device__ __forceinline__ void stage_tile_tables(const TileParams& p,
                                                  int* s_tab,
                                                  uint8_t* s_map) {
  for (int x = threadIdx.x; x < p.Q * p.C; x += kTileThreads)
    s_tab[x] = __ldg(p.tab + x);
  for (int x = threadIdx.x; x < 256; x += kTileThreads) {
    s_map[x] = (uint8_t)__ldg(p.class_of + x);
    s_map[256 + x] = (uint8_t)__ldg(p.start_of + x);
    s_map[512 + x] = (uint8_t)__ldg(p.flags + x);
  }
}

// Pass 1: the segment's summary from every state q. The segment's tiles
// are walked left to right with the state r[q] that q has reached (and
// its last accept): on the walk path a queue of Q walks through the tile;
// when a walk passes kSummaryCapRounds rounds, or some r[q] lived through
// the tile before, the grid path (piece maps and their scan, in ranges of
// NB pieces) gives the tile's map and r moves through it. The pass stops
// when every r[q] is dead (nothing after changes the summary) or at n.
// hint[t] records for pass 3 whether some r[q] lived through tile t (0
// for the tiles the pass does not reach): where one does, the text's
// threads live long there, and pass 3 takes the grid path at once.
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
tile_summary_kernel(TileParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_abort;
  const int Q = p.Q, C = p.C, n = p.n, dead = p.dead;
  const TileLayout lay = tile_layout(false, Q, C, p.NB);
  int* s_tab = reinterpret_cast<int*>(smem + lay.tab);
  uint8_t* s_map = smem + lay.maps;
  int* r = reinterpret_cast<int*>(smem + lay.vec);
  int* rm = r + Q;
  int* ri = rm + Q;
  uint32_t* s_walk = reinterpret_cast<uint32_t*>(smem + lay.walk);
  uint8_t* s_raw = smem + lay.raw;
  uint8_t* s_cls = smem + lay.cls;
  const Grid g = make_grid(p, s_cls, s_tab,
                           reinterpret_cast<uint32_t*>(smem + lay.grid));
  const int tid = threadIdx.x, warp = tid >> 5;
  const int t_lo = blockIdx.x * p.tiles_per_seg;
  const int t_hi = min(t_lo + p.tiles_per_seg, p.ntiles);
  const int HB = p.NB * kPiece;

  stage_tile_tables(p, s_tab, s_map);
  for (int q = tid; q < Q; q += kTileThreads) {
    r[q] = q;
    rm[q] = -1;
    ri[q] = -1;
  }
  if (t_lo < t_hi) prefetch_tile(p, s_raw, t_lo);
  int buf = 0, t = t_lo;
  bool lived = false;                     // an r[q] lived through tile t-1
  for (; t < t_hi; ++t) {
    const int base = t * kTB;
    if (base >= n) break;                 // the identity from here on
    const int len = min(kTB, p.P - base);
    const int lim = min(n - base, len);
    const uint8_t* rb = s_raw + buf * kRaw + kLead;
    cp_async_wait_all();
    __syncthreads();                      // tile t's bytes; tile t-1 done
    if (t + 1 < t_hi) prefetch_tile(p, s_raw + (buf ^ 1) * kRaw, t + 1);
    if (tid == 0) s_abort = 0;
    stage_classes(rb, s_map, s_cls);
    __syncthreads();

    bool walked = false;
    if (!lived) {
      const int mine = Q > warp ? (Q - warp + kTileWarps - 1) / kTileWarps : 0;
      auto load = [&](int k) {
        const int q = warp + kTileWarps * k;
        return Walk{q, r[q], 0, 0u};
      };
      auto finish = [&](const Walk& w) {
        s_walk[w.id] = (uint32_t)w.S | w.acc;
      };
      const bool ok = walk_queue(mine, lim, dead, s_cls, s_tab, C,
                                 kSummaryCapRounds, &s_abort, load, finish);
      walked = !__syncthreads_or(!ok);
    }
    if (walked) {
      for (int q = tid; q < Q; q += kTileThreads) {
        const uint32_t h = s_walk[q];
        r[q] = h & 255u;
        if (h >> 16) {
          rm[q] = base + (int)(h >> 16) - 1;
          ri[q] = (int)((h >> 8) & 255u) - 1;
        }
      }
    } else {
      // The grid path, range by range from the left.
      for (int x0 = 0; x0 < len; x0 += HB) {
        const int x1 = min(x0 + HB, len);
        grid_pieces(g, x0, x1, lim);
        const uint32_t* X =
            grid_suffixes(g, (x1 - x0 + kPiece - 1) / kPiece);
        for (int q = tid; q < Q; q += kTileThreads) {
          const uint32_t h = compose(g.Sp[r[q]], X);   // S_0 o X_0 at r[q]
          r[q] = h & 255u;
          if (h >> 16) {
            rm[q] = base + (int)(h >> 16) - 1;
            ri[q] = (int)((h >> 8) & 255u) - 1;
          }
        }
        __syncthreads();                  // Sp and X are read
      }
    }
    bool alive = false;
    for (int q = tid; q < Q; q += kTileThreads) alive |= r[q] != dead;
    buf ^= 1;
    const bool any = __syncthreads_or(alive);
    lived = any && lim == len;
    if (tid == 0) p.hint[t] = lived;
    if (!any) {                           // every state is dead
      ++t;
      break;
    }
  }
  for (int u = t + tid; u < t_hi; u += kTileThreads) p.hint[u] = 0;
  cp_async_wait_all();
  int* out = p.seg_sum + (size_t)blockIdx.x * 3 * Q;
  for (int q = tid; q < Q; q += kTileThreads) {
    out[q] = r[q];
    out[Q + q] = rm[q];
    out[2 * Q + q] = ri[q];
  }
}

// The carry moves left past a map h (packed, positions from `base`):
// (n*)[q] = h then c.
__device__ __forceinline__ void carry_through(uint32_t h, int base, int q,
                                              const int* c, int* nc, int Q) {
  const int S = h & 255u;
  nc[q] = c[S];
  const int m = c[Q + S];
  if (m >= 0) {
    nc[Q + q] = m;
    nc[2 * Q + q] = c[2 * Q + S];
  } else if (h >> 16) {
    nc[Q + q] = base + (int)(h >> 16) - 1;
    nc[2 * Q + q] = (int)((h >> 8) & 255u) - 1;
  } else {
    nc[Q + q] = -1;
    nc[2 * Q + q] = -1;
  }
}

// Boundaries [x0, x1) of the tile at base from s_res (end state at the
// range's right edge, where the carry c = (f, m, i) starts): L, I and F
// written 16 at a time (whole 16-boundary groups) or counted; -1 past n.
template <int kMode>
__device__ __forceinline__ void emit_range(const TileParams& p, int base,
                                           int x0, int x1,
                                           const uint32_t* s_res,
                                           const int* c, bool emit_f,
                                           int& cnt) {
  const int Q = p.Q;
  for (int x = x0 + 16 * threadIdx.x; x < x1; x += 16 * kTileThreads) {
    const int pos0 = base + x;
    const int nbd = min(16, x1 - x);
    int Lv[16], Iv[16];
    uint32_t Fw[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      Lv[e] = -1;
      Iv[e] = -1;
      if (e < nbd) {
        const uint32_t h = s_res[x + e];
        const int S = h & 255u;
        if (pos0 + e <= p.n) {
          const int m = c[Q + S];
          if (m >= 0) {
            Lv[e] = m;
            if (kMode == kEmitLI) Iv[e] = c[2 * Q + S];
          } else if (h >> 16) {
            Lv[e] = base + (int)(h >> 16) - 1;
            Iv[e] = (int)((h >> 8) & 255u) - 1;
          }
        }
        if (kMode != kCount && emit_f)
          Fw[e >> 2] |= (uint32_t)(c[S] & 255) << (8 * (e & 3));
        if (kMode == kCount) cnt += Lv[e] >= 0;
      }
    }
    if (kMode == kCount) continue;
    if (nbd == 16) {
      int4* dL = reinterpret_cast<int4*>(p.L + pos0);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dL[k] = make_int4(Lv[4 * k], Lv[4 * k + 1], Lv[4 * k + 2],
                          Lv[4 * k + 3]);
      if (kMode == kEmitLI) {
        int4* dI = reinterpret_cast<int4*>(p.I + pos0);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          dI[k] = make_int4(Iv[4 * k], Iv[4 * k + 1], Iv[4 * k + 2],
                            Iv[4 * k + 3]);
      }
      if (emit_f)
        *reinterpret_cast<uint4*>(p.F + pos0) =
            make_uint4(Fw[0], Fw[1], Fw[2], Fw[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        if (e < nbd) {
          p.L[pos0 + e] = Lv[e];
          if (kMode == kEmitLI) p.I[pos0 + e] = Iv[e];
          if (emit_f) p.F[pos0 + e] = (uint8_t)(Fw[e >> 2] >> (8 * (e & 3)));
        }
      }
    }
  }
}

// Pass 3: the segment's tiles right to left from its exclusive suffix (the
// carry). A tile takes the FF skip when its rule holds; else the walk
// path: each boundary takes its first step as it is staged, and those
// still live (not dead, before lim) join the warp's queue beside a share
// of the Q state walks (the tile's map, for the carry); each walk runs to
// the dead state or lim, where it takes the carry. A tile whose queue
// gives up takes the grid path (pieces of kPiece bytes in ranges of NB
// pieces, right to left: piece maps, their exclusive suffixes by a
// doubling scan, each boundary run to its piece end and spliced there),
// and so do the next `streak` tiles (doubling up to kStreakMax while walks
// keep giving up); a tile through which pass 1 saw a state live (hint)
// takes it at once, so a text whose threads never die pays no failed try.
// The carry is double-buffered.
template <int kMode>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
tile_emit_kernel(TileParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_abort;
  __shared__ int s_red[2][kTileWarps];
  const int Q = p.Q, C = p.C, n = p.n, dead = p.dead;
  const TileLayout lay = tile_layout(true, Q, C, p.NB);
  int* s_tab = reinterpret_cast<int*>(smem + lay.tab);
  uint8_t* s_map = smem + lay.maps;
  const uint8_t* s_sob = s_map + 256;
  const uint8_t* s_flg = s_map + 512;
  int* s_vec = reinterpret_cast<int*>(smem + lay.vec);   // 2 carries
  uint32_t* s_walk = reinterpret_cast<uint32_t*>(smem + lay.walk);
  uint8_t* s_raw = smem + lay.raw;
  uint8_t* s_cls = smem + lay.cls;
  uint32_t* s_res = reinterpret_cast<uint32_t*>(smem + lay.res);
  uint16_t* s_list = reinterpret_cast<uint16_t*>(smem + lay.list);
  const Grid g = make_grid(p, s_cls, s_tab,
                           reinterpret_cast<uint32_t*>(smem + lay.grid));
  constexpr bool kOut = kMode == kEmitL || kMode == kEmitLI;
  const bool emit_f = kOut && p.F != nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = blockIdx.x;
  const int t_lo = seg * p.tiles_per_seg;
  const int t_hi = min(t_lo + p.tiles_per_seg, p.ntiles);
  const int HB = p.NB * kPiece;

  stage_tile_tables(p, s_tab, s_map);
  for (int q = tid; q < Q; q += kTileThreads) {
    const int* x = p.seg_x + (size_t)seg * 3 * Q;
    s_vec[q] = x[q];
    s_vec[Q + q] = x[Q + q];
    s_vec[2 * Q + q] = x[2 * Q + q];
  }
  if (t_lo < t_hi) prefetch_tile(p, s_raw, t_hi - 1);
  __syncthreads();

  int cnt = 0, skipped = 0;
  if (seg == gridDim.x - 1 && tid == 0) {
    // Boundary P: the last segment's carry is the seed.
    const int st = s_sob[p.text[p.P - 1]];
    const int m = n == p.P ? s_vec[Q + st] : -1;
    if (kMode == kCount) {
      cnt += m >= 0;
    } else {
      p.L[p.P] = m;
      if (kMode == kEmitLI) p.I[p.P] = n == p.P ? s_vec[2 * Q + st] : -1;
      if (emit_f) p.F[p.P] = (uint8_t)s_vec[st];
    }
  }

  int buf = 0, cb = 0, streak = 0, grid_left = 0;
  for (int t = t_hi - 1; t >= t_lo; --t) {
    const int base = t * kTB;
    const int len = min(kTB, p.P - base);
    const int lim = max(0, min(n - base, len));
    const uint8_t* rb = s_raw + buf * kRaw + kLead;
    cp_async_wait_all();
    __syncthreads();                      // tile t's bytes; tile t+1 done
    if (t - 1 >= t_lo) prefetch_tile(p, s_raw + (buf ^ 1) * kRaw, t - 1);
    if (tid == 0) s_abort = 0;
    const int* c = s_vec + cb * 3 * Q;    // the carry right of this tile
    int* nc = s_vec + (cb ^ 1) * 3 * Q;
    const int start_first = base == 0 ? p.start0 : s_sob[rb[-1]];
    auto start_at = [&](int x) {
      return x == 0 ? start_first : s_sob[rb[x - 1]];
    };

    const int x0 = 16 * tid;
    const uint4 v = stage_classes(rb, s_map, s_cls);
    int live = 0;
    if (p.skip) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (x0 + e < len)
          live |= !(s_flg[byte_at(v, e)] & (x0 + e == 0 ? kUniform : kSilent));
    }
    const bool any_live = __syncthreads_or(live);

    if (p.skip && !any_live && base + kTB <= n && c[Q + dead] < 0) {
      // The FF skip: boundary base keeps its first byte's accept; every
      // other boundary is -1 and, like base, dead after its first byte.
      const int c0 = s_map[rb[0]];
      if (kOut) {
        const int fd = c[dead] & 255;
        const uint32_t f4 = emit_f ? (uint32_t)fd * 0x01010101u : 0u;
        int4* dL = reinterpret_cast<int4*>(p.L + base + x0);
        for (int k = 0; k < 4; ++k) dL[k] = make_int4(-1, -1, -1, -1);
        if (kMode == kEmitLI) {
          int4* dI = reinterpret_cast<int4*>(p.I + base + x0);
          for (int k = 0; k < 4; ++k) dI[k] = make_int4(-1, -1, -1, -1);
        }
        if (emit_f)
          *reinterpret_cast<uint4*>(p.F + base + x0) =
              make_uint4(f4, f4, f4, f4);
      }
      if (tid == 0) {                     // its group of 16 is thread 0's
        const int a = (s_tab[start_first * C + c0] & 255) - 1;
        if (kMode == kCount) {
          cnt += a >= 0;
        } else {
          p.L[base] = a >= 0 ? base : -1;
          if (kMode == kEmitLI) p.I[base] = a;
        }
        ++skipped;
      }
      for (int q = tid; q < Q; q += kTileThreads) {
        const int a = (s_tab[q * C + c0] & 255) - 1;
        nc[q] = c[dead];
        nc[Q + q] = a >= 0 ? base : -1;
        nc[2 * Q + q] = a;
      }
      cb ^= 1;
      buf ^= 1;
      continue;
    }

    bool walked = false;
    if (p.hint[t]) {
      // pass 1 saw a state live through this tile: the grid path
    } else if (grid_left > 0) {
      --grid_left;
    } else {
      // First steps, and the warp's list of live boundaries.
      unsigned livemask = 0;
      int prev = x0 == 0 ? -1 : rb[x0 - 1];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int x = x0 + e;
        const int b = byte_at(v, e);
        int S = x == 0 ? start_first : s_sob[prev];
        uint32_t h = (uint32_t)S;
        if (x < lim && S != dead) {
          const int val = s_tab[S * C + s_map[b]];
          const uint32_t a1 = (uint32_t)val & 255u;
          S = val >> 8;
          h = (uint32_t)S | (a1 ? (a1 << 8) | ((uint32_t)(x + 1) << 16) : 0u);
          if (S != dead && x + 1 < lim) livemask |= 1u << e;
        }
        if (x < len) s_res[x] = h;
        prev = b;
      }
      const int own = __popc(livemask);
      int incl = own;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      uint16_t* wl = s_list + warp * kWarpBytes;
      int at = incl - own;
      for (unsigned rest = livemask; rest; rest &= rest - 1)
        wl[at++] = (uint16_t)(x0 + __ffs(rest) - 1);
      const int nlive = __shfl_sync(kFull, incl, 31);
      __syncwarp();
      const int mine =
          nlive + (Q > warp ? (Q - warp + kTileWarps - 1) / kTileWarps : 0);
      auto load = [&](int k) {
        if (k < nlive) {
          const int x = wl[k];
          const uint32_t h = s_res[x];
          return Walk{x, (int)(h & 255u), x + 1, h & ~255u};
        }
        const int q = warp + kTileWarps * (k - nlive);
        return Walk{kStateItem | q, q, 0, 0u};
      };
      auto finish = [&](const Walk& w) {
        const uint32_t h = (uint32_t)w.S | w.acc;
        if (w.id & kStateItem) s_walk[w.id & 0xffff] = h;
        else s_res[w.id] = h;
      };
      const bool ok = walk_queue(mine, lim, dead, s_cls, s_tab, C,
                                 kCapRounds, &s_abort, load, finish);
      walked = !__syncthreads_or(!ok);
      if (walked) {
        streak = 0;
      } else {
        streak = min(max(1, 2 * streak), kStreakMax);
        grid_left = streak;
      }
    }

    if (walked) {
      emit_range<kMode>(p, base, 0, len, s_res, c, emit_f, cnt);
      for (int q = tid; q < Q; q += kTileThreads)
        carry_through(s_walk[q], base, q, c, nc, Q);
      cb ^= 1;
    } else {
      // The grid path, range by range from the right.
      for (int x1 = len; x1 > 0;) {
        const int xa = (x1 - 1) / HB * HB;
        const int* cc = s_vec + cb * 3 * Q;
        int* ncc = s_vec + (cb ^ 1) * 3 * Q;
        grid_pieces(g, xa, x1, lim);
        const uint32_t* X =
            grid_suffixes(g, (x1 - xa + kPiece - 1) / kPiece);
        grid_bounds(g, xa, x1, lim, X, s_res, start_at);
        __syncthreads();
        emit_range<kMode>(p, base, xa, x1, s_res, cc, emit_f, cnt);
        for (int q = tid; q < Q; q += kTileThreads)
          carry_through(compose(g.Sp[q], X), base, q, cc, ncc, Q);
        __syncthreads();                  // the carry and Sp, X are read
        cb ^= 1;
        x1 = xa;
      }
    }
    buf ^= 1;
  }
  cp_async_wait_all();

  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_down_sync(kFull, cnt, o);
    skipped += __shfl_down_sync(kFull, skipped, o);
  }
  if (lane == 0) {
    s_red[0][warp] = cnt;
    s_red[1][warp] = skipped;
  }
  __syncthreads();
  if (tid == 0) {
    int total = 0, sk = 0;
    for (int w = 0; w < kTileWarps; ++w) {
      total += s_red[0][w];
      sk += s_red[1][w];
    }
    if (kMode == kCount && total) atomicAdd(p.counts, total);
    if (sk) atomicAdd(p.counts + 1, sk);
  }
}

// A barrier of the `count` threads of group `id` (named barrier id + 1;
// barrier 0 is __syncthreads').
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id + 1), "r"(count) : "memory");
}

// The carry pass of the tile instance, one block of `groups` groups of W threads (W the power of two >= Q and >=
// 64, at most kCarryGroups groups, each with a named barrier of its own):
// X_j = S_{j+1} o ... o S_{nseg-1} o seed for every segment j, and
// G = S_0 o X_0 (layout (j, r, q): r = 0 f, 1 m, 2 i). A group holds a
// state vector in shared memory, one state a thread: each group composes
// its run of segments right to left into an aggregate; group 0 composes
// the aggregates from the seed into each run's carry and G; each group
// walks its run again from its carry and writes X_j. Two chains of
// nseg / groups steps and one of `groups`, each step a shared-memory
// lookup between two group barriers; the summaries of the next
// kCarryAhead segments are loaded while the current ones are composed.
__global__ void __launch_bounds__(kCarryThreads) tile_carry_kernel(
    const int* __restrict__ seg_sum, const int* __restrict__ seed,
    int* __restrict__ seg_x, int* __restrict__ G, int Q, int W, int nseg) {
  __shared__ int s_v[3][kCarryThreads];   // each group's vector
  __shared__ int s_a[3][kCarryThreads];   // the groups' aggregates
  __shared__ int s_c[3][kCarryThreads];   // the groups' carries
  const int tid = threadIdx.x, g = tid / W, q = tid - g * W;
  const int groups = blockDim.x / W;
  const int run = (nseg + groups - 1) / groups;
  const int lo = min(g * run, nseg), hi = min(lo + run, nseg);
  const bool real = q < Q;
  int* v0 = s_v[0] + g * W;
  int* v1 = s_v[1] + g * W;
  int* v2 = s_v[2] + g * W;
  // S_j at q (the identity past Q and outside the run).
  auto load = [&](int j, int& f, int& m, int& i) {
    f = q;
    m = i = -1;
    if (real && j >= lo && j < hi) {
      const int* x = seg_sum + (size_t)j * 3 * Q;
      f = __ldg(x + q);
      m = __ldg(x + Q + q);
      i = __ldg(x + 2 * Q + q);
    }
  };
  // The group's vector V becomes S o V.
  auto step = [&](int sf, int sm, int si) {
    const int nf = v0[sf], nm = v1[sf], ni = v2[sf];
    group_sync(g, W);
    v0[q] = nf;
    v1[q] = nm >= 0 ? nm : sm;
    v2[q] = nm >= 0 ? ni : si;
    group_sync(g, W);
  };
  // Segments hi-1 down to lo, kCarryAhead at a time (writing each X_j
  // before composing S_j, with `write`).
  auto walk_run = [&](bool write) {
    int f[kCarryAhead], m[kCarryAhead], i[kCarryAhead];
#pragma unroll
    for (int u = 0; u < kCarryAhead; ++u) load(hi - 1 - u, f[u], m[u], i[u]);
    for (int j0 = hi - 1; j0 >= lo; j0 -= kCarryAhead) {
      int nf[kCarryAhead], nm[kCarryAhead], ni[kCarryAhead];
#pragma unroll
      for (int u = 0; u < kCarryAhead; ++u)
        load(j0 - kCarryAhead - u, nf[u], nm[u], ni[u]);
#pragma unroll
      for (int u = 0; u < kCarryAhead; ++u) {
        const int j = j0 - u;
        if (j >= lo) {                    // uniform in the group
          if (write && real) {
            int* x = seg_x + (size_t)j * 3 * Q;
            x[q] = v0[q];
            x[Q + q] = v1[q];
            x[2 * Q + q] = v2[q];
          }
          step(f[u], m[u], i[u]);
        }
        f[u] = nf[u];
        m[u] = nm[u];
        i[u] = ni[u];
      }
    }
  };
  v0[q] = q;
  v1[q] = v2[q] = -1;
  group_sync(g, W);
  walk_run(false);
  s_a[0][tid] = v0[q];
  s_a[1][tid] = v1[q];
  s_a[2][tid] = v2[q];
  __syncthreads();
  if (g == 0) {
    // Group 0's vector becomes the seed, then moves left past each run.
    v0[q] = real ? seed[q] : q;
    v1[q] = real ? seed[Q + q] : -1;
    v2[q] = real ? seed[2 * Q + q] : -1;
    group_sync(0, W);
    for (int k = groups - 1; k >= 0; --k) {
      s_c[0][k * W + q] = v0[q];
      s_c[1][k * W + q] = v1[q];
      s_c[2][k * W + q] = v2[q];
      step(s_a[0][k * W + q], s_a[1][k * W + q], s_a[2][k * W + q]);
    }
    if (real) {
      G[q] = v0[q];
      G[Q + q] = v1[q];
      G[2 * Q + q] = v2[q];
    }
  }
  __syncthreads();
  v0[q] = s_c[0][tid];
  v1[q] = s_c[1][tid];
  v2[q] = s_c[2][tid];
  group_sync(g, W);
  walk_run(true);
}

template <class Kernel>
cudaError_t tile_prepare(Kernel kernel, size_t bytes) {
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  if (bytes > kSmemDefault)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return cudaSuccess;
}

template <int kMode>
cudaError_t launch_tile_emit(const TileParams& p, int nseg, cudaStream_t s) {
  const size_t bytes = tile_layout(true, p.Q, p.C, p.NB).total;
  cudaError_t err = tile_prepare(tile_emit_kernel<kMode>, bytes);
  if (err != cudaSuccess) return err;
  tile_emit_kernel<kMode><<<nseg, kTileThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

// Blocks of a tile kernel an SM holds at once, or -1 on an error.
template <class Kernel>
int tile_blocks_per_sm(Kernel kernel, size_t bytes) {
  int b = 0;
  if (tile_prepare(kernel, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, kTileThreads,
                                                    bytes) != cudaSuccess)
    return -1;
  return b;
}

// ---------------------------------------------------------------------------
// The sweep instance (Q <= 32)
// ---------------------------------------------------------------------------

constexpr int kSweepThreads = 256;      // threads of a sweep block
constexpr int kSweepTile = 128;         // bytes of a skip tile; chunks are whole tiles
constexpr int kSweepMaxQ = 32;

struct SweepParams {
  const uint8_t* text;   // (P,) padded text, 16-byte aligned
  const uint32_t* T;     // (256, W) byte table, see the top of the file
  int* seg_sum;          // (nseg, 3, Q) segment summaries (pass 1 out)
  const int* seg_x;      // (nseg, 3, Q) segment exclusive suffixes (pass 3 in)
  int* chunk_x;          // (nseg, 3, kSweepThreads) in-segment suffix per lane
  int* L;                // (P+1,)
  int* I;                // (P+1,) in kEmitLI
  uint8_t* F;            // (P+1,) end states (emit_f), F + 1 16-byte aligned
  int* counts;           // [0] count, [1] tiles skipped by pass 3
  int Q, W, P, n;
  int start0;            // start state at boundary 0 (the begin context)
  int dead;              // dead state, or -1
  int skip;              // the FF tile skip is on
  int ntiles, tiles_per_chunk;
};


// s_T[b * 32 + s] = T[b, s % W]: 32 / W copies of each byte's row.
__device__ __forceinline__ void stage_table(uint32_t* s_T, const uint32_t* T,
                                            int W) {
  for (int x = threadIdx.x; x < 256 * 32; x += kSweepThreads)
    s_T[x] = __ldg(T + (x >> 5) * W + (x & (W - 1)));
}

// Text bytes pos .. pos+15 (pos a multiple of 16), zeros past P.
__device__ __forceinline__ uint4 load16(const uint8_t* text, int pos, int P) {
  if (pos + 16 <= P) return __ldg(reinterpret_cast<const uint4*>(text + pos));
  uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
  for (int b = 0; b < 16 && pos + b < P; ++b) {
    const uint32_t x = (uint32_t)text[pos + b] << (8 * (b & 3));
    if (b < 4) w0 |= x; else if (b < 8) w1 |= x; else if (b < 12) w2 |= x;
    else w3 |= x;
  }
  return make_uint4(w0, w1, w2, w3);
}

__device__ __forceinline__ int byte_of(const uint4& v, int b) {
  const uint32_t w = b < 4 ? v.x : b < 8 ? v.y : b < 12 ? v.z : v.w;
  return (w >> (8 * (b & 3))) & 255;
}

// [lo, hi) of group g's chunk in this block's segment; false past the text.
__device__ __forceinline__ bool chunk_range(const SweepParams& p, int g,
                                            int& lo, int& hi) {
  const long long t0 =
      ((long long)blockIdx.x * (kSweepThreads / p.W) + g) * p.tiles_per_chunk;
  if (t0 >= p.ntiles) {
    lo = hi = 0;
    return false;
  }
  lo = (int)(t0 * kSweepTile);
  hi = (int)min((long long)p.P, (t0 + p.tiles_per_chunk) * kSweepTile);
  return true;
}

// Pass 1: chunk summaries (each state forward through the chunk, up to n,
// until every state is dead), the in-segment exclusive suffix of every
// chunk (X_g = S_{g+1} o ... o S_{G-1}, identity past the last chunk, by a
// doubling scan over the groups) into chunk_x, and the segment's summary
// S_0 o X_0 into seg_sum.
__global__ void __launch_bounds__(kSweepThreads)
sweep_summary_kernel(SweepParams p) {
  __shared__ uint32_t s_T[256 * 32];
  __shared__ int s_x[2][3][kSweepThreads];
  const int tid = threadIdx.x, W = p.W, G = kSweepThreads / W;
  const int g = tid / W, q = tid & (W - 1);
  const int gl = (tid & 31) & ~(W - 1);
  stage_table(s_T, p.T, W);
  __syncthreads();

  int lo, hi;
  chunk_range(p, g, lo, hi);
  hi = min(hi, p.n);               // steps at or past n are the identity
  const bool idle = q >= p.Q;      // lanes past Q: no state of the DFA
  int S = q, m = -1, i = -1;
  // The groups of a warp step together, 16 bytes at a time, and stop
  // when each has finished its chunk or has every state dead (the dead
  // state absorbs and never accepts: nothing further changes).
  for (int pos = lo; pos < lo + p.tiles_per_chunk * kSweepTile; pos += 16) {
    const int left = hi - pos;
    if (left > 0) {
      const uint4 v = load16(p.text, pos, p.P);
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        if (b < left) {
          const uint32_t e = s_T[byte_of(v, b) * 32 + gl + S];
          const int a1 = (e >> 8) & 255;
          if (a1) {
            m = pos + b;
            i = a1 - 1;
          }
          S = e & 255;
        }
      }
    }
    if (__all_sync(kFull, idle || left <= 16 ||
                              (p.dead >= 0 && S == p.dead)))
      break;
  }

  s_x[1][0][tid] = S;
  s_x[1][1][tid] = m;
  s_x[1][2][tid] = i;
  __syncthreads();
  int xf = q, xm = -1, xi = -1;
  if (g + 1 < G) {
    xf = s_x[1][0][tid + W];
    xm = s_x[1][1][tid + W];
    xi = s_x[1][2][tid + W];
  }
  s_x[0][0][tid] = xf;
  s_x[0][1][tid] = xm;
  s_x[0][2][tid] = xi;
  __syncthreads();
  int cur = 0;
  for (int d = 1; d < G; d *= 2) {
    if (g + d < G) {
      const int o = (g + d) * W + xf;
      const int mg = s_x[cur][1][o];
      if (mg >= 0) {
        xm = mg;
        xi = s_x[cur][2][o];
      }
      xf = s_x[cur][0][o];
    }
    cur ^= 1;
    s_x[cur][0][tid] = xf;
    s_x[cur][1][tid] = xm;
    s_x[cur][2][tid] = xi;
    __syncthreads();
  }
  int* cx = p.chunk_x + (size_t)blockIdx.x * 3 * kSweepThreads;
  cx[tid] = xf;
  cx[kSweepThreads + tid] = xm;
  cx[2 * kSweepThreads + tid] = xi;
  if (g == 0 && q < p.Q) {
    const int mg = s_x[cur][1][S];   // X_0 sits at tid = state in group 0
    int* out = p.seg_sum + (size_t)blockIdx.x * 3 * p.Q;
    out[q] = s_x[cur][0][S];
    out[p.Q + q] = mg >= 0 ? mg : m;
    out[2 * p.Q + q] = mg >= 0 ? s_x[cur][2][S] : i;
  }
}

// Byte b of a 16-byte piece, zero-extended (one PRMT).
__device__ __forceinline__ uint32_t piece_byte(const uint4& v, int b) {
  const uint32_t w = b < 4 ? v.x : b < 8 ? v.y : b < 12 ? v.z : v.w;
  return __byte_perm(w, 0, 0x4440 | (b & 3));
}

// One right-to-left sweep of the 128-byte tile at tb, by all 32 lanes of
// a warp together (shuffles of the whole warp, width W): V holds m (and
// i) per lane; f only with kF (emit_f), since otherwise only the m and i
// of the later vector are read. With kF, f'(q) = f(next(q, byte)) takes
// one more shuffle a byte, and each boundary's end state is V's f at its
// start state, read as its L is. Boundaries (tb, te] are stored.
// kCheck: bytes at or past min(te, n) are the identity (a group whose tile
// is empty has te <= tb); else every byte of the tile lies below te and n.
// With kLane, lane `emit` (an idle lane, q = Q < W) has the start state
// after each byte as its next state and no accept, so its update shuffle
// reads V at the boundary's start state: after byte j it holds L[j+1]
// (and I[j+1]), with no shuffle of its own. Else each boundary takes one
// more shuffle. The writing lane keeps a 16-byte piece's values in
// registers and stores them as four 16-byte words (L + 1 is 16-byte
// aligned), the piece's 16 end states as one (F + 1 is 16-byte aligned).
// F needs no `live` mask: past min(te, n) V does not change, so the
// shuffle reads the right vector there too. s_col: this lane's column of
// the byte table, as bytes (a byte's row is 128 bytes on).
template <int kMode, bool kF, bool kLane, bool kCheck>
__device__ __forceinline__ void sweep_tile(const SweepParams& p,
                                           const char* s_col, int W, int q,
                                           int emit, int tb, int te, int& vm,
                                           int& vi, int& vf, int& cnt) {
  const int lim = min(te, p.n);
  const int writer = kLane ? emit : 0;
  for (int pos = tb + kSweepTile - 16; pos >= tb; pos -= 16) {
    const uint4 v = load16(p.text, pos, p.P);
    int aL[16], aI[16];
    uint32_t aF[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 15; b >= 0; --b) {
      const int j = pos + b;
      const bool live = !kCheck || j < lim;
      const uint32_t e = *reinterpret_cast<const uint32_t*>(
          s_col + piece_byte(v, b) * 128);
      int eL = -1, eI = -1, eF = 0;
      if (!kLane) {
        eL = __shfl_sync(kFull, vm, e >> 24, W);
        if (kMode == kEmitLI) eI = __shfl_sync(kFull, vi, e >> 24, W);
        if (kF) eF = __shfl_sync(kFull, vf, e >> 24, W);
      }
      // The low bits of e are the next state: the shuffle's source lane.
      const int nm = __shfl_sync(kFull, vm, e, W);
      int ni = 0, nf = 0;
      if (kMode == kEmitLI) ni = __shfl_sync(kFull, vi, e, W);
      if (kF) nf = __shfl_sync(kFull, vf, e, W);
      const int aj = (e & 0xff00u) ? j : -1;   // off the chain
      if (live) {
        const bool later = nm >= 0;
        if (kMode == kEmitLI)
          vi = later || q == emit ? ni : (int)((e >> 8) & 255) - 1;
        vm = later ? nm : aj;
        if (kF) vf = nf;
      }
      if (kLane) {
        eL = vm;
        eI = vi;
        eF = nf;
      }
      aL[b] = live ? eL : -1;
      aI[b] = live ? eI : -1;
      if (kF) aF[b >> 2] |= (uint32_t)(eF & 255) << (8 * (b & 3));
    }
    const int nb = min(16, te - pos);    // boundaries pos+1 .. pos+nb
    if (q == writer && nb > 0) {
      if (kMode == kCount) {
#pragma unroll
        for (int b = 0; b < 16; ++b) cnt += b < nb && aL[b] >= 0;
      } else if (nb == 16) {
        int4* dL = reinterpret_cast<int4*>(p.L + pos + 1);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          dL[k] = make_int4(aL[4 * k], aL[4 * k + 1], aL[4 * k + 2],
                            aL[4 * k + 3]);
        if (kMode == kEmitLI) {
          int4* dI = reinterpret_cast<int4*>(p.I + pos + 1);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            dI[k] = make_int4(aI[4 * k], aI[4 * k + 1], aI[4 * k + 2],
                              aI[4 * k + 3]);
        }
        if (kF)
          *reinterpret_cast<uint4*>(p.F + pos + 1) =
              make_uint4(aF[0], aF[1], aF[2], aF[3]);
      } else {
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          if (b < nb) {
            p.L[pos + 1 + b] = aL[b];
            if (kMode == kEmitLI) p.I[pos + 1 + b] = aI[b];
            if (kF) p.F[pos + 1 + b] = (uint8_t)(aF[b >> 2] >> (8 * (b & 3)));
          }
        }
      }
    }
  }
}

// One tile by the sweep variant its warp needs (every shuffle is one of
// the whole warp, so the choice is made for the warp).
template <int kMode, bool kF>
__device__ __forceinline__ void sweep_any(const SweepParams& p,
                                          const char* s_col, int W, int q,
                                          int emit, int tb, int te, int& vm,
                                          int& vi, int& vf, int& cnt) {
  const bool check =
      !__all_sync(kFull, te == tb + kSweepTile && te <= p.n);
  if (emit >= 0) {
    if (check)
      sweep_tile<kMode, kF, true, true>(p, s_col, W, q, emit, tb, te, vm, vi,
                                        vf, cnt);
    else
      sweep_tile<kMode, kF, true, false>(p, s_col, W, q, emit, tb, te, vm,
                                         vi, vf, cnt);
  } else {
    if (check)
      sweep_tile<kMode, kF, false, true>(p, s_col, W, q, emit, tb, te, vm,
                                         vi, vf, cnt);
    else
      sweep_tile<kMode, kF, false, false>(p, s_col, W, q, emit, tb, te, vm,
                                          vi, vf, cnt);
  }
}

// Pass 3: each group sweeps its chunk right to left from V = X_g o carry,
// one state per lane, emitting boundaries (lo, hi] (and boundary 0 for
// the first chunk). The groups of a warp walk their chunks' tiles in
// lockstep, so every shuffle is one of the whole warp. kF: V carries f too
// and each boundary's end state goes to F.
template <int kMode, bool kF>
__global__ void __launch_bounds__(kSweepThreads)
sweep_emit_kernel(SweepParams p) {
  __shared__ uint32_t s_T[256 * 32];
  __shared__ int s_c[3][kSweepMaxQ];
  __shared__ int s_red[2][kSweepThreads / 32];
  const int tid = threadIdx.x, W = p.W, n = p.n;
  const int g = tid / W, q = tid & (W - 1);
  const int gl = (tid & 31) & ~(W - 1);
  const unsigned gbits = W == 32 ? kFull : ((1u << W) - 1u) << gl;
  const uint32_t* s_row = s_T + gl + q;   // this lane's column of the table
  stage_table(s_T, p.T, W);
  if (tid < kSweepMaxQ) {
    const int* x = p.seg_x + (size_t)blockIdx.x * 3 * p.Q;
    const bool real = tid < p.Q;
    s_c[0][tid] = real ? x[tid] : tid;
    s_c[1][tid] = real ? x[p.Q + tid] : -1;
    s_c[2][tid] = real ? x[2 * p.Q + tid] : -1;
  }
  __syncthreads();

  // V, the suffix right of this chunk: X_g o carry (f only with kF).
  const int* cx = p.chunk_x + (size_t)blockIdx.x * 3 * kSweepThreads;
  const int xf = cx[tid], xm = cx[kSweepThreads + tid];
  const int xi = cx[2 * kSweepThreads + tid];
  const int mg = s_c[1][xf];
  int vm = mg >= 0 ? mg : xm;
  int vi = mg >= 0 ? s_c[2][xf] : xi;
  int vf = kF ? s_c[0][xf] : 0;

  const int emit = p.Q < W ? p.Q : -1;    // the idle lane that emits
  int lo, hi;
  const bool valid = chunk_range(p, g, lo, hi);   // else lo = hi = 0
  int cnt = 0, skipped = 0;
  for (int k = p.tiles_per_chunk - 1; k >= 0; --k) {
    const int tb = lo + k * kSweepTile;
    const int te = min(tb + kSweepTile, hi);     // <= tb: no bytes here
    if (p.skip) {
      // The FF tile skip, for a warp whose groups can all take it (or have
      // no bytes here): first byte uniform, the others silent, no match
      // from the dead state beyond the tile.
      const bool whole = te == tb + kSweepTile && te <= n;
      int live = 0;
      for (int v = q; v < kSweepTile / 16; v += W) {
        const uint4 w = load16(p.text, tb + 16 * v, p.P);
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const int f = (s_row[byte_of(w, b) * 32] >> 16) & 255;
          live |= !(f & (v == 0 && b == 0 ? kUniform : kSilent));
        }
      }
      const unsigned any = __ballot_sync(kFull, live) & gbits;
      const int dm = __shfl_sync(kFull, vm, p.dead, W);
      const bool can = whole && !any && dm < 0;
      if (__all_sync(kFull, can || te <= tb)) {
        // Boundary te from V; the inner boundaries are -1, and in the dead
        // state after their first byte (end state: V's f at dead); V moves
        // left past the tile: (V's f at dead, tb if byte tb accepts from
        // q, its pid).
        const int st = s_row[p.text[max(te - 1, 0)] * 32] >> 24;
        const int Lv = __shfl_sync(kFull, vm, st, W);
        const int Iv = __shfl_sync(kFull, vi, st, W);
        int Fv = 0, Fd = 0;
        if (kF) {
          Fv = __shfl_sync(kFull, vf, st, W);
          Fd = __shfl_sync(kFull, vf, p.dead, W);
        }
        if (can) {
          if (kMode == kCount) {
            cnt += q == 0 && Lv >= 0;
          } else {
            if (q == 0) {
              p.L[te] = Lv;
              if (kMode == kEmitLI) p.I[te] = Iv;
              if (kF) p.F[te] = (uint8_t)Fv;
            }
            for (int b = tb + 1 + q; b < te; b += W) {
              p.L[b] = -1;
              if (kMode == kEmitLI) p.I[b] = -1;
              if (kF) p.F[b] = (uint8_t)Fd;
            }
          }
          const int a1 = (s_row[p.text[tb] * 32] >> 8) & 255;
          vm = a1 ? tb : -1;
          vi = a1 - 1;
          if (kF) vf = Fd;
          skipped += q == 0;
        }
        continue;
      }
    }
    sweep_any<kMode, kF>(p, reinterpret_cast<const char*>(s_row), W, q,
                         emit, tb, te, vm, vi, vf, cnt);
  }
  {
    // Boundary 0, from the caller's start state (start0).
    const int Lv = __shfl_sync(kFull, vm, p.start0, W);
    const int Iv = __shfl_sync(kFull, vi, p.start0, W);
    const int Fv = kF ? __shfl_sync(kFull, vf, p.start0, W) : 0;
    if (valid && lo == 0 && q == 0) {
      if (kMode == kCount) {
        cnt += Lv >= 0;
      } else {
        p.L[0] = Lv;
        if (kMode == kEmitLI) p.I[0] = Iv;
        if (kF) p.F[0] = (uint8_t)Fv;
      }
    }
  }

  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_down_sync(kFull, cnt, o);
    skipped += __shfl_down_sync(kFull, skipped, o);
  }
  if ((tid & 31) == 0) {
    s_red[0][tid >> 5] = cnt;
    s_red[1][tid >> 5] = skipped;
  }
  __syncthreads();
  if (tid == 0) {
    int total = 0, sk = 0;
    for (int w = 0; w < kSweepThreads / 32; ++w) {
      total += s_red[0][w];
      sk += s_red[1][w];
    }
    if (total) atomicAdd(p.counts, total);
    if (sk) atomicAdd(p.counts + 1, sk);
  }
}

// The carry pass of the sweep instance (one block of 32 warps, Q <= 32,
// one state per lane): X_j = S_{j+1} o ... o S_{nseg-1} o seed for every
// segment j, and G = S_0 o X_0. Warp w composes its run of segments right
// to left into an aggregate; warp 0 composes the 32 aggregates from the
// seed into each run's carry and G; each warp walks its run again from its
// carry and writes X_j. Two chains of nseg / 32 steps and one of 32, each
// step three shuffles, where the doubling scan takes log2(nseg) rounds
// through device memory.
__global__ void __launch_bounds__(1024)
sweep_carry_kernel(const int* __restrict__ seg_sum,
                   const int* __restrict__ seed, int* __restrict__ seg_x,
                   int* __restrict__ G, int Q, int nseg) {
  __shared__ int s_a[3][32][32];   // aggregates [r][warp][lane]
  __shared__ int s_c[3][32][32];   // carries
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bool real = lane < Q;
  const int run = (nseg + 31) / 32;
  const int lo = min(w * run, nseg), hi = min(lo + run, nseg);
  // vf/vm/vi = S_j o V, S_j read from seg_sum (identity past Q).
  auto compose = [&](int j, int& vf, int& vm, int& vi) {
    const int* s = seg_sum + (size_t)j * 3 * Q;
    const int sf = real ? s[lane] : lane;
    const int sm = real ? s[Q + lane] : -1;
    const int si = real ? s[2 * Q + lane] : -1;
    const int nf = __shfl_sync(0xffffffffu, vf, sf);
    const int nm = __shfl_sync(0xffffffffu, vm, sf);
    const int ni = __shfl_sync(0xffffffffu, vi, sf);
    vf = nf;
    vm = nm >= 0 ? nm : sm;
    vi = nm >= 0 ? ni : si;
  };
  int vf = lane, vm = -1, vi = -1;
  for (int j = hi - 1; j >= lo; --j) compose(j, vf, vm, vi);
  s_a[0][w][lane] = vf;
  s_a[1][w][lane] = vm;
  s_a[2][w][lane] = vi;
  __syncthreads();
  if (w == 0) {
    int cf = real ? seed[lane] : lane;
    int cm = real ? seed[Q + lane] : -1;
    int ci = real ? seed[2 * Q + lane] : -1;
    for (int k = 31; k >= 0; --k) {
      s_c[0][k][lane] = cf;
      s_c[1][k][lane] = cm;
      s_c[2][k][lane] = ci;
      const int af = s_a[0][k][lane];
      const int nf = __shfl_sync(0xffffffffu, cf, af);
      const int nm = __shfl_sync(0xffffffffu, cm, af);
      const int ni = __shfl_sync(0xffffffffu, ci, af);
      cf = nf;
      ci = nm >= 0 ? ni : s_a[2][k][lane];
      cm = nm >= 0 ? nm : s_a[1][k][lane];
    }
    if (real) {
      G[lane] = cf;
      G[Q + lane] = cm;
      G[2 * Q + lane] = ci;
    }
  }
  __syncthreads();
  vf = s_c[0][w][lane];
  vm = s_c[1][w][lane];
  vi = s_c[2][w][lane];
  for (int j = hi - 1; j >= lo; --j) {
    if (real) {
      int* x = seg_x + (size_t)j * 3 * Q;
      x[lane] = vf;
      x[Q + lane] = vm;
      x[2 * Q + lane] = vi;
    }
    compose(j, vf, vm, vi);
  }
}

template <int kMode, bool kF>
cudaError_t launch_sweep_emit(const SweepParams& p, int nseg, cudaStream_t s) {
  sweep_emit_kernel<kMode, kF><<<nseg, kSweepThreads, 0, s>>>(p);
  return cudaGetLastError();
}

template <int kMode, bool kF>
int emit_blocks_per_sm() {
  int b = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &b, sweep_emit_kernel<kMode, kF>, kSweepThreads, 0);
  return b;
}


}  // namespace

extern "C" {

// CUDA blocks of the tile instance that fit the current card at once in
// `mode` (pass 1 and pass 3 together), or -1 on an error.
int schain_tile_max_blocks(int mode, int Q, int C, int NB) {
  int dev = 0, sms = 0;
  if (Q <= 0 || Q > 256 || C <= 0 || NB <= 0 || mode < kEmitL ||
      mode > kCount || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  const int b1 = tile_blocks_per_sm(tile_summary_kernel,
                                    tile_layout(false, Q, C, NB).total);
  const size_t e = tile_layout(true, Q, C, NB).total;
  const int b3 =
      mode == kEmitL    ? tile_blocks_per_sm(tile_emit_kernel<kEmitL>, e)
      : mode == kEmitLI ? tile_blocks_per_sm(tile_emit_kernel<kEmitLI>, e)
                        : tile_blocks_per_sm(tile_emit_kernel<kCount>, e);
  if (b1 < 0 || b3 < 0) return -1;
  return sms * (b1 < b3 ? b1 : b3);
}

// One fused match by the tile instance: pass 1, the carry pass, and pass 3
// in `mode` (1 L, 2 L and I, 3 count), on `stream`. The text's 4096-byte
// tiles go tiles_per_seg to a segment: nseg segments, whose count the
// caller passes as a check. The grid path takes ranges of NB pieces (a
// power of two) of kPiece bytes, NB * kPiece dividing a tile.
// seg_sum and seg_x hold nseg*3*Q ints, L and I P+1 ints, F (emit_f: each
// boundary's end state; null for none, and in count mode) P+1 bytes, each
// 16-byte aligned, as the text; counts 2 ints zeroed by the caller; hint
// one byte a tile (scratch); G gets 3*Q ints. start0 is boundary 0's start
// state; dead the tables' dead state or -1 (the skip needs one). Returns
// cudaGetLastError() after the last launch (0 = launched), or the first
// launch's error, or cudaErrorInvalidValue for arguments the kernels do not
// take.
int schain_fused_tile(const uint8_t* text, const int* tab, const int* class_of,
                      const int* start_of, const int* flags, const int* seed,
                      int* seg_sum, int* seg_x, int* L, int* I, uint8_t* F,
                      int* G, int* counts, uint8_t* hint, int Q, int C,
                      int NB, int P, int n, int start0, int dead,
                      int skip, int tiles_per_seg, int nseg, int mode,
                      void* stream) {
  if (Q <= 0 || Q > 256 || C <= 0 || C > 256 || NB <= 0 || (NB & (NB - 1)) ||
      NB * kPiece > kTB || P <= 0 || n < 0 ||
      n > P || tiles_per_seg <= 0 ||
      mode < kEmitL || mode > kCount || dead < -1 || dead >= Q ||
      (skip && dead < 0) || start0 < 0 || start0 >= Q ||
      (F && mode == kCount) || !hint || ((uintptr_t)text & 15) ||
      (mode != kCount && ((uintptr_t)L & 15)) ||
      (mode == kEmitLI && ((uintptr_t)I & 15)) || ((uintptr_t)F & 15))
    return (int)cudaErrorInvalidValue;
  const int ntiles = (P + kTB - 1) / kTB;
  if (nseg != (ntiles + tiles_per_seg - 1) / tiles_per_seg ||
      nseg > kMaxSegments)
    return (int)cudaErrorInvalidValue;
  TileParams p{text,   tab,    class_of, start_of, flags,  seg_sum,
               seg_x,  L,      I,        F,        counts, hint,
               Q,      C,      NB,       P,        n,      start0,
               dead,   skip ? 1 : 0,     ntiles,   tiles_per_seg};
  cudaStream_t s = (cudaStream_t)stream;
  const size_t b1 = tile_layout(false, Q, C, NB).total;
  cudaError_t err = tile_prepare(tile_summary_kernel, b1);
  if (err != cudaSuccess) return (int)err;
  tile_summary_kernel<<<nseg, kTileThreads, b1, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int W = 64;
  while (W < Q) W *= 2;
  const int groups =
      kCarryThreads / W < kCarryGroups ? kCarryThreads / W : kCarryGroups;
  tile_carry_kernel<<<1, groups * W, 0, s>>>(seg_sum, seed, seg_x, G, Q, W,
                                             nseg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (mode == kEmitL) return (int)launch_tile_emit<kEmitL>(p, nseg, s);
  if (mode == kEmitLI) return (int)launch_tile_emit<kEmitLI>(p, nseg, s);
  return (int)launch_tile_emit<kCount>(p, nseg, s);
}

// CUDA blocks of the sweep instance that fit the current card at once in
// `mode` (pass 1 and pass 3 together; emit_f: pass 3 writes F), or -1 on
// an error.
int schain_sweep_max_blocks(int mode, int emit_f) {
  int dev = 0, sms = 0, b1 = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &b1, sweep_summary_kernel, kSweepThreads, 0) != cudaSuccess)
    return -1;
  const int b3 =
      mode == kEmitL    ? (emit_f ? emit_blocks_per_sm<kEmitL, true>()
                                  : emit_blocks_per_sm<kEmitL, false>())
      : mode == kEmitLI ? (emit_f ? emit_blocks_per_sm<kEmitLI, true>()
                                  : emit_blocks_per_sm<kEmitLI, false>())
                        : emit_blocks_per_sm<kCount, false>();
  return sms * (b1 < b3 ? b1 : b3);
}

// One fused match by the sweep instance (Q <= 32, W the power of two >= Q):
// pass 1, the carry pass and pass 3 in `mode`, on `stream`. T is the
// (256, W) byte table; text must be 16-byte aligned. The text's 128-byte
// tiles go tiles_per_chunk to a chunk, 256 / W chunks to a segment: nseg
// segments, whose count the caller passes as a check. seg_sum and seg_x
// hold nseg*3*Q ints, chunk_x nseg*3*256, L and I P+1 (with L + 1 and
// I + 1 16-byte aligned), F (emit_f, else null) P+1 bytes with F + 1
// 16-byte aligned, counts 2 zeroed by the caller; G gets 3*Q ints.
// Returns as schain_fused_tile.
int schain_fused_sweep(const uint8_t* text, const uint32_t* T,
                       const int* seed, int* seg_sum, int* seg_x,
                       int* chunk_x, int* L, int* I, uint8_t* F, int* G,
                       int* counts, int Q, int W, int P, int n, int start0,
                       int dead, int skip, int tiles_per_chunk, int nseg,
                       int mode, void* stream) {
  if (Q <= 0 || Q > kSweepMaxQ || W < Q || W > kSweepMaxQ || (W & (W - 1)) ||
      P <= 0 || n < 0 || n > P || tiles_per_chunk <= 0 || mode < kEmitL ||
      mode > kCount || dead >= Q || (skip && dead < 0) ||
      start0 < 0 || start0 >= Q || ((uintptr_t)text & 15) ||
      (mode != kCount && ((uintptr_t)(L + 1) & 15)) ||
      (mode == kEmitLI && ((uintptr_t)(I + 1) & 15)) ||
      (F && (mode == kCount || ((uintptr_t)(F + 1) & 15))))
    return (int)cudaErrorInvalidValue;
  const int ntiles = (P + kSweepTile - 1) / kSweepTile;
  const int nchunks = (ntiles + tiles_per_chunk - 1) / tiles_per_chunk;
  const int groups = kSweepThreads / W;
  if (nseg != (nchunks + groups - 1) / groups || nseg > kMaxSegments)
    return (int)cudaErrorInvalidValue;
  SweepParams p{text, T, seg_sum, seg_x, chunk_x, L, I, F, counts, Q, W, P,
                n, start0, dead, skip, ntiles, tiles_per_chunk};
  cudaStream_t s = (cudaStream_t)stream;
  sweep_summary_kernel<<<nseg, kSweepThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sweep_carry_kernel<<<1, 1024, 0, s>>>(seg_sum, seed, seg_x, G, Q, nseg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (mode == kEmitL)
    return (int)(F ? launch_sweep_emit<kEmitL, true>(p, nseg, s)
                   : launch_sweep_emit<kEmitL, false>(p, nseg, s));
  if (mode == kEmitLI)
    return (int)(F ? launch_sweep_emit<kEmitLI, true>(p, nseg, s)
                   : launch_sweep_emit<kEmitLI, false>(p, nseg, s));
  return (int)launch_sweep_emit<kCount, false>(p, nseg, s);
}

const char* schain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
