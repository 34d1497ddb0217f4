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
// position >= n changes nothing.
//
// The TPU kernel ran its grid right to left on one core and carried the
// suffix across grid steps in SMEM. CUDA blocks run concurrently and in no
// order, so the carry is explicit, in three launches: each CUDA block
// summarises its segment of the text; one block composes the segment
// summaries right to left (schain_carry_kernel, a doubling scan seeded with
// `seed`) into each segment's exclusive suffix, and G; each CUDA block then
// walks its segment right to left from that suffix and emits L (and I) or
// counts. Two instances of the two segment passes:
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
// own shuffle. That is W independent steps per byte, where the tile
// instance takes 2*Q + (K+1)/2 dependent ones. The groups of a warp step
// in lockstep (whole-warp shuffles of width W). Text is read 16 bytes at a
// time; L values are stored 16 at a time.
//
// The tile instance (Q <= 256; schain_tile_kernel): per CUDA block, tiles
// of NB sub-blocks of K bytes, classes and start states staged in shared
// memory from the bytes (256-entry tables there too, with the whole Q*C
// table: C*Q <= 4096 words); one thread per (sub-block, state) runs its K
// bytes (phase 1); a doubling scan over the NB sub-blocks in shared memory
// gives each sub-block's exclusive suffix; one thread per boundary runs to
// its sub-block end and splices that suffix at its end state by a direct
// index (phase 3, as dfa_phase3).
//
// The fast-forward tile skip (the TPU's chunk skip, schain_pallas.py
// _kernel), in both instances: a tile wholly below n whose first byte
// sends every state to the dead state and whose other bytes are silent has
// the summary (dead, first-byte accept position, its pid) and L = -1
// everywhere but at its edge boundary. The emit pass takes it with no
// automaton steps when the carry's m at the dead state is -1, which makes
// the shortcut exact for any seed; the tile instance's summary pass takes
// it too, the sweep instance's pass 1 stops at the all-dead state instead.
//
// Bounds on an H100: the function reads 1 byte of text per text byte and
// writes 4 (L) or 8 (L and I) or nothing (count); it needs Q automaton
// steps per byte (the backward composition over the Q states). At the
// Config-3 sizes (Q = 6) the L modes are bounded by bytes, the count mode
// by operations. The sweep instance takes W steps per byte in pass 3, each
// one shared-memory load and one shuffle (three in L+I mode), and pass 1's
// steps until every state is dead; the shared-memory and shuffle pipe
// bounds it. Device-memory traffic beyond the
// text and the outputs: the (nseg, 3, Q) segment summaries and, for the
// sweep, 3 KB of chunk suffixes per segment.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // threads of a tile block
constexpr int kCarryThreads = 1024;     // threads of the carry block
constexpr int kSilent = 1;              // flags: class is silent
constexpr int kUniform = 2;             // flags: class sends all to dead
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemLimit = 232448;   // 227 KB per block on sm_90

enum Mode : int { kSummary = 0, kEmitL = 1, kEmitLI = 2, kCount = 3 };

struct Params {
  const uint8_t* text;   // (P,) padded text
  const int* tab;        // (Q*C,) next*256 + accept+1
  const int* class_of;   // (256,) byte -> class
  const int* start_of;   // (256,) start state of a boundary after byte b
  const int* flags;      // (256,) kSilent | kUniform per byte
  int* seg_sum;          // (nseg, 3, Q) segment summaries (pass 1 out)
  const int* seg_x;      // (nseg, 3, Q) segment exclusive suffixes (pass 3 in)
  int* L;                // (P+1,)
  int* I;                // (P+1,) in kEmitLI
  uint8_t* F;            // (P+1,) end states (emit_f), or null
  int* counts;           // [0] count, [1] tiles skipped by pass 3
  int Q, C, K, NB, P, n;
  int start0;            // start state at boundary 0 (the begin context)
  int dead;              // dead state (skip only)
  int skip;              // the FF tile skip is on
  int ntiles, tiles_per_seg;
};

// Shared-memory words of a tile block.
size_t tile_smem_words(int mode, int Q, int C, int K, int NB, bool emit_f) {
  const size_t NBP = NB + 1, KP = (K & 1) ? K : K + 1, NBQ = (size_t)NB * Q;
  size_t w = (size_t)Q * C + 3 * 256 + K * NBP + 9 * NBQ + 3 * Q;
  if (mode != kSummary) w += K * NBP;                 // start states
  if (mode == kEmitL || mode == kEmitLI) w += 2 * NB * KP;  // L/I stage
  if (emit_f && mode != kSummary) w += NB * KP;      // F stage
  return w;
}

// No __launch_bounds__: with __launch_bounds__(kThreads) ptxas held the
// L-mode instance to 48 registers and spilled 20 bytes; without it every
// instance takes 48-56 registers and spills nothing (sm_90a).
template <int kMode>
__global__ void schain_tile_kernel(Params p) {
  extern __shared__ int smem[];
  __shared__ int s_red[kThreads / 32];
  const int Q = p.Q, C = p.C, K = p.K, NB = p.NB;
  const int NBP = NB + 1;                 // odd row stride: no bank conflicts
  const int KP = (K & 1) ? K : K + 1;
  const int NBQ = NB * Q;
  constexpr bool kEmit = kMode != kSummary;
  constexpr bool kOut = kMode == kEmitL || kMode == kEmitLI;
  const bool emit_f = kOut && p.F != nullptr;

  int* s_tab = smem;                      // Q*C
  int* s_cls_of = s_tab + Q * C;          // 256
  int* s_start = s_cls_of + 256;          // 256
  int* s_flags = s_start + 256;           // 256
  int* s_cls = s_flags + 256;             // K*NBP, row k = byte k of each sub-block
  int* s_st = s_cls + K * NBP;            // K*NBP start states (emit)
  int* Sf = s_st + (kEmit ? K * NBP : 0); // NB*Q sub-block summaries [b*Q+q]
  int* Sm = Sf + NBQ;
  int* Si = Sm + NBQ;
  int* Xa = Si + NBQ;                     // 2 x 3 x NB*Q scan buffers
  int* Xb = Xa + 3 * NBQ;
  int* cf = Xb + 3 * NBQ;                 // carry: suffix right of the tile
  int* cm = cf + Q;
  int* ci = cm + Q;
  int* s_L = ci + Q;                      // NB*KP output stage (kOut)
  int* s_I = s_L + NB * KP;
  int* s_F = s_I + NB * KP;               // NB*KP end states (emit_f)

  const int tid = threadIdx.x;
  const int seg = blockIdx.x;
  for (int x = tid; x < Q * C; x += kThreads) s_tab[x] = p.tab[x];
  for (int x = tid; x < 256; x += kThreads) {
    s_cls_of[x] = p.class_of[x];
    s_start[x] = p.start_of[x];
    s_flags[x] = p.flags[x];
  }
  for (int q = tid; q < Q; q += kThreads) {
    if (kEmit) {
      const int* x = p.seg_x + (size_t)seg * 3 * Q;
      cf[q] = x[q];
      cm[q] = x[Q + q];
      ci[q] = x[2 * Q + q];
    } else {
      cf[q] = q;
      cm[q] = -1;
      ci[q] = -1;
    }
  }
  __syncthreads();

  const int nb = p.P / K;
  const int n = p.n;
  const int tile_bytes = NB * K;
  const int t_lo = seg * p.tiles_per_seg;
  const int t_hi = min(t_lo + p.tiles_per_seg, p.ntiles);
  int cnt = 0, skipped = 0;

  if (kEmit && seg == gridDim.x - 1 && tid == 0) {
    // Boundary P: the last segment's carry is the seed.
    const int st = s_start[p.text[p.P - 1]];
    const int m = n == p.P ? cm[st] : -1;
    if (kMode == kCount) {
      cnt += m >= 0;
    } else {
      p.L[p.P] = m;
      if (kMode == kEmitLI) p.I[p.P] = n == p.P ? ci[st] : -1;
      if (emit_f) p.F[p.P] = (uint8_t)cf[st];
    }
  }

  for (int t = t_hi - 1; t >= t_lo; --t) {
    const int base = t * tile_bytes;
    const int nbt = min(NB, nb - t * NB);   // sub-blocks in this tile
    const int nbytes = nbt * K;

    if (base >= n) {
      // Pad tile: identity maps, the carry is unchanged. Only boundary n
      // can hold a match here (an empty match at EOT, from the carry); a
      // boundary's end state is the carry's f at its start state.
      if (kEmit) {
        if (kOut) {
          for (int x = tid; x < nbytes; x += kThreads) {
            const int pos = base + x;
            p.L[pos] = -1;
            if (kMode == kEmitLI) p.I[pos] = -1;
            if (emit_f)
              p.F[pos] = (uint8_t)cf[pos == 0 ? p.start0
                                              : s_start[p.text[pos - 1]]];
          }
        }
        if (base == n && tid == 0) {
          const int st = base == 0 ? p.start0 : s_start[p.text[base - 1]];
          if (kMode == kCount) {
            cnt += cm[st] >= 0;
          } else {
            p.L[base] = cm[st];
            if (kMode == kEmitLI) p.I[base] = ci[st];
          }
        }
      }
      continue;
    }

    // Stage the tile's classes (and start states), and test the skip rule.
    int live = 0;
    for (int x = tid; x < tile_bytes; x += kThreads) {
      const int b = x / K;
      const int k = x - b * K;
      int c = 0, st = 0;
      if (b < nbt) {
        const int pos = base + x;
        const int byte = p.text[pos];
        c = s_cls_of[byte];
        if (kEmit) st = pos == 0 ? p.start0 : s_start[p.text[pos - 1]];
        live |= !(s_flags[byte] & (x == 0 ? kUniform : kSilent));
      }
      s_cls[k * NBP + b] = c;
      if (kEmit) s_st[k * NBP + b] = st;
    }
    const int any_live = __syncthreads_or(live);

    if (p.skip && !any_live && base + tile_bytes <= n &&
        (!kEmit || cm[p.dead] < 0)) {
      // Skip tile: summary (dead, base if the first byte accepts, pid).
      const int c0 = s_cls[0];
      int nf = 0, nm = -1, ni = -1;
      if (tid < Q) {
        const int a = (s_tab[tid * C + c0] & 255) - 1;
        const int d = p.dead;
        nf = cf[d];
        if (cm[d] >= 0) {
          nm = cm[d];
          ni = ci[d];
        } else {
          nm = a >= 0 ? base : -1;
          ni = a;
        }
      }
      if (kEmit) {
        if (kOut) {
          // Every boundary's thread is in the dead state after its first
          // byte: its end state is the carry's f at dead.
          for (int x = tid; x < nbytes; x += kThreads) {
            p.L[base + x] = -1;
            if (kMode == kEmitLI) p.I[base + x] = -1;
            if (emit_f) p.F[base + x] = (uint8_t)cf[p.dead];
          }
        }
        if (tid == 0) {
          const int a = (s_tab[s_st[0] * C + c0] & 255) - 1;
          if (kMode == kCount) {
            cnt += a >= 0;
          } else {
            p.L[base] = a >= 0 ? base : -1;
            if (kMode == kEmitLI) p.I[base] = a;
          }
        }
      }
      skipped += kEmit && tid == 0;
      __syncthreads();                      // every read of the old carry
      if (tid < Q) {
        cf[tid] = nf;
        cm[tid] = nm;
        ci[tid] = ni;
      }
      __syncthreads();
      continue;
    }

    // Phase 1: sub-block summaries from every state, lanes over sub-blocks.
    for (int w = tid; w < NBQ; w += kThreads) {
      const int b = w % NB;
      const int q = w / NB;
      int S = q, m = -1, i = -1;
      const int pb = base + b * K;
      const int kend = min(K, n - pb);
      for (int k = 0; k < kend; ++k) {
        const int val = s_tab[S * C + s_cls[k * NBP + b]];
        const int a = (val & 255) - 1;
        if (a >= 0) {
          m = pb + k;
          i = a;
        }
        S = val >> 8;
      }
      Sf[b * Q + q] = S;
      Sm[b * Q + q] = m;
      Si[b * Q + q] = i;
    }
    __syncthreads();

    // Exclusive suffixes X_b = S_{b+1} o ... o S_{NB-1} o carry: seed with
    // the next sub-block's summary (the carry after the last), then
    // X_b = X_b o X_{b+d} for d = 1, 2, 4, ... (Hillis-Steele).
    int* A = Xa;
    int* B = Xb;
    for (int w = tid; w < NBQ; w += kThreads) {
      const int b = w / Q;
      const int q = w - b * Q;
      if (b + 1 < NB) {
        A[w] = Sf[w + Q];
        A[NBQ + w] = Sm[w + Q];
        A[2 * NBQ + w] = Si[w + Q];
      } else {
        A[w] = cf[q];
        A[NBQ + w] = cm[q];
        A[2 * NBQ + w] = ci[q];
      }
    }
    __syncthreads();
    for (int d = 1; d < NB; d *= 2) {
      for (int w = tid; w < NBQ; w += kThreads) {
        const int b = w / Q;
        int f = A[w], m = A[NBQ + w], i = A[2 * NBQ + w];
        if (b + d < NB) {
          const int o = (b + d) * Q + f;
          const int mg = A[NBQ + o];
          if (mg >= 0) {
            m = mg;
            i = A[2 * NBQ + o];
          }
          f = A[o];
        }
        B[w] = f;
        B[NBQ + w] = m;
        B[2 * NBQ + w] = i;
      }
      __syncthreads();
      int* T = A;
      A = B;
      B = T;
    }
    const int* Xf = A;
    const int* Xm = A + NBQ;
    const int* Xi = A + 2 * NBQ;

    // Phase 3: one thread per boundary (row k of sub-block b) runs to its
    // sub-block end, then splices X_b at its end state.
    if (kEmit) {
      for (int w = tid; w < NB * K; w += kThreads) {
        const int k = w / NB;
        const int b = w - k * NB;
        if (b >= nbt) continue;
        const int pb = base + b * K;
        int m = -1, i = -1;
        int S = s_st[k * NBP + b];
        if (pb + k <= n) {
          const int jend = min(K, n - pb);
          for (int j = k; j < jend; ++j) {
            const int val = s_tab[S * C + s_cls[j * NBP + b]];
            const int a = (val & 255) - 1;
            if (a >= 0) {
              m = pb + j;
              i = a;
            }
            S = val >> 8;
          }
          const int o = b * Q + S;
          if (Xm[o] >= 0) {
            m = Xm[o];
            i = Xi[o];
          }
        }
        if (kMode == kCount) {
          cnt += m >= 0;
        } else {
          s_L[b * KP + k] = m;
          if (kMode == kEmitLI) s_I[b * KP + k] = i;
          if (emit_f) s_F[b * KP + k] = Xf[b * Q + S];
        }
      }
    }

    // The carry moves left past this tile: S_0 o X_0. The carry itself was
    // last read before the scan, so it is overwritten in place.
    if (tid < Q) {
      const int f0 = Sf[tid];
      const int mg = Xm[f0];
      cf[tid] = Xf[f0];
      cm[tid] = mg >= 0 ? mg : Sm[tid];
      ci[tid] = mg >= 0 ? Xi[f0] : Si[tid];
    }
    __syncthreads();

    if (kOut) {
      for (int x = tid; x < nbytes; x += kThreads) {
        const int so = (x / K) * KP + (x % K);
        p.L[base + x] = s_L[so];
        if (kMode == kEmitLI) p.I[base + x] = s_I[so];
        if (emit_f) p.F[base + x] = (uint8_t)s_F[so];
      }
    }
  }

  if (kMode == kSummary) {
    int* out = p.seg_sum + (size_t)seg * 3 * Q;
    for (int q = tid; q < Q; q += kThreads) {
      out[q] = cf[q];
      out[Q + q] = cm[q];
      out[2 * Q + q] = ci[q];
    }
  }
  if (kMode == kCount) {
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    if ((tid & 31) == 0) s_red[tid >> 5] = cnt;
    __syncthreads();
    if (tid == 0) {
      int total = 0;
      for (int w = 0; w < kThreads / 32; ++w) total += s_red[w];
      if (total) atomicAdd(p.counts, total);
    }
  }
  if (tid == 0 && skipped) atomicAdd(p.counts + 1, skipped);
}

// One block: X_j = S_{j+1} o ... o S_{nseg-1} o seed for every segment j
// (a doubling scan through two device buffers, ending in X), and
// G = S_0 o X_0. Layout (j, r, q): r = 0 f, 1 m, 2 i.
__global__ void __launch_bounds__(kCarryThreads) schain_carry_kernel(
    const int* __restrict__ seg_sum, const int* __restrict__ seed, int* X,
    int* Y, int* G, int Q, int nseg) {
  const int tid = threadIdx.x;
  const int NQ = nseg * Q;
  int levels = 0;
  for (int d = 1; d < nseg; d *= 2) ++levels;
  int* A = (levels & 1) ? Y : X;
  int* B = (levels & 1) ? X : Y;
  for (int w = tid; w < NQ; w += kCarryThreads) {
    const int j = w / Q;
    const int q = w - j * Q;
    const int* src = j + 1 < nseg ? seg_sum + (size_t)(j + 1) * 3 * Q : seed;
    int* dst = A + (size_t)j * 3 * Q;
    dst[q] = src[q];
    dst[Q + q] = src[Q + q];
    dst[2 * Q + q] = src[2 * Q + q];
  }
  __syncthreads();
  for (int d = 1; d < nseg; d *= 2) {
    for (int w = tid; w < NQ; w += kCarryThreads) {
      const int j = w / Q;
      const int q = w - j * Q;
      const int* a = A + (size_t)j * 3 * Q;
      int f = a[q], m = a[Q + q], i = a[2 * Q + q];
      if (j + d < nseg) {
        const int* b = A + (size_t)(j + d) * 3 * Q;
        if (b[Q + f] >= 0) {
          m = b[Q + f];
          i = b[2 * Q + f];
        }
        f = b[f];
      }
      int* o = B + (size_t)j * 3 * Q;
      o[q] = f;
      o[Q + q] = m;
      o[2 * Q + q] = i;
    }
    __syncthreads();
    int* T = A;
    A = B;
    B = T;
  }
  for (int q = tid; q < Q; q += kCarryThreads) {
    const int f0 = seg_sum[q];
    const int mg = A[Q + f0];
    G[q] = A[f0];
    G[Q + q] = mg >= 0 ? mg : seg_sum[Q + q];
    G[2 * Q + q] = mg >= 0 ? A[2 * Q + f0] : seg_sum[2 * Q + q];
  }
}

template <int kMode>
cudaError_t launch_tiles(const Params& p, int nseg, cudaStream_t s) {
  const size_t bytes =
      tile_smem_words(kMode, p.Q, p.C, p.K, p.NB, p.F != nullptr) *
      sizeof(int);
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  if (bytes > kSmemDefault) {
    cudaError_t err = cudaFuncSetAttribute(
        schain_tile_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  schain_tile_kernel<kMode><<<nseg, kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The sweep instance (Q <= 32)
// ---------------------------------------------------------------------------

constexpr int kSweepThreads = 256;      // threads of a sweep block
constexpr int kSweepTile = 128;         // bytes of a skip tile; chunks are whole tiles
constexpr int kSweepMaxQ = 32;
constexpr int kMaxSegments = 1024;

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

constexpr unsigned kFull = 0xffffffffu;

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

// Shared-memory bytes a tile block of this geometry needs in `mode`
// (0 summary, 1 L, 2 L and I, 3 count; emit_f: F staged too); above
// 232448 the launch refuses.
size_t schain_fused_smem_bytes(int mode, int Q, int C, int K, int NB,
                               int emit_f) {
  return tile_smem_words(mode, Q, C, K, NB, emit_f != 0) * sizeof(int);
}

// One fused match by the tile instance: pass 1, the carry pass, and pass 3
// in `mode` (1 L, 2 L and I, 3 count), on `stream`. seg_sum, seg_x and
// seg_y hold nseg*3*Q ints, L and I P+1 ints, F (emit_f: each boundary's
// end state; null for none, and in count mode) P+1 bytes, counts 2 ints
// zeroed by the caller; G gets 3*Q ints. start0 is boundary 0's start
// state. Returns cudaGetLastError() after the last launch (0 = launched),
// or the first launch's error, or cudaErrorInvalidValue for a geometry the
// kernels do not take.
int schain_fused_tile(const uint8_t* text, const int* tab, const int* class_of,
                      const int* start_of, const int* flags, const int* seed,
                      int* seg_sum, int* seg_x, int* seg_y, int* L, int* I,
                      uint8_t* F, int* G, int* counts, int Q, int C, int K,
                      int NB, int P, int n, int start0, int dead, int skip,
                      int tiles_per_seg, int mode, void* stream) {
  if (Q <= 0 || Q > kThreads || C <= 0 || K <= 0 || NB <= 0 ||
      (NB & (NB - 1)) || P <= 0 || P % K || n < 0 || n > P ||
      tiles_per_seg <= 0 || mode < kEmitL || mode > kCount ||
      (skip && (dead < 0 || dead >= Q)) || start0 < 0 || start0 >= Q ||
      (F && mode == kCount))
    return (int)cudaErrorInvalidValue;
  const int nb = P / K;
  const int ntiles = (nb + NB - 1) / NB;
  const int nseg = (ntiles + tiles_per_seg - 1) / tiles_per_seg;
  Params p{text, tab, class_of, start_of, flags, seg_sum, seg_x, L, I, F,
           counts, Q, C, K, NB, P, n, start0, skip ? dead : 0, skip, ntiles,
           tiles_per_seg};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_tiles<kSummary>(p, nseg, s);
  if (err != cudaSuccess) return (int)err;
  schain_carry_kernel<<<1, kCarryThreads, 0, s>>>(seg_sum, seed, seg_x, seg_y,
                                                  G, Q, nseg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (mode == kEmitL) return (int)launch_tiles<kEmitL>(p, nseg, s);
  if (mode == kEmitLI) return (int)launch_tiles<kEmitLI>(p, nseg, s);
  return (int)launch_tiles<kCount>(p, nseg, s);
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
