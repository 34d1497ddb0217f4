// The fused DFA match for Hopper (sm_90a): schain_fused.
//
// Replaces rejit_tpu/kernels/schain_pallas.py:call_fused (_kernel,
// _kernel_heavy): the whole DFA match of one padded uint8 text in one call,
// reading the text bytes themselves (no class or start-state arrays in
// device memory). For every boundary s <= n it gives L[s], the longest
// match end from s (-1 for none), and in the multi-pattern mode I[s], its
// pattern id; or, in the count mode, the number of boundaries with
// L >= 0. It also gives G, the whole text's (f, m, i) state-map summary
// composed with the caller's seed (the suffix beyond the text: the EOT
// accepts for a standalone text). rejit_tpu_torch/kernels/schain_cuda.py
// holds the wrapper and the plain PyTorch version the kernel is held
// against.
//
// The algebra is the split pipeline's (dfa_phases.cu): a summary maps each
// start state q to (f = end state, m = last accepting position, i = its
// pattern id); summaries compose associatively, the later match winning.
// The packed table entry is next*256 + (accept_pid + 1); a step at a
// position >= n changes nothing.
//
// The TPU kernel ran its grid right to left on one core and carried the
// suffix across grid steps in SMEM. CUDA blocks run concurrently and in no
// order, so the carry is explicit, in three launches:
//   1. schain_tile_kernel<kSummary>: each CUDA block owns a segment of
//      consecutive tiles and composes their summaries into the segment's;
//   2. schain_carry_kernel: one CUDA block composes the segment summaries
//      right to left (a doubling scan), seeded with `seed`, into each
//      segment's exclusive suffix, and G;
//   3. schain_tile_kernel<kEmit*|kCount>: each CUDA block walks its tiles
//      right to left from its segment's suffix and emits L (and I) or
//      counts.
// Inside a tile of NB sub-blocks of K bytes: classes and start states are
// staged in shared memory from the bytes (256-entry tables there too, with
// the whole Q*C table: C*Q <= 4096 words); one thread per (sub-block,
// state) runs its K bytes (phase 1); a doubling scan over the NB
// sub-blocks in shared memory gives each sub-block's exclusive suffix; one
// thread per boundary runs to its sub-block end and splices that suffix at
// its end state by a direct index (phase 3, as dfa_phase3).
//
// The fast-forward tile skip (the TPU's chunk skip, schain_pallas.py
// _kernel): a tile wholly below n whose first byte sends every state to
// the dead state and whose other bytes are silent has the summary
// (dead, first-byte accept position, its pid) and L = -1 everywhere but at
// its first boundary. Both passes take it with no automaton steps; the
// emit pass also needs the carry's m at the dead state to be -1, which
// makes the shortcut exact for any seed.
//
// Bounds on an H100: the function reads 1 byte of text per text byte and
// writes 4 (L) or 8 (L and I) or nothing (count); it needs Q automaton
// steps per byte (the backward composition over the Q states). At the
// Config-3 sizes (Q = 6) the L modes are bounded by bytes, the count mode
// by operations. This design takes 2*Q + (K+1)/2 steps per byte (phase 1
// in both passes, phase 3 in the emit pass) and no device-memory traffic
// beyond the text, the outputs and (nseg, 3, Q) segment summaries.
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
  int* L;                // (P,)
  int* I;                // (P,) in kEmitLI
  int* counts;           // [0] count, [1] tiles skipped by pass 3
  int Q, C, K, NB, P, n;
  int start0;            // start state at boundary 0 (the begin context)
  int dead;              // dead state (skip only)
  int skip;              // the FF tile skip is on
  int ntiles, tiles_per_seg;
};

// Shared-memory words of a tile block.
size_t tile_smem_words(int mode, int Q, int C, int K, int NB) {
  const size_t NBP = NB + 1, KP = (K & 1) ? K : K + 1, NBQ = (size_t)NB * Q;
  size_t w = (size_t)Q * C + 3 * 256 + K * NBP + 9 * NBQ + 3 * Q;
  if (mode != kSummary) w += K * NBP;                 // start states
  if (mode == kEmitL || mode == kEmitLI) w += 2 * NB * KP;  // L/I stage
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

  for (int t = t_hi - 1; t >= t_lo; --t) {
    const int base = t * tile_bytes;
    const int nbt = min(NB, nb - t * NB);   // sub-blocks in this tile
    const int nbytes = nbt * K;

    if (base >= n) {
      // Pad tile: identity maps, the carry is unchanged. Only boundary n
      // can hold a match here (an empty match at EOT, from the carry).
      if (kEmit) {
        if (kOut) {
          for (int x = tid; x < nbytes; x += kThreads) {
            p.L[base + x] = -1;
            if (kMode == kEmitLI) p.I[base + x] = -1;
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
          for (int x = tid; x < nbytes; x += kThreads) {
            p.L[base + x] = -1;
            if (kMode == kEmitLI) p.I[base + x] = -1;
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
        if (pb + k <= n) {
          int S = s_st[k * NBP + b];
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
  const size_t bytes = tile_smem_words(kMode, p.Q, p.C, p.K, p.NB) * sizeof(int);
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

}  // namespace

extern "C" {

// Shared-memory bytes a tile block of this geometry needs in `mode`
// (0 summary, 1 L, 2 L and I, 3 count); above 232448 the launch refuses.
size_t schain_fused_smem_bytes(int mode, int Q, int C, int K, int NB) {
  return tile_smem_words(mode, Q, C, K, NB) * sizeof(int);
}

// One fused match: pass 1, the carry pass, and pass 3 in `mode` (1 L,
// 2 L and I, 3 count), on `stream`. seg_sum, seg_x and seg_y hold
// nseg*3*Q ints, counts 2 ints zeroed by the caller; G gets 3*Q ints.
// Returns cudaGetLastError() after the last launch (0 = launched), or the
// first launch's error, or cudaErrorInvalidValue for a geometry the
// kernels do not take.
int schain_fused(const uint8_t* text, const int* tab, const int* class_of,
                 const int* start_of, const int* flags, const int* seed,
                 int* seg_sum, int* seg_x, int* seg_y, int* L, int* I, int* G,
                 int* counts, int Q, int C, int K, int NB, int P, int n,
                 int start0, int dead, int skip, int tiles_per_seg, int mode,
                 void* stream) {
  if (Q <= 0 || Q > kThreads || C <= 0 || K <= 0 || NB <= 0 ||
      (NB & (NB - 1)) || P <= 0 || P % K || n < 0 || n > P ||
      tiles_per_seg <= 0 || mode < kEmitL || mode > kCount ||
      (skip && (dead < 0 || dead >= Q)))
    return (int)cudaErrorInvalidValue;
  const int nb = P / K;
  const int ntiles = (nb + NB - 1) / NB;
  const int nseg = (ntiles + tiles_per_seg - 1) / tiles_per_seg;
  Params p{text, tab, class_of, start_of, flags, seg_sum, seg_x, L, I, counts,
           Q, C, K, NB, P, n, start0, skip ? dead : 0, skip, ntiles,
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

const char* schain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
