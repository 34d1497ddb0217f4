// DFA L-array byte-stepping phases for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of rejit_tpu/kernels/dfa_pallas.py:
//   dfa_phase1  <- phase1_pallas (_p1_kernel): per-block (f, m, i) summaries
//   dfa_phase3  <- phase3_pallas (_p3_kernel): per-boundary (L, I) emission
// Same algebra and the same int32 interface (classes in, summaries out);
// rejit_tpu_torch/kernels/dfa_cuda.py holds the wrappers and the plain
// PyTorch versions the kernels are held against.
//
// The packed table entry is next*256 + (accept_pid + 1), Q*C int32 words.
// A step from state S on class c reads val = tab[S*C + c]; the step accepts
// pattern (val & 255) - 1 when that is >= 0 and moves to val >> 8. Steps at
// positions >= n change nothing; since positions only grow, a thread stops
// at the first such step.
//
// Layout: classes and start states arrive as (K, nb) int32, row k holding
// byte k of every text block, so the 32 lanes of a warp (32 neighbouring
// text blocks, same row) load 128 contiguous bytes. Each CUDA block stages
// the (K, 32) class tile of its 32 text blocks in shared memory once, keeps
// the table there too when it fits (tables past kSmemTableMax bytes are
// read through the read-only cache instead: the same kernel, a template
// flag), and stages its outputs in shared memory so that the stores to
// device memory are contiguous runs.
//
// Neither kernel carries anything across CUDA blocks, so block order does
// not matter (the TPU grid's sequential order is not needed here).
#include <cuda_runtime.h>

namespace {

constexpr int kTB = 32;                        // text blocks per CUDA block
constexpr int kP3Warps = 8;                    // warps of a phase-3 block
constexpr int kMaxQY = 8;                      // state rows of a phase-1 block
constexpr size_t kSmemTableMax = 48 * 1024;    // table bytes kept in smem
constexpr size_t kSmemLimit = 232448;          // 227 KB per block on sm_90
constexpr size_t kSmemDefault = 48 * 1024;     // above: opt-in attribute

template <bool kSmemTab>
__device__ __forceinline__ int table_at(const int* s_tab,
                                        const int* __restrict__ g_tab,
                                        int idx) {
  if (kSmemTab) return s_tab[idx];
  return __ldg(g_tab + idx);
}

// Load the table (when kSmemTab) and the (K, kTB) class tile of text
// blocks b0 .. b0+kTB-1; lanes past nb read class 0 (never stepped).
template <bool kSmemTab>
__device__ __forceinline__ void stage_inputs(
    const int* __restrict__ tab, const int* __restrict__ cls_kb, int* s_tab,
    int* s_cls, int QC, int K, int nb, int b0, int tid, int nthreads) {
  if (kSmemTab) {
    for (int x = tid; x < QC; x += nthreads) s_tab[x] = tab[x];
  }
  for (int x = tid; x < K * kTB; x += nthreads) {
    const int k = x / kTB;
    const int b = b0 + (x % kTB);
    s_cls[x] = b < nb ? __ldg(cls_kb + (long long)k * nb + b) : 0;
  }
}

// One thread per (text block b, start state q): lanes take neighbouring
// blocks for one q, threadIdx.y picks q within the CUDA block's QY rows.
// Outputs f, m, i are (nb, Q) int32.
template <bool kSmemTab>
__global__ void dfa_phase1_kernel(const int* __restrict__ tab,
                                  const int* __restrict__ cls_kb,
                                  int* __restrict__ f_out,
                                  int* __restrict__ m_out,
                                  int* __restrict__ i_out, int Q, int C,
                                  int K, int nb, int n) {
  extern __shared__ int smem[];
  const int QY = blockDim.y;
  int* s_cls = smem;                        // K * kTB
  int* s_out = s_cls + K * kTB;             // 3 * kTB * QY
  int* s_tab = s_out + 3 * kTB * QY;        // Q * C when kSmemTab
  const int lane = threadIdx.x;
  const int tid = threadIdx.y * kTB + lane;
  const int nthreads = kTB * QY;
  const int b0 = blockIdx.x * kTB;
  const int q0 = blockIdx.y * QY;

  stage_inputs<kSmemTab>(tab, cls_kb, s_tab, s_cls, Q * C, K, nb, b0, tid,
                         nthreads);
  __syncthreads();

  const int b = b0 + lane;
  const int q = q0 + threadIdx.y;
  if (b < nb && q < Q) {
    int S = q, m = -1, pid = -1;
    const int base = b * K;
    for (int k = 0; k < K; ++k) {
      const int pos = base + k;
      if (pos >= n) break;
      const int val = table_at<kSmemTab>(s_tab, tab, S * C + s_cls[k * kTB + lane]);
      const int acc = (val & 255) - 1;
      if (acc >= 0) {
        m = pos;
        pid = acc;
      }
      S = val >> 8;
    }
    const int o = lane * QY + threadIdx.y;
    s_out[o] = S;
    s_out[kTB * QY + o] = m;
    s_out[2 * kTB * QY + o] = pid;
  }
  __syncthreads();

  // The block's outputs are rows b0.. of QY consecutive columns q0..:
  // consecutive x are consecutive addresses within a row (one contiguous
  // run of kTB*Q words when the block holds every state).
  const int x = tid;
  const int bb = b0 + x / QY;
  const int qq = q0 + x % QY;
  if (bb < nb && qq < Q) {
    const long long g = (long long)bb * Q + qq;
    f_out[g] = s_out[x];
    m_out[g] = s_out[kTB * QY + x];
    i_out[g] = s_out[2 * kTB * QY + x];
  }
}

// One thread per boundary (text block b, in-block offset k): lanes take
// neighbouring blocks, the block's warps share the K offsets. Thread k runs
// bytes k..K-1 of its block from startsb[k, b] at position posbase[b] + k,
// then splices the block's exclusive suffix summary at its end state S by a
// direct index, m_suf[b, S] / i_suf[b, S] (the later match wins when
// m_suf >= 0). Outputs L, I are (nb*K,) int32 in boundary order b*K + k.
template <bool kSmemTab>
__global__ void dfa_phase3_kernel(const int* __restrict__ tab,
                                  const int* __restrict__ cls_kb,
                                  const int* __restrict__ startsb,
                                  const int* __restrict__ m_suf,
                                  const int* __restrict__ i_suf,
                                  const int* __restrict__ posbase,
                                  int* __restrict__ L_out,
                                  int* __restrict__ I_out, int Q, int C,
                                  int K, int nb, int n) {
  extern __shared__ int smem[];
  // Odd row stride: lanes write their rows of the output stage without
  // shared-memory bank conflicts.
  const int KP = (K & 1) ? K : K + 1;
  int* s_cls = smem;                        // K * kTB
  int* s_L = s_cls + K * kTB;               // kTB * KP
  int* s_I = s_L + kTB * KP;                // kTB * KP
  int* s_tab = s_I + kTB * KP;              // Q * C when kSmemTab
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int W = blockDim.y;
  const int tid = warp * kTB + lane;
  const int nthreads = kTB * W;
  const int b0 = blockIdx.x * kTB;

  stage_inputs<kSmemTab>(tab, cls_kb, s_tab, s_cls, Q * C, K, nb, b0, tid,
                         nthreads);
  __syncthreads();

  const int b = b0 + lane;
  if (b < nb) {
    const int base = posbase ? posbase[b] : b * K;
    // Thread row k does K-k steps; zig-zag the rows over the warps
    // (w, 2W-1-w, 2W+w, ...) so every warp gets about the same work.
    for (int r = 0; r * W < K; ++r) {
      const int k = r * W + ((r & 1) ? (W - 1 - warp) : warp);
      if (k >= K) continue;
      int S = __ldg(startsb + (long long)k * nb + b);
      int m = -1, pid = -1;
      for (int j = k; j < K; ++j) {
        const int pos = base + j;
        if (pos >= n) break;
        const int val = table_at<kSmemTab>(s_tab, tab, S * C + s_cls[j * kTB + lane]);
        const int acc = (val & 255) - 1;
        if (acc >= 0) {
          m = pos;
          pid = acc;
        }
        S = val >> 8;
      }
      const long long sq = (long long)b * Q + S;
      const int m_tail = __ldg(m_suf + sq);
      if (m_tail >= 0) {
        m = m_tail;
        pid = __ldg(i_suf + sq);
      }
      s_L[lane * KP + k] = m;
      s_I[lane * KP + k] = pid;
    }
  }
  __syncthreads();

  // Boundaries b0*K .. (b0+kTB)*K - 1 are one contiguous run of outputs.
  const int nvalid = min(kTB, nb - b0) * K;
  const long long out0 = (long long)b0 * K;
  for (int x = tid; x < nvalid; x += nthreads) {
    const int s = (x / K) * KP + (x % K);
    L_out[out0 + x] = s_L[s];
    I_out[out0 + x] = s_I[s];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// 1 when the launchers keep a Q-state, C-class table in shared memory,
// 0 when the kernels read it through the read-only cache.
int dfa_table_in_smem(int Q, int C) {
  return (size_t)Q * C * sizeof(int) <= kSmemTableMax;
}

// Each launcher returns cudaGetLastError() after the launch (0 = launched),
// or cudaErrorInvalidValue when a launch would need more shared memory than
// a CUDA block may have (a very large block size K).
int dfa_phase1(const int* tab, const int* cls_kb, int* f, int* m, int* i,
               int Q, int C, int K, int nb, int n, void* stream) {
  if (Q <= 0 || C <= 0 || K <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  const int QY = Q < kMaxQY ? Q : kMaxQY;
  const size_t other = (size_t)(K * kTB + 3 * kTB * QY) * sizeof(int);
  const bool smem_tab = dfa_table_in_smem(Q, C);
  const size_t bytes = other + (smem_tab ? (size_t)Q * C * sizeof(int) : 0);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  const dim3 block(kTB, QY);
  const dim3 grid((nb + kTB - 1) / kTB, (Q + QY - 1) / QY);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (smem_tab) {
    err = allow_smem(dfa_phase1_kernel<true>, bytes);
    if (err != cudaSuccess) return (int)err;
    dfa_phase1_kernel<true><<<grid, block, bytes, s>>>(tab, cls_kb, f, m, i, Q, C, K, nb, n);
  } else {
    err = allow_smem(dfa_phase1_kernel<false>, bytes);
    if (err != cudaSuccess) return (int)err;
    dfa_phase1_kernel<false><<<grid, block, bytes, s>>>(tab, cls_kb, f, m, i, Q, C, K, nb, n);
  }
  return (int)cudaGetLastError();
}

// posbase may be null: block b then starts at byte b*K.
int dfa_phase3(const int* tab, const int* cls_kb, const int* startsb,
               const int* m_suf, const int* i_suf, const int* posbase,
               int* L, int* I, int Q, int C, int K, int nb, int n,
               void* stream) {
  if (Q <= 0 || C <= 0 || K <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  const int KP = (K & 1) ? K : K + 1;
  const size_t other = (size_t)(K * kTB + 2 * kTB * KP) * sizeof(int);
  const bool smem_tab = dfa_table_in_smem(Q, C);
  const size_t bytes = other + (smem_tab ? (size_t)Q * C * sizeof(int) : 0);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  const dim3 block(kTB, kP3Warps);
  const dim3 grid((nb + kTB - 1) / kTB);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (smem_tab) {
    err = allow_smem(dfa_phase3_kernel<true>, bytes);
    if (err != cudaSuccess) return (int)err;
    dfa_phase3_kernel<true><<<grid, block, bytes, s>>>(
        tab, cls_kb, startsb, m_suf, i_suf, posbase, L, I, Q, C, K, nb, n);
  } else {
    err = allow_smem(dfa_phase3_kernel<false>, bytes);
    if (err != cudaSuccess) return (int)err;
    dfa_phase3_kernel<false><<<grid, block, bytes, s>>>(
        tab, cls_kb, startsb, m_suf, i_suf, posbase, L, I, Q, C, K, nb, n);
  }
  return (int)cudaGetLastError();
}

const char* dfa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
