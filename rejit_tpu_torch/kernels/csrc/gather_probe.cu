// The gather probe for Hopper (sm_90a): a serially dependent chain of
// shared-memory table lookups against the same chain built from
// compare-selects in registers.
//
// Replaces bench/gather_probe.py:main (its pallas_call kernel, :71-111),
// which timed in-VMEM lane gathers (take_along_axis on an (8, 128) tile)
// against a QS-term select chain on the TPU. On this card the same question
// is "shared-memory lookup against a register select chain", the choice an
// automaton's byte step makes (schain_fused's tile instance, the posnfa
// OR network). Bit for bit the kernel computes what the TPU kernel does, on
// one (8, 128) tile per block:
//   - thread (r, l) owns element (r, l) of the U chains and starts each at
//     clip(Y[8u + r][l] + (n & 1), 0, 127);
//   - serial: ITERS times, y = T[r][y] for every chain, T (4 KB) staged in
//     shared memory (the Hopper form of the in-VMEM lane gather);
//   - select: ITERS times, for q = 0..QS-1 in order,
//     y = (y == q) ? (7q + 3) % 128 : y, in registers;
//   - the XOR of the U chains is the block's (8, 128) output.
// Every step depends on the one before (the probe's regime assumption); the
// U chains are independent, which is the latency hiding the TPU probe had.
// `replicas` blocks run the same tile: one block is the TPU's single-core
// call, a grid of every SM's resident blocks reads the card's rate.
//
// What bounds it: the serial chain issues one 32-bit shared-memory load
// (LDS) and one address instruction a step; an SM issues 32 LDS lanes a
// clock, a quarter of its 128 integer lanes, so the loads bound it. The
// select chain spends a compare and a select a term on the integer lanes.
// rejit_tpu_torch/kernels/probe_cuda.py holds the wrapper and the plain
// PyTorch version the kernel is held against.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;
constexpr int kLanes = 128;
constexpr int kTile = kRows * kLanes;   // one thread an element
constexpr int kMaxU = 16;
constexpr int kBadArgs = 10001;

template <int U, bool kSelect>
__global__ void __launch_bounds__(kTile)
gather_probe_kernel(const int* __restrict__ T, const int* __restrict__ Y,
                    int n, int iters, int qs, int* __restrict__ out) {
  __shared__ int t_s[kTile];
  const int tid = threadIdx.x;
  t_s[tid] = T[tid];
  __syncthreads();
  const int* row = t_s + (tid / kLanes) * kLanes;
  const int inc = n & 1;
  int y[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    y[u] = min(max(Y[u * kTile + tid] + inc, 0), kLanes - 1);
  if (!kSelect) {
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int u = 0; u < U; ++u) y[u] = row[y[u]];
    }
  } else {
    for (int it = 0; it < iters; ++it) {
      int c = 3;   // (7q + 3) % 128 at q = 0
#pragma unroll 8
      for (int q = 0; q < qs; ++q) {
#pragma unroll
        for (int u = 0; u < U; ++u) y[u] = (y[u] == q) ? c : y[u];
        c = (c + 7) & (kLanes - 1);
      }
    }
  }
  int acc = y[0];
#pragma unroll
  for (int u = 1; u < U; ++u) acc ^= y[u];
  out[blockIdx.x * kTile + tid] = acc;
}

template <int U>
const void* kernel_for(int mode) {
  return mode ? (const void*)gather_probe_kernel<U, true>
              : (const void*)gather_probe_kernel<U, false>;
}

const void* kernel_of(int mode, int u) {
  switch (u) {
#define CASE(N) \
  case N:       \
    return kernel_for<N>(mode);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
  }
  return nullptr;
}

}  // namespace

extern "C" {

// out: (replicas, 8, 128) int32. T: (8, 128) int32 permutation rows; Y:
// (8u, 128) int32; mode 0 = serial, 1 = select. Returns a cudaError_t, or
// kBadArgs for arguments the kernel does not take.
int gather_probe(const int* T, const int* Y, int n, int iters, int mode,
                 int qs, int u, int replicas, int* out, cudaStream_t stream) {
  const void* k = kernel_of(mode, u);
  if (k == nullptr || (mode != 0 && mode != 1) || iters < 0 || qs < 0 ||
      replicas < 1)
    return kBadArgs;
  void* args[] = {(void*)&T, (void*)&Y, (void*)&n, (void*)&iters,
                  (void*)&qs, (void*)&out};
  cudaLaunchKernel(k, dim3(replicas), dim3(kTile), args, 0, stream);
  return (int)cudaGetLastError();
}

// Blocks of this instance resident on one SM at once (the whole card's
// grid is this times the SM count); 0 for arguments not taken.
int gather_probe_blocks_per_sm(int mode, int u) {
  const void* k = kernel_of(mode, u);
  int blocks = 0;
  if (k == nullptr ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kTile, 0))
    return 0;
  return blocks;
}

int gather_probe_max_u() { return kMaxU; }

const char* gather_probe_error_string(int err) {
  if (err == kBadArgs) return "arguments not taken by the kernel";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
