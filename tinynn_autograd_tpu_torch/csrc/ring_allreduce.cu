// The ring all-reduce alone (P3), for Hopper (sm_90a): n ranks that share
// the card, each a group of blocks of one cooperative launch, each sum the
// n buffers in the ring's order, through one exchange (csrc/ring.cuh): one
// all-rank arrival, then one pass that reads the inputs where they lie and
// writes each rank's output once.
//
// Replaces `allreduce` (tests/test_dp_megakernel.py:60; its kernel
// `ring_kernel` :36, pallas_call :61): an n-device all-reduce of [8, 128]
// f32 through 2-slot VMEM comm buffers and remote DMA, which the JAX
// package runs on a simulated 8-device mesh. The device code is
// csrc/ring.cuh, shared with K6 (the exchange phase of
// csrc/fused_epoch.cu): rank r's output is its input plus the left's, plus
// the one before, ..., in that order, as the TPU kernel's hops sum it.
//
// What bounds it: the function reads each rank's input and writes its
// output once, 8 x n x len bytes: 1.8 us at 3.35 TB/s for 4 ranks of the
// flagship's 186,610 gradient floats. The pass reads every input once a
// rank (from L2 after the first), and the arrival costs a signal and n
// polls a block; for buffers this small the launch and the arrival, not
// the bytes, are expected to set the time. The counts persist across
// calls (the wrapper passes their value), so a call is one launch; a rank
// signals once a call, from its first block.
//
// The inputs are complete before the launch (stream order), so here the
// arrival orders nothing: it is kept because P3 is the probe of K6's
// exchange, and times and checks (with one rank held back) the protocol
// K6 runs each step.

#include <cuda_runtime.h>

#include <cstdint>

#include "ring.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_RANKS = 16;
constexpr int ELEMENTS_PER_THREAD = 16;  // the blocks a rank takes: enough
                                         // for 16 floats a thread

struct Args {
  const float* x[MAX_RANKS];  // each rank's input [len]
  float* out[MAX_RANKS];      // each rank's output [len]
  unsigned* sync;
  unsigned published[MAX_RANKS];  // each rank's count before the launch
  long long len;
  tinynn::Skew skew;
  int n_ranks, blocks, vec;
};

__global__ void __launch_bounds__(THREADS)
ring_allreduce_kernel(const __grid_constant__ Args a) {
  tinynn::Group g = tinynn::group_of(a.sync, a.n_ranks, a.blocks);
  // the inputs were written before the launch: a rank publishes them once
  tinynn::exchange_arrive(g, a.skew, a.published, false);
  tinynn::exchange_pass(
      g, [&](int q) { return a.x[q]; }, a.out[g.rank], a.len, a.vec != 0,
      false, 1.0f);
}

// The blocks each rank takes for `len` floats over `n_ranks` ranks: at most
// the co-resident blocks divided among the ranks.
int ring_grid(int n_ranks, long long len, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ring_allreduce_kernel, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want =
      (len + THREADS * ELEMENTS_PER_THREAD - 1) / (THREADS * ELEMENTS_PER_THREAD);
  const long long most = static_cast<long long>(per_sm) * sms / n_ranks;
  *blocks = static_cast<int>(want < most ? (want > 0 ? want : 1) : most);
  return 0;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Sums `n_ranks` buffers of `len` floats in the ring's order: outs[r] :=
// xs[r] + xs[r-1] + ... in that order. `sync` holds n_ranks * 2 counts,
// rank r's `kPublished` count at `published[r]` (zero them once; then a
// call adds 1 to the count of each of its ranks; calls that share `sync`
// must run one at a time, as calls queued on one stream do; the counts
// wrap modulo 2^32). `skew_rank` (-1: none) holds that rank back `skew_ns`
// before its arrival (a check of the flow control). Launches on `stream`
// and does not synchronise. Returns the CUDA error of the launch (0 when
// it was accepted).
extern "C" int tinynn_ring_all_reduce(int n_ranks, const float* const* xs,
                                      float* const* outs, long long len,
                                      unsigned* sync,
                                      const unsigned* published,
                                      int skew_rank, long long skew_ns,
                                      void* stream) {
  if (n_ranks < 1 || n_ranks > MAX_RANKS || len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  Args a = {};
  a.vec = 1;
  for (int r = 0; r < n_ranks; ++r) {
    a.x[r] = xs[r];
    a.out[r] = outs[r];
    if (!aligned16(xs[r]) || !aligned16(outs[r])) a.vec = 0;
  }
  a.sync = sync;
  for (int r = 0; r < n_ranks; ++r) a.published[r] = published[r];
  a.len = len;
  a.skew = {skew_rank, skew_ns};
  a.n_ranks = n_ranks;
  const int grid_err = ring_grid(n_ranks, len, &a.blocks);
  if (grid_err != 0) return grid_err;
  if (a.blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ring_allreduce_kernel),
      dim3(a.blocks * n_ranks), dim3(THREADS), params, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
