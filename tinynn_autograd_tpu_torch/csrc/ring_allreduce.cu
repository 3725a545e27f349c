// The ring all-reduce alone (P3), for Hopper (sm_90a): n ranks that share
// the card, each a group of blocks of one cooperative launch, sum their
// buffers round a ring through two comm slots each, with a neighbour
// barrier every hop.
//
// Replaces `allreduce` (tests/test_dp_megakernel.py:60; its kernel
// `ring_kernel` :36, pallas_call :61): an n-device all-reduce of [8, 128]
// f32 through 2-slot VMEM comm buffers and remote DMA, which the JAX
// package runs on a simulated 8-device mesh. The device code is
// csrc/ring.cuh, shared with K6 (the ring phase of csrc/fused_epoch.cu):
// rank r's output is its input plus the left's, plus the one before, ...,
// in that order, as the TPU kernel sums it.
//
// What bounds it: the function reads each rank's input and writes its
// output once, 8 x n x len bytes: 1.8 us at 3.35 TB/s for 4 ranks of the
// flagship's 186,610 gradient floats. The naive ring moves more: each of
// the n - 1 hops copies the rank's whole buffer to its neighbour and adds
// what arrived (five passes over len floats a hop), with two cross-block
// handshakes. For buffers that small the handshakes, not the bytes, are
// expected to set the time.

#include <cuda_runtime.h>

#include <cstdint>

#include "ring.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_RANKS = 16;
constexpr int ELEMENTS_PER_THREAD = 8;  // the blocks a rank takes: enough
                                        // for 8 floats a thread

struct Args {
  const float* x[MAX_RANKS];  // each rank's input [len]
  float* out[MAX_RANKS];      // each rank's output [len]
  unsigned* sync;
  tinynn::Ring ring;
  int n_ranks, blocks;
};

__global__ void __launch_bounds__(THREADS)
ring_allreduce_kernel(const __grid_constant__ Args a) {
  tinynn::Group g = tinynn::group_of(a.sync, a.n_ranks, a.blocks);
  const float* x = a.x[g.rank];
  float* out = a.out[g.rank];
  tinynn::copy_pass(
      out, x, static_cast<long long>(g.block) * blockDim.x + threadIdx.x,
      static_cast<long long>(g.blocks) * blockDim.x, a.ring.len);
  tinynn::ring_all_reduce(a.ring, g, out, 1.0f);
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

}  // namespace

// Sums `n_ranks` buffers of `len` floats round the ring: outs[r] := xs[r] +
// xs[r-1] + ... in that order. `comm` is a scratch of n_ranks * 2 * len
// floats, `sync` n_ranks * 4 zeroed counts. `skew_rank` (-1: none) holds
// that rank back `skew_ns` before its first hop (a check of the flow
// control). Launches on `stream` and does not synchronise. Returns the CUDA
// error of the launch (0 when it was accepted).
extern "C" int tinynn_ring_all_reduce(int n_ranks, const float* const* xs,
                                      float* const* outs, long long len,
                                      float* comm, unsigned* sync,
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
  for (int r = 0; r < n_ranks; ++r) {
    a.x[r] = xs[r];
    a.out[r] = outs[r];
  }
  a.sync = sync;
  a.ring = {comm, len, skew_rank, skew_ns};
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
