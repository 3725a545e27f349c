// The dropout pass for Hopper (sm_90a), P1: out = x * scale where the counter
// hash keeps an element, else 0, plus a uint8 keep mask for the VJP, for any
// contiguous f32 tensor of up to 2^32 elements. It is ops.dropout_'s forward
// for CUDA tensors: two launches a step of the flagship with two Dropout
// layers, three a TransformerBlock with residual and tape-attention dropout.
//
// Replaces the TPU kernel `kernel` inside `check_pltpu_dropout_stats`
// (tpu_check.py:30), which applies the JAX package's dropout_ to a tile of
// ones with the TPU core's generator. Here the bits come from the counter
// hash of csrc/hash.cuh, the JAX package's interpret-mode stand-in, which
// K2 includes too: one definition of the masks on the card.
//
// How the TPU design translates: a Pallas block of the whole tile becomes a
// grid-stride loop of one element a thread and an iteration, so that
// neighbouring threads read and write neighbouring addresses. Each element's
// bits depend only on its flat index and the seed, so blocks need no order.
//
// What bounds it: it reads 4 bytes and writes 5 for each element (the value
// and the mask) and does a few integer operations: bytes-bound. At a 6b
// residual site, [4, 2048, 512], that is 37.7 MB, 11.3 us at 3.35 TB/s.
// Vector loads and a packed bit mask are later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
dropout_kernel(const float* __restrict__ x, float* __restrict__ out,
               uint8_t* __restrict__ mask, unsigned long long n,
               uint32_t seed, uint32_t threshold, float scale) {
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i =
           static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
           threadIdx.x;
       i < n; i += stride) {
    const bool keep =
        tinynn::keeps(static_cast<uint32_t>(i), seed, threshold);
    out[i] = keep ? __fmul_rn(x[i], scale) : 0.0f;
    mask[i] = keep ? 1 : 0;
  }
}

}  // namespace

// out[i] = x[i] * scale where hash_bits(i, seed) < threshold, else 0, and
// mask[i] = 1 where kept, else 0, for the `n` elements (n <= 2^32). Launches
// on `stream` and does not synchronise. Returns the CUDA error of the launch
// (0 when it was accepted).
extern "C" int tinynn_dropout(const float* x, float* out, uint8_t* mask,
                              unsigned long long n, unsigned int seed,
                              unsigned int threshold, float scale,
                              void* stream) {
  if (n == 0 || n > (1ull << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // enough blocks for every SM to hold several, no more than the elements
  const unsigned long long want = (n + THREADS - 1) / THREADS;
  const unsigned long long cap = 16ull * sms;
  const unsigned int blocks =
      static_cast<unsigned int>(want < cap ? want : cap);
  dropout_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, mask, n, seed, threshold, scale);
  return static_cast<int>(cudaGetLastError());
}
