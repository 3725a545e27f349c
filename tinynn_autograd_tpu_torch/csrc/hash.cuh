// The dropout counter hash: one uint32 of random bits for each element of a
// tensor, from its row-major flat index and a seed. The single definition
// for the CUDA side: P1's pass (dropout.cu) and K2's Dropout (fused_epoch.cu)
// include it, so the two draw the same masks, and both equal the plain
// version in ops/dropout.py.
//
// It is the JAX package's `_hash_bits_u32` (tinynn_autograd_tpu/ops/
// primitives.py), the stand-in for the TPU core's generator when its
// megakernel runs in interpret mode: x = index + seed * 2654435761, then the
// murmur3 finalizer, all mod 2^32. An element is kept where its bits are
// below floor((1 - rate) * (2^32 - 1)), and scaled by 1 / (1 - rate).
//
// Seeds: a Net hands the Dropout layer at position idx among its layers that
// take a seed (t * 1000003 + idx) for the step whose optimizer counter is t
// before the update, in wrapping 32-bit arithmetic (nn/net.py); rank r of
// the data-parallel kernel takes t + 7919 r for t (rank_step).

#pragma once

#include <cstdint>

namespace tinynn {

constexpr uint32_t kSeedStride = 1000003u;  // seeds of one step's layers

__host__ __device__ __forceinline__ uint32_t hash_bits(uint32_t index,
                                                       uint32_t seed) {
  uint32_t x = index + seed * 2654435761u;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// The step a rank of the data-parallel kernel seeds its Dropouts with: the
// JAX megakernel adds axis_index * 7919 to the step (wrapping 32-bit).
constexpr uint32_t kRankSeedStride = 7919u;

__host__ __device__ __forceinline__ uint32_t rank_step(uint32_t t,
                                                       int rank) {
  return t + kRankSeedStride * static_cast<uint32_t>(rank);
}

// The seed of the Dropout at position `idx` in a step whose counter is `t`.
__host__ __device__ __forceinline__ uint32_t layer_seed(uint32_t t,
                                                        uint32_t idx) {
  return t * kSeedStride + idx;
}

__host__ __device__ __forceinline__ bool keeps(uint32_t index, uint32_t seed,
                                               uint32_t threshold) {
  return hash_bits(index, seed) < threshold;
}

}  // namespace tinynn
