// The 3xTF32 split of an f32 value into TF32 parts, shared by the
// attention kernels (attention.cu) and K1's tensor-core tile (matmul.cu).
// `ops/tf32.py` is the same split on the CPU, bit for bit.

#pragma once

namespace tinynn {

// f32 -> TF32 as the CPU emulation's `split_tf32` does it: hi rounded to
// nearest, ties away from zero, on the 13 dropped mantissa bits (an
// integer add of half their range, then a mask); lo the remainder x - hi
// (exact in f32) cut to TF32 by the same mask, towards zero. hi + lo holds
// x to within 2^-21 of |x|.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xFFFFE000u;
}

}  // namespace tinynn
