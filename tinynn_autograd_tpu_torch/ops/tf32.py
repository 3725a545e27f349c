"""TF32 rounding and the 3xTF32 product in plain PyTorch: the arithmetic of
the tensor-core products of the attention kernels (``csrc/attention.cu``:
the forward and the backward pair) and of K1's tensor-core tile
(``csrc/matmul.cu``, configuration 4; the split is ``csrc/tf32.cuh``'s),
so that the CPU tests can hold it.

A TF32 value is an f32 whose 13 lowest mantissa bits are zero (10 explicit
bits of mantissa, f32's exponent). The kernels split each f32 operand x into
``hi = round_tf32(x)`` and ``lo = truncate_tf32(x - hi)`` (x - hi is exact in
f32), and form a product a b as lo_a hi_b + hi_a lo_b + hi_a hi_b with TF32
tensor-core products and f32 sums: CUTLASS's ``OpMultiplyAddFastF32``
scheme ("3xTF32"). The dropped lo_a lo_b term is about 2^-22 of the
product. ``matmul_3xtf32`` sums the small terms apart from the large one,
as the kernels' score products do; the kernels' order of sums on the tensor
cores is their own. Plain TF32 (one term, ``matmul_tf32``) keeps about
three decimal digits.

Nothing on the main path calls these: the kernels do this arithmetic on the
card, and the plain versions of the kernels (``attention.py``,
``kernels.matmul_reference``) compute in f32. The tests use them to check
the kernels' scheme against float64 and the JAX package.
"""

import torch

_HALF = 0x1000         # half the range of the 13 dropped bits
_KEEP = 0xFFFFE000     # the sign, the exponent and 10 mantissa bits
_M32 = 0xFFFFFFFF


def _bits(x):
    """The f32 tensor's bit patterns as int64 in [0, 2**32)."""
    return x.contiguous().view(torch.int32).to(torch.int64) & _M32


def _from_bits(bits):
    """f32 tensor from int64 bit patterns in [0, 2**32)."""
    signed = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return signed.to(torch.int32).view(torch.float32)


def round_tf32(x):
    """``x`` (f32) rounded to TF32: to nearest, ties away from zero, on the
    13 dropped mantissa bits, bit for bit as the kernels round (an integer
    add of half the dropped range to the bits, then a mask). A carry moves
    into the exponent as IEEE rounding does: the largest finite values round
    to inf, the largest subnormals to the smallest normal. +-0, inf keep
    their bits; NaN stays NaN."""
    x = x.to(torch.float32)
    out = _from_bits((_bits(x) + _HALF) & _KEEP)
    return torch.where(torch.isnan(x), x, out)


def truncate_tf32(x):
    """``x`` (f32) cut to TF32 towards zero: its 13 lowest mantissa bits
    cleared."""
    return _from_bits(_bits(x.to(torch.float32)) & _KEEP)


def split_tf32(x):
    """(hi, lo), both TF32, as the kernels split an operand: hi the nearest
    TF32 value, lo the remainder x - hi cut to TF32 towards zero. hi + lo
    holds a finite x to within 2^-21 of |x| (the cut's 11th significant
    bit of lo)."""
    x = x.to(torch.float32)
    hi = round_tf32(x)
    return hi, truncate_tf32(x - hi)


def matmul_tf32(a, b):
    """a @ b from TF32-rounded operands with f32 sums: one TF32 product, as
    the tensor cores form it with TF32 allowed."""
    return torch.matmul(round_tf32(a), round_tf32(b))


def matmul_3xtf32(a, b):
    """a @ b in 3xTF32: lo_a hi_b + hi_a lo_b summed apart, then hi_a hi_b
    added, each a product of TF32 values with f32 sums (``torch.matmul`` in
    f32). a [..., m, k], b [..., k, n] f32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    small = torch.matmul(al, bh) + torch.matmul(ah, bl)
    return torch.matmul(ah, bh) + small
