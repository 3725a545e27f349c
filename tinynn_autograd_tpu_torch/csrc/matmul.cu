// Tiled matrix product for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N].
//
// Replaces the TPU kernel `_mm_kernel`, launched by `pallas_matmul`
// (tinynn_autograd_tpu/ops/kernels.py). That kernel zero-pads every operand
// to multiples of 128 and walks a (M/bm, N/bn, K/bk) grid whose k axis runs
// in order on one core, carrying an f32 accumulator in VMEM. Here blocks run
// in parallel and in no order, so each block owns one 64x64 output tile and
// loops over K itself, keeping its f32 accumulators in registers.
//
// It computes what `_mm_kernel` computes, not how:
// - f32 operands are multiplied in full f32 with FMA on the CUDA cores, never
//   in TF32; bf16 operands are widened with __bfloat162float and summed in
//   f32. The result is stored in promote(a, b): f32, or bf16 when both
//   operands are bf16 (rounded once, as `o_ref[:] = acc.astype(...)` does).
// - Ragged edges are masked (out-of-range loads read 0, stores are skipped)
//   instead of copying zero-padded operands as the TPU path does.
// - Each operand comes with a row and a column stride, so the transposed
//   views the tape's matmul VJP passes (grad @ B^T and A^T @ grad) are read in
//   place, with no copy to a contiguous layout.
//
// What bounds it on this card: at the flagship MLP's shapes a train-step
// product is at most [128,784] @ [784,200], about 20 million multiply-adds.
// At the H100's 67 TFLOP/s of f32 FMA that is under a microsecond, below the
// few microseconds a launch costs, so launch latency and not FLOPs bounds a
// train step's 14 launches. The design does nothing about that yet: it is the
// simple, right first version (shared-memory tiles, a 4x4 register tile per
// thread). Tensor cores (wgmma), TMA and fewer launches are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;  // output rows per block
constexpr int BN = 64;  // output columns per block
constexpr int BK = 16;  // depth of one shared-memory stage
constexpr int TM = 4;   // output rows per thread
constexpr int TN = 4;   // output columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;  // keeps rows 16-byte aligned and spreads banks

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
              TC* __restrict__ c, int m, int n, int k, long long sa_m,
              long long sa_k, long long sb_k, long long sb_n) {
  // Both tiles are stored k-major, so a thread reads its TM rows of A and
  // its TN columns of B for one k as one float4 each.
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  // Walk each tile along its operand's unit stride, so that neighbouring
  // threads load neighbouring addresses whichever way the view is laid out.
  const bool a_k_unit = (sa_k == 1);
  const bool b_n_unit = (sb_n == 1);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int it = 0; it < (BM * BK) / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int r = a_k_unit ? idx / BK : idx % BM;
      const int kk = a_k_unit ? idx % BK : idx / BM;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gr < m && gk < k) ? to_f32(a[gr * sa_m + gk * sa_k]) : 0.0f;
    }
#pragma unroll
    for (int it = 0; it < (BK * BN) / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int cc = b_n_unit ? idx % BN : idx / BK;
      const int kk = b_n_unit ? idx / BN : idx % BK;
      const int gk = k0 + kk;
      const int gc = col0 + cc;
      Bs[kk][cc] = (gk < k && gc < n) ? to_f32(b[gk * sb_k + gc * sb_n]) : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float ar[TM] = {av.x, av.y, av.z, av.w};
      const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc < n) store(c + static_cast<long long>(gr) * n + gc, acc[i][j]);
    }
  }
}

template <typename TA, typename TB, typename TC>
void launch(const void* a, const void* b, void* c, int m, int n, int k,
            int sa_m, int sa_k, int sb_k, int sb_n, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  matmul_kernel<TA, TB, TC><<<grid, THREADS, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b),
      static_cast<TC*>(c), m, n, k, sa_m, sa_k, sb_k, sb_n);
}

}  // namespace

// C (contiguous [m, n]) = A @ B, with A and B given by pointer and element
// strides. Launches on `stream` and does not synchronise. Returns the CUDA
// error of the launch (0 when it was accepted).
extern "C" int tinynn_matmul(const void* a, const void* b, void* c, int m,
                             int n, int k, int sa_m, int sa_k, int sb_k,
                             int sb_n, int a_dtype, int b_dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == kF32 && b_dtype == kF32) {
    launch<float, float, float>(a, b, c, m, n, k, sa_m, sa_k, sb_k, sb_n, s);
  } else if (a_dtype == kBF16 && b_dtype == kBF16) {
    launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        a, b, c, m, n, k, sa_m, sa_k, sb_k, sb_n, s);
  } else if (a_dtype == kF32 && b_dtype == kBF16) {
    launch<float, __nv_bfloat16, float>(a, b, c, m, n, k, sa_m, sa_k, sb_k,
                                        sb_n, s);
  } else if (a_dtype == kBF16 && b_dtype == kF32) {
    launch<__nv_bfloat16, float, float>(a, b, c, m, n, k, sa_m, sa_k, sb_k,
                                        sb_n, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
