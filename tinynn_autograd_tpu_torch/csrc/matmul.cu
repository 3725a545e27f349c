// Tiled matrix product for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N].
//
// Replaces the TPU kernel `_mm_kernel`, launched by `pallas_matmul`
// (tinynn_autograd_tpu/ops/kernels.py). That kernel zero-pads every operand
// to multiples of 128 and walks a (M/bm, N/bn, K/bk) grid whose k axis runs
// in order on one core, carrying an f32 accumulator in VMEM. Here blocks run
// in parallel and in no order: each block owns one output tile, or one
// slice of K of one output tile, and keeps its f32 sums in registers.
//
// It computes what `_mm_kernel` computes, not how:
// - f32 operands are multiplied to f32 accuracy, never in plain TF32: on
//   the CUDA cores with FMA (configurations 0-3), or on the tensor cores in
//   3xTF32 (configuration 4, below); bf16 operands are widened with
//   __bfloat162float and summed in f32 on the CUDA cores. The result is
//   stored in promote(a, b): f32, or bf16 when both operands are bf16
//   (rounded once, as `o_ref[:] = acc.astype(...)` does).
// - Ragged edges are masked (out-of-range elements read 0, stores are
//   skipped) instead of copying zero-padded operands as the TPU path does.
// - Each operand comes with a row and a column stride, so the transposed
//   views the tape's matmul VJP passes (grad @ B^T and A^T @ grad) are read in
//   place, with no copy to a contiguous layout.
//
// What bounds it on this card: the f32 rate for the products that fill the
// card (config 6b's block products, 2.1-8.6 GFLOP each, 309 GFLOP a step;
// the 10,000-row eval product, 3.1 GFLOP; config 8's post-scan products,
// K = 8,192, up to 4.3 GFLOP each): 67 TFLOP/s of FMA on the CUDA cores,
// 164.9 TFLOP/s in 3xTF32 on the tensor cores (494.7 of TF32 over three).
// For the flagship's train-step products (at most 20 million
// multiply-adds, under a microsecond of FMAs) it is the launch and the
// latency of the first loads. The design, per product, from a host-side
// plan (`plan_matmul` in ops/kernels.py: a tile configuration and a
// K-split chosen from the sizes and the operands' layout so that the
// product puts about a wave of blocks on the 132 SMs):
// - four CUDA-core tile configurations, all of 256 threads: 64x64 with a
//   4x4 register tile a thread, 128x64 with 8x4, 128x128 with 8x8 at two
//   blocks an SM (128 registers a thread) and at one (167). The larger
//   tiles do more FMAs for each shared-memory load where the output fills
//   the card; the small one leaves more blocks for the narrow products.
// - copies overlapped with the products: a ring of STAGES stages of
//   BK = 16 deep in dynamic shared memory, filled with cp.async. An operand
//   whose unit stride runs along the tile's row in shared memory (A
//   transposed, B as it is) and whose rows are 16-byte aligned is copied 16
//   bytes at a time (cp.async.cg); any other layout, such as the flagship's
//   widths 70, 30 and 10 or a transposed view read across its unit stride,
//   4 bytes at a time (cp.async.ca), neighbouring threads on neighbouring
//   addresses. Ragged edges copy fewer bytes, and cp.async fills the rest
//   of the 16 or 4 with zeros. bf16 operands (cp.async cannot widen them)
//   are loaded through registers into the same stages, widened on the way.
// - split-K inside a thread block cluster: the `split` blocks of a cluster
//   (grid z) take consecutive slices of K for the same output tile; each
//   leaves its partial tile in its own shared memory, and after a cluster
//   barrier block j sums its share of the rows (ceil(BM / split) of them,
//   the j-th such run) of all the partial tiles through distributed shared memory in rank order, 0 first,
//   and stores them. No atomics, no workspace in device memory, no second
//   launch: a rerun is bit-identical, and so is the result for a given
//   plan whatever order the blocks run in.
// - configuration 4, the tensor-core tile, for f32 products whose operands
//   each have a unit stride (along K or along their rows) and 16-byte
//   aligned rows: 128x128 outputs a block of two warpgroups, each 64x128
//   by `wgmma` m64n128k8 TF32 with f32 accumulators. A stage is 32 of K.
//   Each f32 value is split into hi = round_tf32(x) and lo =
//   truncate_tf32(x - hi) (as ops/tf32.py does, bit for bit; the attention
//   kernels' split), and lo hi' + hi lo' + hi hi' are issued ("3xTF32";
//   the dropped lo lo' is about 2^-22 of the product). A's values are
//   split in registers into the wgmma's A fragments. B's are split once a
//   stage, by the block, into a high and a low plane in shared memory,
//   K-major (the layout TF32 wgmma reads), whatever B's layout in device
//   memory: the forward's W and the weight gradients' G (rows along N) are
//   turned K-major there, so no transposed copy goes to device memory.
//   Both operands come from global memory straight into registers, a stage
//   ahead, and B's next planes are written while the current stage's
//   wgmmas run (two pairs of planes): shared memory carries only the planes
//   and the wgmmas' three reads of them a k8 step. Its traffic measured as
//   the limit: a ring of cp.async stages in shared memory, as the CUDA-core
//   tiles use, ran 14% slower, and warpgroups that each wrote their own
//   planes 26% slower. At config 6b's block products the tile runs at 43%
//   of the 3xTF32 bound, 1.45x faster than cuBLAS's f32 products (PERF.md).
//   The tensor cores' f32 accumulation cuts towards zero, so the wgmmas sum
//   one stage at a time from zero and each stage's partial is added to the
//   output's f32 register sum with an ordinary add: against float64 the
//   result stays
//   within the f32 plain version's error at K = 8,192 (plain TF32 misses
//   it by 100x or more). The same split-K in clusters serves the weight
//   gradients, whose outputs make few tiles (512x512: 16). The plan keeps
//   the CUDA-core tiles for narrow, unaligned or latency-bound products
//   (the flagship's widths 70, 30 and 10, 6b's head).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tf32.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

using tinynn::fence_operand;
using tinynn::split_tf32;
using tinynn::wgmma_commit;
using tinynn::wgmma_fence;
using tinynn::wgmma_tf32;
using tinynn::wgmma_wait_all;

constexpr int THREADS = 256;
constexpr int BK = 16;       // depth of one shared-memory stage
constexpr int MAX_SPLIT = 8; // the portable cluster size
constexpr int PAD = 4;       // keeps rows 16-byte aligned and spreads banks

enum DType { kF32 = 0, kBF16 = 1 };

// How the operands are read (bits of `flags`): 16 bytes at a time, and
// which stride is the unit one for the 4-byte copies.
enum Flags { kVecA = 1, kVecB = 2, kAKUnit = 4, kBNUnit = 8, kVecC = 16 };

// A tile configuration: BM x BN outputs a block, TM x TN a thread, STAGES
// stages in flight; the compiler holds a thread to the registers that let
// BLOCKS blocks share an SM.
template <int BM_, int BN_, int TM_, int TN_, int STAGES_, int BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int STAGES = STAGES_, BLOCKS = BLOCKS_;
  static constexpr int TX = BN / TN;  // threads along a row of the tile
  static constexpr int TY = BM / TM;  // threads along a column
  static_assert(TX * TY == THREADS, "256 threads a block");
  static constexpr int AS = BM + PAD;  // a stage's A is [BK][AS], k-major
  static constexpr int BS = BN + PAD;  // its B [BK][BS]
  static constexpr int STAGE = BK * (AS + BS);
  static constexpr int RS = BN + PAD;  // the partial tile is [BM][RS]
  static constexpr int FLOATS =
      STAGES * STAGE > BM * RS ? STAGES * STAGE : BM * RS;
  static constexpr size_t SMEM = sizeof(float) * FLOATS;
};

using Small = Tile<64, 64, 4, 4, 6, 3>;
using Wide = Tile<128, 64, 8, 4, 4, 2>;
using Large = Tile<128, 128, 8, 8, 3, 2>;
// Large for launches of about a block an SM: the registers of a whole SM's
// half, so no spill, and a fourth stage in the partial tile's room
using Large1 = Tile<128, 128, 8, 8, 4, 1>;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Row gr, columns gc..gc+3 of C (contiguous [m, n]); `vec` (n % 4 == 0):
// one 16-byte store where all four lie inside C.
template <typename TC>
__device__ __forceinline__ void store_row4(TC* c, int m, int n, bool vec,
                                           int gr, int gc, float4 v) {
  if (gr >= m) return;
  TC* p = c + static_cast<long long>(gr) * n + gc;
  if (vec && gc + 3 < n) {
    store4(p, v);
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gc + j < n) store(p + j, e[j]);
  }
}

// cp.async of 16 or 4 bytes; of the `bytes` read, the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One operand as the stages see it: element (i, kk) of the [rows, K] view
// (A as it is; B read as B^T) at p[i * s_i + kk * s_k], stored to the stage
// as st[kk * ld + i].
template <typename T>
struct Operand {
  const T* p;
  long long s_i, s_k;
  int rows;      // valid rows (m for A, n for B)
  bool vec;      // s_i == 1, rows 16-byte aligned: 16-byte copies along i
  bool k_unit;   // s_k == 1: the 4-byte copies walk k fastest
};

// Copies the operand's [ROWS x BK] slice at k0 into a stage (st[kk * LD +
// i]); rows past o.rows and k at or past k_end read 0.
template <int ROWS, int LD, typename T>
__device__ __forceinline__ void load_slice(const Operand<T>& o, float* st,
                                           int k0, int k_end) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, float>::value) {
    if (o.vec) {
#pragma unroll
      for (int it = 0; it < (ROWS * BK / 4) / THREADS; ++it) {
        const int c = tid + it * THREADS;
        const int kk = c / (ROWS / 4);
        const int i = (c % (ROWS / 4)) * 4;
        const int left = o.rows - i;
        const int valid =
            k0 + kk < k_end ? (left >= 4 ? 4 : (left > 0 ? left : 0)) : 0;
        const float* src =
            valid ? o.p + i + static_cast<long long>(k0 + kk) * o.s_k
                  : o.p;
        cp_async16(st + kk * LD + i, src, 4 * valid);
      }
      return;
    }
  }
#pragma unroll
  for (int it = 0; it < (ROWS * BK) / THREADS; ++it) {
    const int idx = tid + it * THREADS;
    const int kk = o.k_unit ? idx % BK : idx / ROWS;
    const int i = o.k_unit ? idx / BK : idx % ROWS;
    const bool valid = i < o.rows && k0 + kk < k_end;
    const T* src = valid ? o.p + static_cast<long long>(i) * o.s_i +
                               static_cast<long long>(k0 + kk) * o.s_k
                         : o.p;
    if constexpr (std::is_same<T, float>::value) {
      cp_async4(st + kk * LD + i, src, valid ? 4 : 0);
    } else {
      st[kk * LD + i] = valid ? to_f32(*src) : 0.0f;
    }
  }
}

// The row (or column) of the tile that element `e` of a thread's TM (TN)
// outputs sits in: groups of 4 consecutive ones, the groups T * 4 apart,
// so that a warp's float4 reads of a stage are conflict-free.
template <int T>
__device__ __forceinline__ int spread(int e, int t) {
  return (e / 4) * (T * 4) + t * 4 + (e % 4);
}

// Split-K's sum: every block of the cluster has left its partial tile
// ([BM][RS] floats at `part`) in its own shared memory; after a cluster
// barrier block j sums the j-th run of ceil(BM / split) rows over the
// cluster's tiles through distributed shared memory, rank 0 first, and
// hands each four columns to store(row, column, float4).
template <int BM, int BN, int RS, class Store>
__device__ __forceinline__ void sum_partials(const float* part, int split,
                                             Store store) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = (BM + split - 1) / split;
  const int first = static_cast<int>(cluster.block_rank()) * rows;
  const int last = min(BM, first + rows);
  for (int e = threadIdx.x; e < (last - first) * (BN / 4); e += THREADS) {
    const int r = first + e / (BN / 4);
    const int c4 = (e % (BN / 4)) * 4;
    const int off = r * RS + c4;
    float4 v = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part, 0) + off);
    for (int j = 1; j < split; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, j) + off);
      v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
    }
    store(r, c4, v);
  }
  cluster.sync();  // no block leaves while another reads its tile
}

template <class Cfg, typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(THREADS, Cfg::BLOCKS)
matmul_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
              TC* __restrict__ c, int m, int n, int k, long long sa_m,
              long long sa_k, long long sb_k, long long sb_n, int k_chunk,
              int flags) {
  constexpr int BM = Cfg::BM, BN = Cfg::BN, TM = Cfg::TM, TN = Cfg::TN;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int tx = tid % Cfg::TX;
  const int ty = tid / Cfg::TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int split = gridDim.z;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(k, k_begin + k_chunk);

  const Operand<TA> A = {a + static_cast<long long>(row0) * sa_m, sa_m, sa_k,
                         m - row0, (flags & kVecA) != 0,
                         (flags & kAKUnit) != 0};
  const Operand<TB> B = {b + static_cast<long long>(col0) * sb_n, sb_n, sb_k,
                         n - col0, (flags & kVecB) != 0,
                         (flags & kBNUnit) == 0};

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  auto load = [&](int stage, int k0) {
    float* st = smem + stage * Cfg::STAGE;
    load_slice<BM, Cfg::AS>(A, st, k0, k_end);
    load_slice<BN, Cfg::BS>(B, st + BK * Cfg::AS, k0, k_end);
  };

  const int tiles = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) load(s, k_begin + s * BK);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the stage computed in the step before is free: refill it
    const int next = t + STAGES - 1;
    if (next < tiles) load(next % STAGES, k_begin + next * BK);
    cp_async_commit();
    const float* As = smem + (t % STAGES) * Cfg::STAGE;
    const float* Bs = As + BK * Cfg::AS;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ar[TM], br[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            As + kk * Cfg::AS + spread<Cfg::TY>(4 * g, ty));
        ar[4 * g] = v.x; ar[4 * g + 1] = v.y;
        ar[4 * g + 2] = v.z; ar[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            Bs + kk * Cfg::BS + spread<Cfg::TX>(4 * g, tx));
        br[4 * g] = v.x; br[4 * g + 1] = v.y;
        br[4 * g + 2] = v.z; br[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  const bool vec_c = (flags & kVecC) != 0;
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int g = 0; g < TN / 4; ++g)
        store_row4(c, m, n, vec_c, row0 + spread<Cfg::TY>(i, ty),
                   col0 + spread<Cfg::TX>(4 * g, tx),
                   make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                               acc[i][4 * g + 2], acc[i][4 * g + 3]));
    return;
  }

  // split-K: the partial tile to this block's shared memory, then the
  // cluster's sum of the partial tiles
  __syncthreads();  // every thread is done with the stages
  float* part = smem;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int g = 0; g < TN / 4; ++g)
      *reinterpret_cast<float4*>(part + spread<Cfg::TY>(i, ty) * Cfg::RS +
                                 spread<Cfg::TX>(4 * g, tx)) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                      acc[i][4 * g + 3]);
  sum_partials<BM, BN, Cfg::RS>(part, split, [&](int r, int c4, float4 v) {
    store_row4(c, m, n, vec_c, row0 + r, col0 + c4, v);
  });
}

// ---------------------------------------------------------------------------
// Configuration 4, the tensor-core tile: `wgmma` m64n128k8 TF32 in 3xTF32,
// A's fragments split in registers, B split once a stage into K-major TF32
// planes in shared memory
// ---------------------------------------------------------------------------

namespace tc {
constexpr int BM = 128, BN = 128, BK = 32;
// B's high and low TF32 planes: K-major 8 x 4 core matrices (128 bytes
// each), logical k index kl at ((n / 8) * (BK / 4) + kl / 4) * 32 +
// (n % 8) * 4 + kl % 4
constexpr int PLANE = BN * BK;
constexpr int RS = BN + 4;
constexpr int FLOATS = 4 * PLANE > BM * RS ? 4 * PLANE : BM * RS;
constexpr size_t SMEM = sizeof(float) * FLOATS;
}  // namespace tc

// The wgmma descriptor of one of B's planes: core matrices 1,024 bytes
// apart along N.
__device__ __forceinline__ uint64_t plane_desc(const float* p) {
  return tinynn::kmajor_desc(p, (tc::BK / 4) * 128);
}

// The stages' order of k. The wgmma's k8 step s takes logical k 8s..8s+7;
// its A fragment gives thread t slots t and t + 4. Slot j of step s is
// the stage's physical k = 8 (j % 4) + 2 s + j / 4, so that thread t's
// eight values of a row over the four steps are physical k 8t..8t+7,
// contiguous. B's planes store each column in the same order.

// One stage of B held in registers: the thread's column n = tid % BN and
// physical k = 8 i + q0 + c (q0 = (tid / BN) * 4), as x[4 i + c].
// K_UNIT: element (k, n) at p[n * s + k], else at p[k * s + n]. Columns at
// or past `cols` and k at or past k_end read 0.
template <bool K_UNIT>
__device__ __forceinline__ void load_b(float (&x)[16], const float* p,
                                       long long s, int cols, int k0,
                                       int k_end) {
  const int n = threadIdx.x % tc::BN, q0 = (threadIdx.x / tc::BN) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 8 * i + q0;
    if (K_UNIT && n < cols && k + 3 < k_end) {
      const float4 v = *reinterpret_cast<const float4*>(p + n * s + k);
      x[4 * i] = v.x; x[4 * i + 1] = v.y; x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x[4 * i + c] = n < cols && k + c < k_end
                           ? (K_UNIT ? p[n * s + k + c] : p[(k + c) * s + n])
                           : 0.0f;
    }
  }
}

// The thread's B values into a pair of planes: chunk q0 + c of its column
// holds physical k c + q0 + 8i, i = 0..3; then the fence that shows the
// planes to the wgmmas' (async) reads.
__device__ __forceinline__ void store_planes(const float (&x)[16], float* hi,
                                             float* lo) {
  const int n = threadIdx.x % tc::BN, q0 = (threadIdx.x / tc::BN) * 4;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint4 h, l;
    split_tf32(x[c], h.x, l.x);
    split_tf32(x[4 + c], h.y, l.y);
    split_tf32(x[8 + c], h.z, l.z);
    split_tf32(x[12 + c], h.w, l.w);
    const int off = ((n / 8) * (tc::BK / 4) + q0 + c) * 32 + (n % 8) * 4;
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
  tinynn::fence_async_shared();
}

// One stage of A held in registers: the thread's rows r and r + 1
// (r = `row`) at physical k 8t + j, as x[8h + j]. K_UNIT: element (i, k) at
// p[i * s + k], else at p[k * s + i]. Rows at or past `rows` and k at or
// past k_end read 0.
template <bool K_UNIT>
__device__ __forceinline__ void load_a(float (&x)[16], const float* p,
                                       long long s, int rows, int row, int t,
                                       int k0, int k_end) {
  const int k = k0 + 8 * t;
  if (K_UNIT) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; j += 4) {
        const int r = row + h;
        if (r < rows && k + j + 3 < k_end) {
          const float4 v =
              *reinterpret_cast<const float4*>(p + r * s + k + j);
          x[8 * h + j] = v.x; x[8 * h + j + 1] = v.y;
          x[8 * h + j + 2] = v.z; x[8 * h + j + 3] = v.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[8 * h + j + e] =
                r < rows && k + j + e < k_end ? p[r * s + k + j + e] : 0.0f;
        }
      }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (row + 1 < rows && k + j < k_end) {
        const float2 v =
            *reinterpret_cast<const float2*>(p + (k + j) * s + row);
        x[j] = v.x;
        x[8 + j] = v.y;
      } else {
        const bool in = k + j < k_end;
        x[j] = in && row < rows ? p[(k + j) * s + row] : 0.0f;
        x[8 + j] = in && row + 1 < rows ? p[(k + j) * s + row + 1] : 0.0f;
      }
    }
  }
}

// A's stage into the wgmma fragments of its four k8 steps, split: logical
// rows g and g + 8 are the thread's rows r and r + 1.
__device__ __forceinline__ void split_fragments(const float (&x)[16],
                                                unsigned (&ah)[4][4],
                                                unsigned (&al)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    split_tf32(x[2 * s], ah[s][0], al[s][0]);
    split_tf32(x[8 + 2 * s], ah[s][1], al[s][1]);
    split_tf32(x[2 * s + 1], ah[s][2], al[s][2]);
    split_tf32(x[8 + 2 * s + 1], ah[s][3], al[s][3]);
  }
}

// C = A @ B: 2 warpgroups of 64 rows. A_K: A's unit stride runs along K
// (its other stride sa), else along its rows; B_K likewise for B (sb).
// Each stage (BK = 32 of K) comes from global memory into registers one
// stage ahead; while a stage's wgmmas run, the threads write the next
// stage's B into the other pair of planes.
template <bool A_K, bool B_K>
__global__ void __launch_bounds__(THREADS, 1)
matmul_kernel_tc(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ c, int m, int n, int k, long long sa,
                 long long sb, int k_chunk) {
  constexpr int BM = tc::BM, BN = tc::BN, BK = tc::BK, RS = tc::RS;
  static_assert(BK == 32, "four k8 steps a stage");
  extern __shared__ __align__(16) float smem[];
  float* const planes = smem;  // [2][hi, lo][PLANE]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // the warp's 16 rows; the thread's two, as logical rows g and g + 8
  const int row = (warp / 4) * 64 + (warp % 4) * 16 + 2 * g;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int split = gridDim.z;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(k, k_begin + k_chunk);
  const float* pa = a + static_cast<long long>(row0) * (A_K ? sa : 1);
  const float* pb = b + static_cast<long long>(col0) * (B_K ? sb : 1);
  const uint64_t desc0 = plane_desc(planes);
  constexpr uint64_t kPlaneStep = (tc::PLANE * 4) >> 4;  // descriptor units

  float acc[64], part[64], xa[16], xb[16];
  unsigned ah[4][4], al[4][4];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;

  const int tiles = (k_end - k_begin + BK - 1) / BK;
  load_a<A_K>(xa, pa, sa, m - row0, row, t, k_begin, k_end);
  load_b<B_K>(xb, pb, sb, n - col0, k_begin, k_end);
  store_planes(xb, planes, planes + tc::PLANE);
  split_fragments(xa, ah, al);
  if (tiles > 1) {
    load_a<A_K>(xa, pa, sa, m - row0, row, t, k_begin + BK, k_end);
    load_b<B_K>(xb, pb, sb, n - col0, k_begin + BK, k_end);
  }
  __syncthreads();
  for (int kt = 0; kt < tiles; ++kt) {
    // stage kt on the tensor cores: planes kt % 2, fragments ah, al
    const uint64_t hi_desc = desc0 + (kt & 1) * 2 * kPlaneStep;
    const uint64_t lo_desc = hi_desc + kPlaneStep;
#pragma unroll
    for (int e = 0; e < 64; ++e) fence_operand(part[e]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      // k8 step s is the planes' core matrices 2s and 2s + 1 along K
      const uint64_t step = (2 * s * 128) >> 4;
      wgmma_tf32(part, al[s], hi_desc + step, s > 0);
      wgmma_tf32(part, ah[s], lo_desc + step, 1);
      wgmma_tf32(part, ah[s], hi_desc + step, 1);
    }
    wgmma_commit();
    if (kt + 1 < tiles) {
      float* hi = planes + ((kt + 1) & 1) * 2 * tc::PLANE;
      store_planes(xb, hi, hi + tc::PLANE);
    }
    wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      fence_operand(part[e]);
      acc[e] += part[e];
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // the wgmmas read ah and al until the wait: they live until here
        fence_operand(ah[s][e]);
        fence_operand(al[s][e]);
      }
    if (kt + 1 < tiles) split_fragments(xa, ah, al);
    if (kt + 2 < tiles) {
      load_a<A_K>(xa, pa, sa, m - row0, row, t, k_begin + (kt + 2) * BK,
                  k_end);
      load_b<B_K>(xb, pb, sb, n - col0, k_begin + (kt + 2) * BK, k_end);
    }
    __syncthreads();  // the next planes are whole; these are free
  }

  // acc[4j + e]: row `row` + e / 2, column 8j + 2t + e % 2
  if (split == 1) {
    const bool pair = (n & 1) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + row + h;
        const int col = col0 + 8 * j + 2 * t;
        if (r >= m) continue;
        float* p = c + static_cast<long long>(r) * n + col;
        if (pair && col + 1 < n) {
          *reinterpret_cast<float2*>(p) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        } else {
          if (col < n) p[0] = acc[4 * j + 2 * h];
          if (col + 1 < n) p[1] = acc[4 * j + 2 * h + 1];
        }
      }
    return;
  }

  float* tile = smem;  // the planes are free after the loop's last barrier
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (row + h) * RS + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  const bool vec_c = (n & 3) == 0;
  sum_partials<BM, BN, RS>(tile, split, [&](int r, int c4, float4 v) {
    store_row4(c, m, n, vec_c, row0 + r, col0 + c4, v);
  });
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Launches `kernel` on a (grid.x, grid.y, split) grid of THREADS-thread
// blocks with `smem` bytes of dynamic shared memory, the `split` blocks of
// grid z in one cluster.
template <typename... Params, typename... Args>
int launch_split(void (*kernel)(Params...), size_t smem, unsigned grid_x,
                 int tiles_m, int split, cudaStream_t stream, Args... args) {
  if (tiles_m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, tiles_m, split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <class Cfg, typename TA, typename TB, typename TC>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           long long sa_m, long long sa_k, long long sb_k, long long sb_n,
           int split, int k_chunk, cudaStream_t stream) {
  constexpr bool f32a = std::is_same<TA, float>::value;
  constexpr bool f32b = std::is_same<TB, float>::value;
  int flags = 0;
  if (f32a && sa_m == 1 && sa_k % 4 == 0 && aligned16(a)) flags |= kVecA;
  if (f32b && sb_n == 1 && sb_k % 4 == 0 && aligned16(b)) flags |= kVecB;
  if (sa_k == 1) flags |= kAKUnit;
  if (sb_n == 1) flags |= kBNUnit;
  if (n % 4 == 0) flags |= kVecC;
  return launch_split(matmul_kernel<Cfg, TA, TB, TC>, Cfg::SMEM,
                      (n + Cfg::BN - 1) / Cfg::BN,
                      (m + Cfg::BM - 1) / Cfg::BM, split, stream,
                      static_cast<const TA*>(a), static_cast<const TB*>(b),
                      static_cast<TC*>(c), m, n, k, sa_m, sa_k, sb_k, sb_n,
                      k_chunk, flags);
}

// Which way the tensor-core tile reads an f32 operand with strides s_rows
// (along its rows: A's m, B's n) and s_k: 1 where K is the unit stride, 0
// where the rows are, -1 where it cannot (no unit stride, rows not 16-byte
// aligned). ops/kernels.py's `tc_aligned` is the same rule.
int tc_unit(const void* p, long long s_rows, long long s_k) {
  if (!aligned16(p)) return -1;
  if (s_k == 1 && s_rows % 4 == 0) return 1;
  if (s_rows == 1 && s_k % 4 == 0) return 0;
  return -1;
}

template <bool A_K, bool B_K>
int launch_tc(const float* a, const float* b, float* c, int m, int n, int k,
              long long sa, long long sb, int split, int k_chunk,
              cudaStream_t stream) {
  return launch_split(matmul_kernel_tc<A_K, B_K>, tc::SMEM,
                      (n + tc::BN - 1) / tc::BN, (m + tc::BM - 1) / tc::BM,
                      split, stream, a, b, c, m, n, k, sa, sb, k_chunk);
}

int launch_tc_layout(const void* a, const void* b, void* c, int m, int n,
                     int k, long long sa_m, long long sa_k, long long sb_k,
                     long long sb_n, int split, int k_chunk,
                     cudaStream_t s) {
  const int ua = tc_unit(a, sa_m, sa_k), ub = tc_unit(b, sb_n, sb_k);
  if (ua < 0 || ub < 0 || k_chunk % tc::BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fc = static_cast<float*>(c);
  const long long sa = ua ? sa_m : sa_k, sb = ub ? sb_n : sb_k;
  if (ua && ub)
    return launch_tc<true, true>(fa, fb, fc, m, n, k, sa, sb, split, k_chunk,
                                 s);
  if (ua)
    return launch_tc<true, false>(fa, fb, fc, m, n, k, sa, sb, split,
                                  k_chunk, s);
  if (ub)
    return launch_tc<false, true>(fa, fb, fc, m, n, k, sa, sb, split,
                                  k_chunk, s);
  return launch_tc<false, false>(fa, fb, fc, m, n, k, sa, sb, split, k_chunk,
                                 s);
}

// `kernel`'s blocks an SM holds at `smem` bytes of shared memory, and the
// clusters of `split` blocks the card holds at once.
template <typename... Params>
int occupancy(void (*kernel)(Params...), size_t smem, int split, int* per_sm,
              int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, THREADS,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}

template <typename TA, typename TB, typename TC>
int launch_config(int config, const void* a, const void* b, void* c, int m,
                  int n, int k, long long sa_m, long long sa_k,
                  long long sb_k, long long sb_n, int split, int k_chunk,
                  cudaStream_t s) {
  switch (config) {
    case 0:
      return launch<Small, TA, TB, TC>(a, b, c, m, n, k, sa_m, sa_k, sb_k,
                                       sb_n, split, k_chunk, s);
    case 1:
      return launch<Wide, TA, TB, TC>(a, b, c, m, n, k, sa_m, sa_k, sb_k,
                                      sb_n, split, k_chunk, s);
    case 2:
      return launch<Large, TA, TB, TC>(a, b, c, m, n, k, sa_m, sa_k, sb_k,
                                       sb_n, split, k_chunk, s);
    case 3:
      return launch<Large1, TA, TB, TC>(a, b, c, m, n, k, sa_m, sa_k, sb_k,
                                        sb_n, split, k_chunk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

constexpr int kTensorCores = 4;  // the tensor-core tile's configuration

}  // namespace

// C (contiguous [m, n]) = A @ B, with A and B given by pointer and element
// strides, through tile configuration `config` (0: 64x64, 1: 128x64, 2:
// 128x128, 3: 128x128 at one block an SM, 4: 128x128 on the tensor cores,
// f32 operands that `tc_unit` takes, k_chunk a multiple of 32) with K cut
// into `split` slices of `k_chunk` (a cluster of `split` blocks a tile;
// split 1: one block a tile, k_chunk >= k). Every slice must hold part of
// K: (split - 1) * k_chunk < k <= split * k_chunk. Launches on `stream`
// and does not synchronise. Returns the CUDA error of the launch (0 when it
// was accepted).
extern "C" int tinynn_matmul(const void* a, const void* b, void* c, int m,
                             int n, int k, long long sa_m, long long sa_k,
                             long long sb_k, long long sb_n, int a_dtype,
                             int b_dtype, int config, int split, int k_chunk,
                             void* stream) {
  if (m < 1 || n < 1 || k < 1 || split < 1 || split > MAX_SPLIT ||
      k_chunk < 1 || static_cast<long long>(split - 1) * k_chunk >= k ||
      static_cast<long long>(split) * k_chunk < k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (config == kTensorCores)
    return a_dtype == kF32 && b_dtype == kF32
               ? launch_tc_layout(a, b, c, m, n, k, sa_m, sa_k, sb_k, sb_n,
                                  split, k_chunk, s)
               : static_cast<int>(cudaErrorInvalidValue);
  if (a_dtype == kF32 && b_dtype == kF32)
    return launch_config<float, float, float>(
        config, a, b, c, m, n, k, sa_m, sa_k, sb_k, sb_n, split, k_chunk, s);
  if (a_dtype == kBF16 && b_dtype == kBF16)
    return launch_config<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        config, a, b, c, m, n, k, sa_m, sa_k, sb_k, sb_n, split, k_chunk, s);
  if (a_dtype == kF32 && b_dtype == kBF16)
    return launch_config<float, __nv_bfloat16, float>(
        config, a, b, c, m, n, k, sa_m, sa_k, sb_k, sb_n, split, k_chunk, s);
  if (a_dtype == kBF16 && b_dtype == kF32)
    return launch_config<__nv_bfloat16, float, float>(
        config, a, b, c, m, n, k, sa_m, sa_k, sb_k, sb_n, split, k_chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Configuration `config`'s f32 kernel on the current device: the blocks an
// SM holds at once (`*per_sm`), and the clusters of `split` blocks the card
// holds at once (`*clusters`). Returns the CUDA error of the queries.
extern "C" int tinynn_matmul_occupancy(int config, int split, int* per_sm,
                                       int* clusters) {
  if (split < 1 || split > MAX_SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (config) {
    case 0:
      return occupancy(matmul_kernel<Small, float, float, float>, Small::SMEM,
                       split, per_sm, clusters);
    case 1:
      return occupancy(matmul_kernel<Wide, float, float, float>, Wide::SMEM,
                       split, per_sm, clusters);
    case 2:
      return occupancy(matmul_kernel<Large, float, float, float>, Large::SMEM,
                       split, per_sm, clusters);
    case 3:
      return occupancy(matmul_kernel<Large1, float, float, float>,
                       Large1::SMEM, split, per_sm, clusters);
    case kTensorCores:
      return occupancy(matmul_kernel_tc<true, false>, tc::SMEM, split, per_sm,
                       clusters);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
