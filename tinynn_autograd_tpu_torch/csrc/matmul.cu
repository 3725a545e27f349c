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
// - f32 operands are multiplied in full f32 with FMA on the CUDA cores, never
//   in TF32; bf16 operands are widened with __bfloat162float and summed in
//   f32. The result is stored in promote(a, b): f32, or bf16 when both
//   operands are bf16 (rounded once, as `o_ref[:] = acc.astype(...)` does).
// - Ragged edges are masked (out-of-range elements read 0, stores are
//   skipped) instead of copying zero-padded operands as the TPU path does.
// - Each operand comes with a row and a column stride, so the transposed
//   views the tape's matmul VJP passes (grad @ B^T and A^T @ grad) are read in
//   place, with no copy to a contiguous layout.
//
// What bounds it on this card: f32 FMA at 67 TFLOP/s for the products that
// fill the card (the 10,000-row eval product, 3.1 GFLOP: 46.8 us; config 8's
// post-scan products, K = 8,192, up to 4.3 GFLOP each), and the launch and
// the latency of the first loads for the flagship's train-step products
// (at most 20 million multiply-adds, under a microsecond of FMAs). The
// design, per product, from a host-side plan (`plan_matmul` in
// ops/kernels.py: a tile configuration and a K-split chosen so that the
// product puts about a wave of blocks on the 132 SMs):
// - four tile configurations, all of 256 threads: 64x64 with a 4x4
//   register tile a thread, 128x64 with 8x4, 128x128 with 8x8 at two
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
// Tensor cores are not used: TF32 keeps ~3 decimal digits and breaks the
// f32 contract (rtol 1e-5 against f32 products).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

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
  auto store_row4 = [&](int gr, int gc, float4 v) {
    if (gr >= m) return;
    TC* p = c + static_cast<long long>(gr) * n + gc;
    if (vec_c && gc + 3 < n) {
      store4(p, v);
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gc + j < n) store(p + j, e[j]);
    }
  };

  if (split == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int g = 0; g < TN / 4; ++g)
        store_row4(row0 + spread<Cfg::TY>(i, ty),
                   col0 + spread<Cfg::TX>(4 * g, tx),
                   make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                               acc[i][4 * g + 2], acc[i][4 * g + 3]));
    return;
  }

  // split-K: the partial tile to this block's shared memory, then each
  // block of the cluster sums its share of the rows over the cluster's
  // partial tiles, rank 0 first
  cg::cluster_group cluster = cg::this_cluster();
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
  cluster.sync();
  const int rows = (BM + split - 1) / split;
  const int first = static_cast<int>(cluster.block_rank()) * rows;
  const int last = min(BM, first + rows);
  for (int e = tid; e < (last - first) * (BN / 4); e += THREADS) {
    const int r = first + e / (BN / 4);
    const int c4 = (e % (BN / 4)) * 4;
    const int off = r * Cfg::RS + c4;
    float4 v = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part, 0) + off);
    for (int j = 1; j < split; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, j) + off);
      v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
    }
    store_row4(row0 + r, col0 + c4, v);
  }
  cluster.sync();  // no block leaves while another reads its tile
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <class Cfg, typename TA, typename TB, typename TC>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           long long sa_m, long long sa_k, long long sb_k, long long sb_n,
           int split, int k_chunk, cudaStream_t stream) {
  const int tiles_m = (m + Cfg::BM - 1) / Cfg::BM;
  if (tiles_m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool f32a = std::is_same<TA, float>::value;
  constexpr bool f32b = std::is_same<TB, float>::value;
  int flags = 0;
  if (f32a && sa_m == 1 && sa_k % 4 == 0 && aligned16(a)) flags |= kVecA;
  if (f32b && sb_n == 1 && sb_k % 4 == 0 && aligned16(b)) flags |= kVecB;
  if (sa_k == 1) flags |= kAKUnit;
  if (sb_n == 1) flags |= kBNUnit;
  if (n % 4 == 0) flags |= kVecC;
  auto kernel = matmul_kernel<Cfg, TA, TB, TC>;
  if (Cfg::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Cfg::SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + Cfg::BN - 1) / Cfg::BN, tiles_m, split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Cfg::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TA*>(a), static_cast<const TB*>(b),
      static_cast<TC*>(c), m, n, k, sa_m, sa_k, sb_k, sb_n, k_chunk, flags);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The f32 kernel of configuration Cfg: its blocks an SM holds, and the
// clusters of `split` blocks the card holds at once.
template <class Cfg>
int occupancy(int split, int* per_sm, int* clusters) {
  auto kernel = matmul_kernel<Cfg, float, float, float>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, THREADS,
                                                      Cfg::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Cfg::SMEM;
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

}  // namespace

// C (contiguous [m, n]) = A @ B, with A and B given by pointer and element
// strides, through tile configuration `config` (0: 64x64, 1: 128x64, 2:
// 128x128, 3: 128x128 at one block an SM) with K cut into `split` slices of `k_chunk` (a cluster of
// `split` blocks a tile; split 1: one block a tile, k_chunk >= k). Every
// slice must hold part of K: (split - 1) * k_chunk < k <= split * k_chunk.
// Launches on `stream` and does not synchronise. Returns the CUDA error of
// the launch (0 when it was accepted).
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
      return occupancy<Small>(split, per_sm, clusters);
    case 1:
      return occupancy<Wide>(split, per_sm, clusters);
    case 2:
      return occupancy<Large>(split, per_sm, clusters);
    case 3:
      return occupancy<Large1>(split, per_sm, clusters);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
