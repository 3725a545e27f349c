// Weight-streaming kernels for Hopper (sm_90a): K3, the forward of a
// DenseStack body, and K3b, its backward with the optimizer's update applied
// in the kernel. One train step of the streaming tier launches K3 once and
// K3b once.
//
// Replaces the TPU kernels of tinynn_autograd_tpu/ops/streaming_epoch.py:
// `kernel` inside `_build_forward` (:151) and `kernel` inside
// `_build_backward` (:192). There the grid walks the layers in order on one
// core: each grid step streams one layer's w[l] from HBM into VMEM while the
// running activation (forward) or cotangent (backward) stays in VMEM
// scratch, and the backward applies the optimizer's per-leaf rule to dW
// on-chip, so the dW stack never reaches HBM.
//
// How the TPU design translates:
// - The layer walk is a chain: layer l needs all of layer l-1's output row.
//   But a batch row's chain depends only on that row, so the rows split
//   across blocks with no grid-wide barrier. A thread block cluster of CS
//   blocks (up to 8, on neighbouring SMs) owns R batch rows and walks all L
//   layers alone. Each block of the cluster computes CHUNK-column slices of
//   the layer's output for the R rows into its own shared memory; after one
//   cluster barrier a layer (hardware, not a grid barrier) each block reads
//   the other blocks' slices from their shared memory (distributed shared
//   memory, 16-byte loads). So the running activation never leaves the SMs,
//   as it never leaves VMEM on the TPU, and w[l] streams from L2/HBM, each
//   column slice read by one block of each cluster.
// - K3b's dh chain is row-local too and runs the same way (pass 1). Each
//   block turns its own columns of dh into dz = dh * act'(a) before the
//   cluster barrier, so that no block changes a slice of its panel that
//   another block may still be reading. Neither acts nor w depends on the
//   chain, so both are in flight while the products run, as the TPU
//   kernel's pipeline fetches the next layer's blocks: the act' operand
//   with the layer's w, the next layer's first batch of w during the last
//   batch of this one. But
//   dW[l] = h_in^T dz needs every row: a reduction across clusters. Pass 1
//   therefore writes the dz stack [L, B, W] to device memory, and pass 2, a
//   second kernel on the same stream, is parallel over (layer, 64x64 tile of
//   dW[l]): each thread owns 4x4 elements of dW, sums them over the batch in
//   a fixed order and applies the optimizer's rule to them at once, updating
//   w and the slots IN PLACE. dW never reaches device memory; the dz stack
//   (half dW's size at batch 128, width 256) does. Pass 1 reads the
//   pre-update w; pass 2 starts after pass 1 has finished, so no dh ever
//   sees an updated weight. db = sum_rows dz is taken in pass 2 (one thread
//   a column, rows in order).
// - No float atomics, and every sum has a fixed order: reruns from the same
//   state are bit-identical.
// - The activation's derivative comes from the output a = act(z), as in the
//   TPU kernel: ReLU passes where a > 0 (the tape's ReLU passes where
//   z >= 0; the two differ only where z == 0).
// - The optimizer: one switch over the seven rules of nn/optimizer.py, in
//   their algebraic form, with weight decay (csrc/optim_rules.cuh, shared
//   with K2 and P2). The per-step scalars (learning rate, bias
//   corrections) are computed on the host, as `update` computes them, and
//   passed as launch arguments, so a schedule costs nothing here.
//   The _rn intrinsics keep the compiler from contracting the rules into
//   FMAs: they round where the plain PyTorch version rounds.
//
// Width rule: W is a multiple of CHUNK = 32 (a warp's lanes take 32 output
// columns, or 32 consecutive k, at a time), and each block keeps two R x W
// f32 row panels in shared memory (K3 also its warps' partial sums): R = 8
// rows a cluster up to W = 3488 in K3 and 3616 in K3b, one row a cluster up
// to W = 28928 (K3's cap; the 227 KB a block may use).
//
// What bounds it at the deep MLP's shape (L = 98, B = 128, W = 256, f32):
// K3 does 1.64 GFLOP (24.5 us at 67 TFLOP/s f32 FMA) and moves 38.8 MB
// (11.6 us at 3.35 TB/s): operation-bound. K3b with Adam does 3.29 GFLOP
// (49.1 us) and moves about 167 MB (w, m, v read and written, acts read):
// 50 us, a tie. This design is the simple, right first version: 16
// clusters of 8 blocks at B = 128, one cluster barrier a layer; tensor
// cores and deeper pipelining are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "optim_rules.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;        // output columns a warp's lanes take at once
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use (227 KB)

// pass 2's tiles, as in csrc/matmul.cu
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int PAD = 4;

enum Act { kLinear = 0, kReLU = 1, kSigmoid = 2, kTanh = 3 };
using tinynn::kAdadelta;
using tinynn::kSGD;

struct ForwardArgs {
  const float* h0;  // [B, W]
  const float* w;   // [L, W, W]
  const float* b;   // [L, 1, W]
  float* acts;      // [L, B, W]
  int depth, batch, width, act;
};

struct BackwardArgs {
  const float* h0;     // [B, W], the body's input
  const float* dlast;  // [B, W], the loss gradient at the body's output
  const float* acts;   // [L, B, W], from K3
  float* w;            // [L, W, W], updated in place
  float* slot0;        // [L, W, W] or null: the rule's first slot
  float* slot1;        // [L, W, W] or null: its second slot
  float* db;           // [L, 1, W]
  float* dh0;          // [B, W], the loss gradient at the body's input
  float* dz;           // [L, B, W] scratch
  int depth, batch, width, act;
  tinynn::Rule rule;  // the optimizer's rule (csrc/optim_rules.cuh)
};

__device__ __forceinline__ float activate(int act, float z) {
  switch (act) {
    case kReLU:
      return z > 0.0f ? z : 0.0f;
    case kSigmoid:
      return 1.0f / (1.0f + expf(-z));
    case kTanh:
      return tanhf(z);
    default:
      return z;
  }
}

// The activation's derivative from its output.
__device__ __forceinline__ float activation_grad(int act, float a) {
  switch (act) {
    case kReLU:
      return a > 0.0f ? 1.0f : 0.0f;
    case kSigmoid:
      return __fmul_rn(a, __fsub_rn(1.0f, a));
    case kTanh:
      return __fsub_rn(1.0f, __fmul_rn(a, a));
    default:
      return 1.0f;
  }
}

__device__ __forceinline__ long long at(int i, int n, int j) {
  return static_cast<long long>(i) * n + j;
}

// After each block of the cluster has written its column slice
// [rank cols, rank cols + cols) of the R x W panel `buf` into its own shared
// memory: one cluster barrier (every slice is written, and every block is
// done with the panel it read before), then each block copies the other
// blocks' slices into its own `buf` with 16-byte distributed-shared-memory
// loads. With `pull` false only the barrier: the last layer's panel has no
// reader, and after the barrier no block reads another's memory any more,
// so every block may exit.
__device__ void gather_panel(cg::cluster_group& cluster, float* buf,
                             int rows, int W, int cols, int rank, int cs,
                             bool pull) {
  cluster.sync();
  if (!pull) return;
  const int vec = cols / 4;
  const int per_rank = rows * vec;
  for (int i = threadIdx.x; i < (cs - 1) * per_rank; i += THREADS) {
    const int qi = i / per_rank;
    const int q = qi < rank ? qi : qi + 1;
    const int r = (i % per_rank) / vec;
    float4* dst = reinterpret_cast<float4*>(buf + r * W + q * cols) +
                  (i % per_rank) % vec;
    *dst = *cluster.map_shared_rank(dst, q);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K3: the forward. Cluster c owns rows [c R, c R + R); block `rank` of it
// owns the columns [rank cols, rank cols + cols), cols = W / CS.
// Shared memory: h[2][R][W] (this layer's input, the next layer's), and
// red[WARPS][R][CHUNK] (the warps' partial sums over their k).
// ---------------------------------------------------------------------------
constexpr int KG = 32;  // k a thread takes in one batch of loads

template <int R>
__global__ void __launch_bounds__(THREADS)
stream_forward_kernel(const __grid_constant__ ForwardArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int W = a.width;
  float* red = smem + 2 * R * W;
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / cs) * R;
  const int cols = W / cs;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  for (int i = threadIdx.x; i < R * W; i += THREADS) {
    const int r = i / W;
    smem[i] = row0 + r < a.batch ? a.h0[at(row0 + r, W, i % W)] : 0.0f;
  }
  __syncthreads();

  int cur = 0;
  for (int l = 0; l < a.depth; ++l) {
    const float* wl = a.w + static_cast<long long>(l) * W * W;
    const float* bl = a.b + static_cast<long long>(l) * W;
    float* out = a.acts + static_cast<long long>(l) * a.batch * W;
    const float* h = smem + cur * R * W;
    float* h_next = smem + (1 - cur) * R * W;
    for (int c0 = rank * cols; c0 < (rank + 1) * cols; c0 += CHUNK) {
      // the epilogue's bias, in flight during the products
      const float bias = __ldg(bl + c0 + lane);
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      // warp `warp` takes the k of [k_begin, k_end), a run of W / WARPS (a
      // multiple of 4); its lanes take 32 neighbouring columns, so each w
      // load is one 128-byte line, and each read of h is a 16-byte
      // broadcast of 4 k. A batch issues KG loads before it uses any: one
      // L2 round trip, not KG.
      const int k_begin = warp * (W / WARPS);
      const int k_end = k_begin + W / WARPS;
      for (int k0 = k_begin; k0 < k_end; k0 += KG) {
        float wv[KG];
#pragma unroll
        for (int i = 0; i < KG; ++i) {
          const int k = k0 + i;
          wv[i] = k < k_end ? __ldg(wl + at(k, W, c0 + lane)) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < KG; i += 4) {
          if (k0 + i < k_end) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float4 hv =
                  *reinterpret_cast<const float4*>(h + r * W + k0 + i);
              acc[r] = fmaf(hv.x, wv[i], acc[r]);
              acc[r] = fmaf(hv.y, wv[i + 1], acc[r]);
              acc[r] = fmaf(hv.z, wv[i + 2], acc[r]);
              acc[r] = fmaf(hv.w, wv[i + 3], acc[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) red[(warp * R + r) * CHUNK + lane] = acc[r];
      __syncthreads();
      if (threadIdx.x < R * CHUNK) {
        const int r = threadIdx.x / CHUNK;
        const int col = c0 + lane;
        float z = 0.0f;
        for (int s = 0; s < WARPS; ++s)
          z = __fadd_rn(z, red[(s * R + r) * CHUNK + lane]);
        const float v = activate(a.act, __fadd_rn(z, bias));
        if (row0 + r < a.batch) out[at(row0 + r, W, col)] = v;
        h_next[r * W + col] = v;
      }
      __syncthreads();
    }
    gather_panel(cluster, h_next, R, W, cols, rank, cs, l + 1 < a.depth);
    cur = 1 - cur;
  }
}

// ---------------------------------------------------------------------------
// K3b pass 1: the dh chain, last layer first, with the pre-update weights:
// dh = dz_l @ w[l]^T, dz_{l-1} = dh * act'(a_{l-1}). The same clusters and
// the same hand-off as K3: each block computes its own columns of dz_{l-1}
// (of dh0 at l = 0) into its own shared memory, and after the cluster
// barrier the others copy them. A panel is read-only once it is complete:
// a block writes into a panel only the columns it owns, only before the
// barrier that hands them over, and only after the barrier by which every
// block has finished copying from that panel the layer before.
// Shared memory: dz[2][R][W]. Writes the dz stack (each block its own
// columns) and dh0.
// ---------------------------------------------------------------------------
constexpr int JG = 4;  // columns j a warp takes at once (one float4)
constexpr int KL = 8;  // k a lane takes in one batch of loads

// One batch of pass 1's w loads: w[l][j0 + jj][k] for k = k0 + 32 i.
__device__ __forceinline__ void load_backward_batch(float (&wv)[JG][KL],
                                                    const BackwardArgs& a,
                                                    int l, int j0, int k0) {
  const int W = a.width;
  const float* wl = a.w + static_cast<long long>(l) * W * W;
#pragma unroll
  for (int jj = 0; jj < JG; ++jj)
#pragma unroll
    for (int i = 0; i < KL; ++i) {
      const int k = k0 + 32 * i;
      wv[jj][i] = k < W ? __ldg(wl + at(j0 + jj, W, k)) : 0.0f;
    }
}

template <int R>
__global__ void __launch_bounds__(THREADS)
stream_backward_dh_kernel(const __grid_constant__ BackwardArgs a) {
  static_assert(JG == 4, "a lane hands over its JG columns as one float4");
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int W = a.width;
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / cs) * R;
  const int cols = W / cs;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  // as in K3, w does not depend on dh: the next batch of loads, the next
  // layer's at the end of a layer, is issued as soon as this one is used
  float wv[JG][KL];
  load_backward_batch(wv, a, a.depth - 1, rank * cols + warp * JG, lane);

  // the last layer's dz, from the loss gradient: every block makes its
  // whole panel itself (rows past the batch are 0)
  {
    const long long off = static_cast<long long>(a.depth - 1) * a.batch * W;
    for (int i = threadIdx.x; i < R * W; i += THREADS) {
      const int r = i / W;
      const int k = i % W;
      float v = 0.0f;
      if (row0 + r < a.batch) {
        v = __fmul_rn(a.dlast[at(row0 + r, W, k)],
                      activation_grad(a.act, a.acts[off + at(row0 + r, W, k)]));
        if (k >= rank * cols && k < (rank + 1) * cols)
          a.dz[off + at(row0 + r, W, k)] = v;
      }
      smem[i] = v;
    }
  }
  __syncthreads();

  int cur = 0;
  for (int l = a.depth - 1; l >= 0; --l) {
    const float* dz = smem + cur * R * W;
    float* dz_prev = smem + (1 - cur) * R * W;
    const long long off_prev = static_cast<long long>(l - 1) * a.batch * W;
    // dh[r][j] = sum_k dz[r][k] w[l][j][k] for this block's columns j: a
    // warp takes JG neighbouring j at a time, its lanes neighbouring k (one
    // 128-byte line of a row of w per load, JG x KL loads in flight), then
    // sums the lanes in a fixed tree; lane r < R ends with row r's JG sums
    for (int j0 = rank * cols + warp * JG; j0 < (rank + 1) * cols;
         j0 += WARPS * JG) {
      // lane r's act' operand, a_{l-1}[r][j0, j0 + JG), in flight during
      // the products
      const bool own_row = lane < R && row0 + lane < a.batch;
      float4 ap = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (l > 0 && own_row)
        ap = __ldg(reinterpret_cast<const float4*>(
            a.acts + off_prev + at(row0 + lane, W, j0)));
      float acc[JG][R];
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[jj][r] = 0.0f;
      for (int k0 = lane; k0 < W; k0 += 32 * KL) {
#pragma unroll
        for (int i = 0; i < KL; ++i) {
          const int k = k0 + 32 * i;
          if (k < W) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float d = dz[r * W + k];
#pragma unroll
              for (int jj = 0; jj < JG; ++jj)
                acc[jj][r] = fmaf(d, wv[jj][i], acc[jj][r]);
            }
          }
        }
        // the next batch: the next k of these j, else the next j, else
        // the layer below's first
        int nl = l, nj = j0, nk = k0 + 32 * KL;
        if (nk >= W) {
          nk = lane;
          nj += WARPS * JG;
          if (nj >= (rank + 1) * cols) {
            nj = rank * cols + warp * JG;
            --nl;
          }
        }
        if (nl >= 0) load_backward_batch(wv, a, nl, nj, nk);
      }
      float dh[JG];
#pragma unroll
      for (int jj = 0; jj < JG; ++jj) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int off = 16; off > 0; off /= 2)
            acc[jj][r] = __fadd_rn(
                acc[jj][r], __shfl_xor_sync(0xffffffffu, acc[jj][r], off));
        // lane r keeps row r's sum (its own fixed order)
        dh[jj] = acc[jj][0];
#pragma unroll
        for (int r = 1; r < R; ++r)
          if (lane == r) dh[jj] = acc[jj][r];
      }
      if (lane < R) {
        float4 v = make_float4(dh[0], dh[1], dh[2], dh[3]);
        if (l > 0) {
          v.x = __fmul_rn(v.x, activation_grad(a.act, ap.x));
          v.y = __fmul_rn(v.y, activation_grad(a.act, ap.y));
          v.z = __fmul_rn(v.z, activation_grad(a.act, ap.z));
          v.w = __fmul_rn(v.w, activation_grad(a.act, ap.w));
          if (own_row)
            *reinterpret_cast<float4*>(a.dz + off_prev +
                                       at(row0 + lane, W, j0)) = v;
        } else if (own_row) {
          *reinterpret_cast<float4*>(a.dh0 + at(row0 + lane, W, j0)) = v;
        }
        *reinterpret_cast<float4*>(dz_prev + lane * W + j0) = v;
      }
    }
    gather_panel(cluster, dz_prev, R, W, cols, rank, cs, l > 0);
    cur = 1 - cur;
  }
}

// One element's optimizer update: the shared rule (csrc/optim_rules.cuh) on
// w and the slots the rule has, in place.
__device__ __forceinline__ void update_element(const BackwardArgs& a,
                                               long long i, float g) {
  const int n_slots = tinynn::rule_slots(a.rule.opt);
  float s0 = n_slots > 0 ? a.slot0[i] : 0.0f;
  float s1 = n_slots > 1 ? a.slot1[i] : 0.0f;
  a.w[i] = tinynn::apply_rule(a.rule, a.w[i], g, s0, s1);
  if (n_slots > 0) a.slot0[i] = s0;
  if (n_slots > 1) a.slot1[i] = s1;
}

// ---------------------------------------------------------------------------
// K3b pass 2: grid (tiles of dW[l], layers). dW[l] = h_in^T @ dz[l], with
// h_in = acts[l-1] (h0 for layer 0), over the batch in BK-deep stages; each
// thread then updates its 4x4 weights.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
stream_backward_update_kernel(const __grid_constant__ BackwardArgs a) {
  __shared__ __align__(16) float As[BK][BM + PAD];  // As[b][i] = h_in[b][i]
  __shared__ __align__(16) float Bs[BK][BN + PAD];  // Bs[b][j] = dz[b][j]
  const int W = a.width;
  const int B = a.batch;
  const int l = blockIdx.y;
  const float* hin =
      l == 0 ? a.h0 : a.acts + static_cast<long long>(l - 1) * B * W;
  const float* dz = a.dz + static_cast<long long>(l) * B * W;
  const int tiles_n = (W + BN - 1) / BN;
  const int i0 = (blockIdx.x / tiles_n) * BM;
  const int j0 = (blockIdx.x % tiles_n) * BN;
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);

  // the tiles of the first tile row also sum db, one thread a column
  const bool db_column = i0 == 0 && threadIdx.x < BN && j0 + threadIdx.x < W;
  float db_sum = 0.0f;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int b0 = 0; b0 < B; b0 += BK) {
#pragma unroll
    for (int it = 0; it < (BK * BM) / THREADS; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int kk = idx / BM;
      const int c = idx % BM;
      const bool in_b = b0 + kk < B;
      As[kk][c] = (in_b && i0 + c < W) ? hin[at(b0 + kk, W, i0 + c)] : 0.0f;
      Bs[kk][c] = (in_b && j0 + c < W) ? dz[at(b0 + kk, W, j0 + c)] : 0.0f;
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
    if (db_column) {
      // rows in order; the zero padding past the batch adds nothing
      for (int kk = 0; kk < BK; ++kk)
        db_sum = __fadd_rn(db_sum, Bs[kk][threadIdx.x]);
    }
    __syncthreads();
  }

  const long long base = static_cast<long long>(l) * W * W;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = i0 + ty * TM + i;
    if (gi >= W) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = j0 + tx * TN + j;
      if (gj < W) update_element(a, base + at(gi, W, gj), acc[i][j]);
    }
  }

  if (db_column)
    a.db[static_cast<long long>(l) * W + j0 + threadIdx.x] = db_sum;
}

// The cluster size: the most blocks, up to 8, that split W into equal runs
// of whole CHUNKs.
int cluster_size(int width) {
  const int chunks = width / CHUNK;
  for (int cs = MAX_CLUSTER; cs > 1; --cs)
    if (chunks % cs == 0) return cs;
  return 1;
}

// Launches `kernel` on clusters of cluster_size(width) blocks, each cluster
// on R rows.
template <int R, class Args>
cudaError_t launch_clusters(void (*kernel)(Args), const Args& args, int batch,
                            int width, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int cs = cluster_size(width);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((batch + R - 1) / R) * cs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

size_t forward_smem(int rows, int width) {
  return sizeof(float) * (2 * static_cast<size_t>(rows) * width +
                          WARPS * rows * CHUNK);
}

size_t backward_smem(int rows, int width) {
  return sizeof(float) * 2 * static_cast<size_t>(rows) * width;
}

// pass 2's grid holds the layers in its y dimension (at most 65535)
bool valid_shape(int depth, int batch, int width) {
  return depth >= 1 && depth <= 65535 && batch >= 1 && width >= CHUNK &&
         width % CHUNK == 0 && forward_smem(1, width) <= SMEM_LIMIT &&
         backward_smem(1, width) <= SMEM_LIMIT;
}

}  // namespace

// K3: acts[l] = act(acts[l-1] @ w[l] + b[l]), acts[-1] = h0, for the depth
// layers. Launches on `stream` and does not synchronise. Returns the CUDA
// error of the launch (0 when it was accepted).
extern "C" int tinynn_stream_forward(const float* h0, const float* w,
                                     const float* b, float* acts, int depth,
                                     int batch, int width, int act,
                                     void* stream) {
  if (!valid_shape(depth, batch, width))
    return static_cast<int>(cudaErrorInvalidValue);
  const ForwardArgs args = {h0, w, b, acts, depth, batch, width, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (forward_smem(8, width) <= SMEM_LIMIT)
    return static_cast<int>(launch_clusters<8>(stream_forward_kernel<8>, args,
                                               batch, width,
                                               forward_smem(8, width), s));
  return static_cast<int>(launch_clusters<1>(
      stream_forward_kernel<1>, args, batch, width, forward_smem(1, width), s));
}

// K3b: the backward of K3's layers from the loss gradient `dlast` at the
// last layer's output, with the optimizer's update of w and its slots in
// place (see update_element for `opt`, the scalars and the constants).
// Writes db and dh0; `dz` is an [L, B, W] scratch. Two kernels on `stream`
// (pass 1, then pass 2), no synchronisation. Returns the first CUDA error
// (0 when both launches were accepted).
extern "C" int tinynn_stream_backward(
    const float* h0, const float* dlast, const float* acts, float* w,
    float* slot0, float* slot1, float* db, float* dh0, float* dz, int depth,
    int batch, int width, int act, int opt, float s0, float s1, float c0,
    float c1, float c2, float c3, float wd, void* stream) {
  if (!valid_shape(depth, batch, width) || opt < kSGD || opt > kAdadelta)
    return static_cast<int>(cudaErrorInvalidValue);
  const BackwardArgs args = {h0,    dlast, acts,  w,     slot0,
                             slot1, db,    dh0,   dz,    depth,
                             batch, width, act,
                             {opt, s0, s1, c0, c1, c2, c3, wd}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (backward_smem(8, width) <= SMEM_LIMIT)
    err = launch_clusters<8>(stream_backward_dh_kernel<8>, args, batch, width,
                             backward_smem(8, width), s);
  else
    err = launch_clusters<1>(stream_backward_dh_kernel<1>, args, batch, width,
                             backward_smem(1, width), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((width + BM - 1) / BM) * ((width + BN - 1) / BN);
  stream_backward_update_kernel<<<dim3(tiles, depth), THREADS, 0, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}
