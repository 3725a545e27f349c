// Whole-epoch training kernel for Hopper (sm_90a): forward, softmax
// cross-entropy, backward and the optimizer for every step of an epoch, in
// one cooperative launch.
//
// Replaces the TPU kernel `kernel` inside `build_fused_epoch`
// (tinynn_autograd_tpu/ops/fused_epoch.py:159). There the grid is
// (n_steps,), run in order on one core; the parameters and optimizer moments
// sit in VMEM scratch across the grid steps and each step streams in one
// (x, y) batch block. Its body is traced from the tape. Here the body is
// written out for the layers it takes: Dense, each followed by at most one
// ReLU, Sigmoid or Tanh and at most one Dropout (Flatten is a reshape done
// by the caller), softmax cross-entropy with optional class weights, and the
// seven optimizer rules of nn/optimizer.py (csrc/optim_rules.cuh, shared
// with K3b) with weight decay, any learning-rate schedule (the per-step
// scalars come from the host) and global-norm gradient clipping.
//
// How the TPU design translates:
// - The sequential grid becomes a loop over the steps inside ONE persistent
//   cooperative launch of thread block clusters of CLUSTER blocks, at most
//   as many as the card holds at once (cudaOccupancyMaxActiveClusters; the
//   plan takes fewer where the barriers cost more than the blocks give),
//   with the phases of a step separated by grid-wide barriers (an arrival
//   count in device memory, added to with release and polled with acquire
//   semantics: phase_barrier). Per step: one phase per Dense forward, one
//   for the loss, one per Dense backward (dW, db and the previous layer's
//   dz together), one for the optimizer: 2 x layers + 2 barriers, 12 for
//   the flagship MLP (one more with clip_norm). Every gradient is taken
//   before any weight changes.
// - The state does not fit on an SM: the flagship's parameters and Adam
//   moments are 2.24 MB against 227 KB of shared memory per SM. They stay in
//   device memory, updated in place, with the gradients (0.75 MB) and the
//   activations (0.42 MB at batch 128); all of it stays resident in the
//   50 MB L2 across the steps, which plays VMEM's part. Data written inside
//   the launch is read through L2 (ld_cg, cp.async.cg), never from a stale
//   L1 line. The optimizer phase prefetches the next step's batch into L2.
// - Products: 32x32 output tiles, K in 32-deep stages. Both operands of a
//   stage are copied to shared memory with cp.async.cg, 16 bytes a copy
//   (one copy a thread an operand), in a ring of NSTAGE stages: the copies
//   of the next stages are in flight while a stage is multiplied, so a stage
//   costs about one L2 round trip and not one a load. cp.async.cg needs
//   16-byte aligned rows: the activations, the loss gradients (z, h, d, dz)
//   and a copy of each weight (wp) keep rows of `pitch` floats, the width
//   rounded up to whole float4s; wp is written beside w by the optimizer
//   (and filled from w before the first step) where w's own rows are not
//   aligned, else it is w. Each operand is copied along its unit stride
//   and multiplied as it lies: A as [k][m] or [m][k], B as [k][n] or [n][k]
//   (the products' templates), so no transposed copy is needed. A block's
//   threads multiply in four k-groups of 64, each thread a 4x4 register
//   tile read as float4s (64 FMAs to 8 shared loads); the groups' sums are
//   added in order at the end of the slice. What the tile's epilogue reads
//   (the bias row; the layer below's z or h for dh) comes in with the
//   first stage's copies.
// - Split-K in thread block clusters. A host-side plan (plan_epoch in
//   ops/fused_epoch.py) gives each product (each layer's forward, dW and
//   dh) a K-split s <= CLUSTER: the s blocks of a cluster group share a
//   tile, each taking a slice of whole stages. Block j of the group reduces
//   rows [j rows, (j + 1) rows) of the tile: every block of the group
//   writes those rows of its partial tile into block j's shared memory
//   (distributed shared memory, no wait), and after a cluster barrier block
//   j sums them, slice 0 first, and runs the layer's epilogue (bias,
//   activation, Dropout; dz). The barrier that frees the partial rows again
//   is only waited for before they are next written. Each output element's
//   sum runs in a fixed order: in its slice, each k-group's products in K
//   order, the groups in order; then the slices in order. No float
//   atomics, so two runs on the same inputs give bit-identical results.
// - db goes with dW: the dW product's A (the layer input, transposed) gets
//   one more row of ones, so db is the last row of [dW; db] and is summed
//   in the same order as a weight gradient.
// - Dropout: the TPU kernel draws its masks from the core's generator, in
//   interpret mode from a counter hash. Here the hash (csrc/hash.cuh, the
//   same as P1's) gives each element of a Dense's output its bits from the
//   element's row-major index in [batch, dout] and the seed of (step, layer),
//   (t0 + i) * 1000003 + idx in wrapping 32-bit arithmetic: the JAX
//   megakernel's seeds, so the masks are its masks. The forward's epilogue
//   writes the dropped output beside the activation's (the next layer reads
//   it; the activation's derivative needs the one before dropout), and the
//   backward recomputes the same bits in the epilogue that forms the
//   previous layer's dz: cheaper than storing a mask, and each thread
//   hashes the index of its own element.
// - The loss: one thread a row loads its logits, labels and z together
//   into registers, then runs the tape's sequence of rounded operations; the
//   batch mean is summed in row order by one thread from shared memory.
// - The optimizer and clip_norm walk the gradients as float4 units: each
//   leaf starts on a whole float4 of the gradient rows (grad_layout in
//   ops/fused_epoch.py), and a thread issues the loads of two units
//   (gradient, parameter, slots) before any store. clip_norm: each block
//   sums g^2 over a fixed share of the units (units, then their elements, in
//   order) and reduces it in a fixed order in shared memory; after a grid
//   barrier every block sums the per-block partial sums in one fixed order.
// - Ranks (K6, the data-parallel megakernel): the JAX package runs this
//   kernel on each device of a mesh axis, on the device's batch shard, and
//   between the backward and the optimizer sums the gradients over the
//   axis with an in-kernel ring of remote DMAs (`grad_ring_all_reduce`,
//   tinynn_autograd_tpu/ops/fused_epoch.py:114), then takes their mean.
//   Here n ranks share the card in ONE launch: the co-resident clusters,
//   rounded down to a multiple of n, are split into n groups, and each rank
//   runs every phase on its own replica, slots, gradients, activations and
//   batch shard, with the barriers above over its own blocks only (a
//   cluster never straddles two ranks). Its layer table (pointers to all
//   that) sits in device memory, copied to shared memory at the start: 16
//   layers a rank would pass the launch's 4 KB parameter limit at two
//   ranks. The exchange (csrc/ring.cuh, the device code of P3) takes the
//   last backward's barrier and one more phase: the all-rank arrival, then
//   each rank's pass sums every rank's flat gradient buffer in the ring's
//   order, times 1/n, into a buffer of its own, so clip_norm and the rule
//   act on the mean, as the JAX optimizer does after its ring. The
//   gradients are double-buffered by step parity: step s writes plane
//   s % 2, so a rank that runs ahead writes step s + 1's gradients while
//   slower ranks still read step s's, and it reaches step s + 2's only
//   after step s + 1's arrival, which every rank makes after its pass of
//   step s. Rank r seeds its Dropouts with step t + 7919 r (the JAX
//   kernel's offset). Ranks meet only through the exchange's counts, never
//   a grid barrier. With one rank there is no exchange, and the result is
//   the single-device kernel's, bit for bit.
// - f32 everywhere. With `bf16` set (set_matmul_precision("bf16")), each
//   product operand is rounded to bf16 as it is read from shared memory
//   (db, the row of ones, sums dz unrounded, as sum(dz) does), and the
//   products accumulate in f32, as the TPU kernel's bf16 operands with f32
//   accumulation do. The
//   loss and optimizer arithmetic use the _rn intrinsics so that the
//   compiler does not contract them into FMAs: they round where the plain
//   PyTorch version rounds.
//
// What bounds it: a flagship step (784-200-100-70-30-10, batch 128) is
// about 102.9 MFLOP of products (forward, weight gradients, input gradients
// but the first layer's), which at the H100's 67 TFLOP/s f32 FMA peak is
// about 1.54 us a step, 0.60 ms for a 390-step epoch: compute-bound. The
// bytes it must move are about 163 MB an epoch, mostly the batches, about
// 49 us at 3.35 TB/s. With n ranks at a global batch of 128 each rank
// does 1/n of the products on 1/n of the blocks; the exchange adds one
// all-rank arrival and one pass that reads the n ranks' 746 KB of
// gradients from L2 (see ring.cuh). What holds it back: latency, not
// work. Every phase is a chain of round trips (the stage copies, the
// k-groups' and the slices' sums, the epilogue's stores, the barrier),
// 12 phases a step (PERF.md §5).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <vector>

#include "hash.cuh"
#include "optim_rules.cuh"
#include "ring.cuh"

namespace cg = cooperative_groups;

namespace {

using tinynn::global_ns;
using tinynn::ld_cg;
using tinynn::ld_cg4;

constexpr int MAX_LAYERS = 16;
constexpr int MAX_LEAVES = 2 * MAX_LAYERS;
constexpr int THREADS = 256;
constexpr int TILE = 32;          // output tile edge
constexpr int BK = 32;            // depth of one shared-memory stage
constexpr int NSTAGE = 5;         // stages in flight
constexpr int CLUSTER = 8;        // blocks a cluster: the portable maximum
constexpr int SPITCH = BK + 4;    // a stage row: 16-byte aligned, and the
                                  // float4 reads of 8 rows hit 32 banks
constexpr int STAGE_FLOATS = TILE * SPITCH;  // one operand's stage
constexpr int PTRS_PER_LAYER = 13;
constexpr int PLAN_PER_LAYER = 3;
constexpr int LOSS_REGS = 16;     // classes a row loss keeps in registers

enum Act { kNone = 0, kReLU = 1, kSigmoid = 2, kTanh = 3 };

struct Layer {
  int din, dout, act;
  int drop;             // 1 when a Dropout follows the layer (rate > 0)
  int pitch;            // row pitch of z, h, d, dz and wp (floats): dout
                        // rounded up to whole float4s
  int split_fwd, split_dw, split_dh;  // the plan: K slices of each product
  uint32_t seed_index;  // the Dropout's position among the seeded layers
  uint32_t threshold;   // keep where the hash's bits are below it
  float scale;          // 1 / (1 - rate), as f32
  float* w;    // [din, dout], updated in place
  float* b;    // [1, dout], updated in place
  float* gw;   // gradients, same shapes, in plane 0 of the gradient rows
  float* gb;
  float* s0w;  // the rule's first slot (null when it has none)
  float* s0b;
  float* s1w;  // its second slot (null when it has none)
  float* s1b;
  float* z;    // pre-activation [batch, pitch]
  float* h;    // activation output [batch, pitch]; == z without activation
  float* d;    // the Dropout's output [batch, pitch] (null without one)
  float* dz;   // loss gradient with respect to z [batch, pitch]
  float* wp;   // w with rows `pitch` apart: w itself where its rows are
               // 16-byte aligned, else a copy the optimizer keeps
  const float* out;  // what the next layer reads: d with a Dropout, else h
};

struct Args {
  int n_layers, batch, n_steps, bf16;
  uint32_t t0;           // the optimizer's step count before the epoch
  float clip_norm;       // global-norm clipping of the gradients; 0 is off
  tinynn::Rule rule;     // the rule, its constants and weight decay; the
                         // scalars s0, s1 are set each step
  int n_ranks, blocks;   // the ranks, and the blocks each rank takes
  int x_pitch;           // the row pitch of xb (floats, a multiple of 4)
  const Layer* tables;   // [n_ranks][MAX_LAYERS] in device memory: each
                         // rank's layers (its own replica and scratch)
  const float* xb;       // [n_ranks, n_steps, batch, x_pitch]
  const float* yb;       // [n_ranks, n_steps, batch, dout of the last]
  const float* cw;       // class weights [dout of the last layer] or null
  const float* scalars;  // [n_steps, 2]: each step's (s0, s1)
  float* losses;         // [n_ranks, n_steps]: each rank's batch mean
  float* partial;        // [n_ranks, blocks] scratch: clip_norm's partials
  float* grads;          // [planes, n_ranks, grad_stride]: each rank's
  long long n_grad;      // n_grad gradients (grad_layout: every leaf on a
  long long grad_stride; // whole float4), which its layers' gw and gb
                         // point into in plane 0. With ranks, 3 planes:
                         // the gradients of even steps, of odd steps,
                         // and each rank's mean after the exchange
  unsigned* sync;        // [n_ranks][tinynn::kSyncWords] counts, zeroed
  tinynn::Skew skew;     // a debug hold of one rank before each arrival
  float ring_scale;      // 1 / n_ranks as f32: the mean after the exchange
  // [2 * n_layers + 2, one more with ranks and one with clip_norm] or
  // null: block 0's time (ns) from one barrier to the next, summed over the
  // steps, for each phase: the forwards, the loss, the backwards (last
  // layer first; with ranks the last ends with block 0's own share), the
  // exchange (the all-rank arrival, every wait between ranks and blocks
  // included, and the pass), the clipping norm, the optimizer
  unsigned long long* phase_ns;
};

// The block's rank's layers, copied from its table at the start: read from
// shared memory as the single-rank kernel read them from its parameters.
__shared__ Layer layers[MAX_LAYERS];
// The gradient rows' leaves (w0, b0, w1, b1, ...): where each ends, in
// float4 units from the start of a rank's row.
__shared__ long long leaf_end[MAX_LEAVES];

// One block's view of its rank: its shard of the batches, its outputs and
// scratch, and where it sits.
struct Rank {
  const float* xb;
  const float* yb;
  float* losses;
  float* partial;
  float* grads;
  int block, blocks;  // the block's index among the rank's blocks
};

constexpr int RPITCH = TILE + 8;  // a row of the k-groups' sums: 8 rows
                                  // of 8 threads' stores hit 32 banks
// split-K: a block of a group of g reduces ceil(32 / g) rows of the tile,
// from each of the g slices; at most 6 x 6 x 32 floats (g = 6)
constexpr int PART_FLOATS = TILE * (TILE + 4);
constexpr int part_floats(int g) { return g * ((TILE + g - 1) / g) * TILE; }
constexpr bool parts_fit(int g) {
  return g > CLUSTER || (part_floats(g) <= PART_FLOATS && parts_fit(g + 1));
}
static_assert(parts_fit(1), "every group's partial rows fit in part");

struct Smem {
  // the stages of A ([k][m] or [m][k]) and B ([k][n] or [n][k]); between
  // products the k-groups' sums, the loss rows and reduction scratch
  float ring[2 * NSTAGE * STAGE_FLOATS];
  // split-K: the slices' partial sums of the rows this block reduces,
  // [slice][row][column], written by the group's blocks
  float part[PART_FLOATS];
  float epi[TILE * TILE];   // what the tile's epilogue reads: the bias
                            // (forward) or the layer below's z or h (dh)
  __device__ __forceinline__ float* a(int s) { return ring + s * STAGE_FLOATS; }
  __device__ __forceinline__ float* b(int s) {
    return ring + (NSTAGE + s) * STAGE_FLOATS;
  }
};
static_assert(4 * TILE * RPITCH <= 2 * NSTAGE * STAGE_FLOATS,
              "the k-groups' sums fit in the ring");

// ---------------------------------------------------------------------------
// copies and barriers
// ---------------------------------------------------------------------------

// cp.async of 16 bytes through L2 only (never L1: other blocks rewrite the
// operands between phases); of the `bytes` read, the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The cluster barrier in two halves: an arrival (release: this block's
// shared-memory writes are visible to the cluster once every block has
// arrived) and a wait (acquire). Every thread of every block calls both.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A float rounded to bf16 and widened again.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// one K slice of one output tile
// ---------------------------------------------------------------------------

// A matrix as a product reads it: rows `pitch` floats apart (a multiple of
// 4), p 16-byte aligned. A's element (i, k) is p[i * pitch + k], or with
// kAT p[k * pitch + i]; B's (k, j) is p[k * pitch + j], or with kBT
// p[j * pitch + k].
struct Operand {
  const float* p;
  int pitch;
};

// The 16 bytes this thread copies of a 32x32 tile of a matrix (rows
// o.pitch apart) to `st` (rows `pitch` apart): row q = tid / 8, columns
// e = 4 (tid % 8) to e + 3. `outer` and `inner` are the tile's first row
// and column, `n_outer` and `n_inner` the bounds past which it reads
// zeros.
__device__ __forceinline__ void copy16(const Operand& o, float* st,
                                       int outer, int inner, int n_outer,
                                       int n_inner, int pitch = SPITCH) {
  const int q = threadIdx.x >> 3;
  const int e = (threadIdx.x & 7) * 4;
  const int row = outer + q;
  const int col = inner + e;
  int valid = 0;
  if (row < n_outer) {
    valid = n_inner - col;
    valid = valid < 0 ? 0 : (valid > 4 ? 4 : valid);
  }
  const float* src =
      valid ? o.p + static_cast<long long>(row) * o.pitch + col : o.p;
  cp_async16(st + q * pitch + e, src, 4 * valid);
}

// Copies stage [ks, ks + BK) of K (cut at k_end) of the tile at (r0, c0) of
// C[m, n] = A @ B into the ring's slot.
template <bool kAT, bool kBT>
__device__ __forceinline__ void load_stage(const Operand& A, const Operand& B,
                                           int m, int n, int r0, int c0,
                                           int ks, int k_end, float* as,
                                           float* bs) {
  if (kAT) copy16(A, as, ks, r0, k_end, m);  // as[k][i]
  else copy16(A, as, r0, ks, m, k_end);      // as[i][k]
  if (kBT) copy16(B, bs, c0, ks, n, k_end);  // bs[j][k]
  else copy16(B, bs, ks, c0, k_end, n);      // bs[k][j]
}

// After this thread's copies of a stage have landed: the row of ones of
// [dW; db] (A's row `ones`) written where this thread's copy of A covered
// it (the copy read zeros there).
__device__ __forceinline__ void fix_ones(float* as, int r0, int ks,
                                         int k_end, int ones) {
  const int q = threadIdx.x >> 3;
  const int e = (threadIdx.x & 7) * 4;
  const int i = ones - r0 - e;
  if (i >= 0 && i < 4 && ks + q < k_end) as[q * SPITCH + e + i] = 1.0f;
}

// The threads of a block share a tile in four k-groups of 64: group g
// multiplies k = 8 g to 8 g + 7 of each stage. In a group, thread (ty, tx)
// (8 x 8) owns 4 x 4 outputs: rows 4 ty + r where A lies k-major in shared
// memory, ty + 8 r where it lies m-major, and columns 4 tx + c where B lies
// k-major, tx + 8 c where it lies n-major: each read is one float4 (four
// rows or columns at one k, or four k of one row or column), conflict-free
// at the SPITCH pitch. 64 FMAs to 8 shared loads.
template <bool kAT>
__device__ __forceinline__ int row_of(int ty, int r) {
  return kAT ? 4 * ty + r : ty + 8 * r;
}
template <bool kBT>
__device__ __forceinline__ int col_of(int tx, int c) {
  return kBT ? tx + 8 * c : 4 * tx + c;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// The products of one landed stage on this thread's k-group, k in order.
// With kBF16 each operand is rounded to bf16 as it is read from shared
// memory, but for the row of ones (`one[r]`: the thread's row r is db's),
// which sums B as it is, in f32, as db = sum(dz) does.
template <bool kAT, bool kBT, bool kBF16>
__device__ __forceinline__ void fma_stage(const float* as, const float* bs,
                                          const bool one[4],
                                          float acc[4][4]) {
  const int lt = threadIdx.x % 64;
  const int ty = lt / 8;
  const int tx = lt % 8;
  const int kg = threadIdx.x / 64;
#pragma unroll
  for (int k4 = 0; k4 < 8; k4 += 4) {
    const int kk = 8 * kg + k4;
    float av[4][4], bv[4][4], braw[4][4];  // [row or column][u]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kAT) {  // as[k][m]: rows 4 ty .. 4 ty + 3 at k = kk + i
        const float4 v =
            *reinterpret_cast<const float4*>(as + (kk + i) * SPITCH + 4 * ty);
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r][i] = comp(v, r);
      } else {    // as[m][k]: row ty + 8 i at k = kk .. kk + 3
        const float4 v = *reinterpret_cast<const float4*>(
            as + (ty + 8 * i) * SPITCH + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) av[i][u] = comp(v, u);
      }
      if (kBT) {  // bs[n][k]: column tx + 8 i at k = kk .. kk + 3
        const float4 v = *reinterpret_cast<const float4*>(
            bs + (tx + 8 * i) * SPITCH + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) braw[i][u] = comp(v, u);
      } else {    // bs[k][n]: columns 4 tx .. 4 tx + 3 at k = kk + i
        const float4 v =
            *reinterpret_cast<const float4*>(bs + (kk + i) * SPITCH + 4 * tx);
#pragma unroll
        for (int c = 0; c < 4; ++c) braw[c][i] = comp(v, c);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        bv[i][u] = kBF16 ? bf16_round(braw[i][u]) : braw[i][u];
        if (kBF16) av[i][u] = bf16_round(av[i][u]);
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = fmaf(av[r][u],
                           kBF16 && kAT && one[r] ? braw[c][u] : bv[c][u],
                           acc[r][c]);
  }
}

// out := this thread's four outputs, elements tid, tid + 256, tid + 512,
// tid + 768 of the row-major 32x32 tile at (r0, c0) (row tid / 32 + 8 i,
// column tid % 32), of A @ B over K slice [k0, k1): stages in a ring of
// NSTAGE, the copies of the next NSTAGE - 1 in flight while one is
// multiplied, one wait and one barrier a stage; then the four k-groups'
// sums added in order, group 0 first, through the ring's room. The whole
// block calls it.
template <bool kAT, bool kBT, bool kBF16>
__device__ void slice_product(const Operand& A, const Operand& B, int m,
                              int n, int r0, int c0, int k0, int k1,
                              int ones, Smem& sm, float out[4]) {
  const int stages = (k1 - k0 + BK - 1) / BK;
  const int lt = threadIdx.x % 64;
  const int ty = lt / 8;
  const int tx = lt % 8;
  bool one[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    one[r] = ones >= 0 && r0 + row_of<kAT>(ty, r) == ones;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < stages)
      load_stage<kAT, kBT>(A, B, m, n, r0, c0, k0 + s * BK, k1, sm.a(s),
                           sm.b(s));
    cp_async_commit();
  }
  for (int t = 0; t < stages; ++t) {
    cp_async_wait<NSTAGE - 2>();
    const int slot = t % NSTAGE;
    if (kAT && ones >= 0) fix_ones(sm.a(slot), r0, k0 + t * BK, k1, ones);
    __syncthreads();
    // the slot multiplied in the step before is free: refill it
    const int next = t + NSTAGE - 1;
    if (next < stages)
      load_stage<kAT, kBT>(A, B, m, n, r0, c0, k0 + next * BK, k1,
                           sm.a(next % NSTAGE), sm.b(next % NSTAGE));
    cp_async_commit();
    fma_stage<kAT, kBT, kBF16>(sm.a(slot), sm.b(slot), one, acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring
  float* red = sm.ring + (threadIdx.x / 64) * TILE * RPITCH;  // [32][40]
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float* row = red + row_of<kAT>(ty, r) * RPITCH;
    if (kBT) {
#pragma unroll
      for (int c = 0; c < 4; ++c) row[col_of<kBT>(tx, c)] = acc[r][c];
    } else {
      *reinterpret_cast<float4*>(row + 4 * tx) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = (threadIdx.x / TILE + 8 * i) * RPITCH + threadIdx.x % TILE;
    float v = sm.ring[e];
#pragma unroll
    for (int g = 1; g < 4; ++g)
      v = __fadd_rn(v, sm.ring[g * TILE * RPITCH + e]);
    out[i] = v;
  }
  __syncthreads();  // the ring is free for the next slice
}

// ---------------------------------------------------------------------------
// epilogues
// ---------------------------------------------------------------------------

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

// The activation's VJP, as the tape's: ReLU passes g where z >= 0 (the
// subgradient at 0 is 1); Sigmoid and Tanh take their derivative from the
// output h.
__device__ __forceinline__ float activation_grad(int act, float g, float z,
                                                 float h) {
  switch (act) {
    case kReLU:
      return __fmul_rn(g, z >= 0.0f ? 1.0f : 0.0f);
    case kSigmoid:
      return __fmul_rn(__fmul_rn(g, h), __fsub_rn(1.0f, h));
    case kTanh:
      return __fmul_rn(g, __fsub_rn(1.0f, __fmul_rn(h, h)));
    default:
      return g;
  }
}

// The seed of layer L's Dropout in the step whose counter is `t`.
__device__ __forceinline__ uint32_t drop_seed(const Layer& L, uint32_t t) {
  return tinynn::layer_seed(t, L.seed_index);
}

// Layer L's Dropout on element o (its row-major index in [batch, dout]).
__device__ __forceinline__ float drop(const Layer& L, uint32_t seed,
                                      long long o, float v) {
  return tinynn::keeps(static_cast<uint32_t>(o), seed, L.threshold)
             ? __fmul_rn(v, L.scale)
             : 0.0f;
}

// The three products of a step and what each stores. `copy` brings what a
// tile's epilogue reads into `epi` with cp.async, in the product's first
// group of copies (the bias row for the forward; for dh the tile of the
// layer below's z (ReLU) or h (Sigmoid, Tanh)); `put` stores output
// element (r, c) of the tile at (r0, c0) from its sum.
enum Kind { kForward = 0, kWeightGrad = 1, kInputGrad = 2 };

struct Epilogue {
  int kind;
  const Layer* L;  // the layer of the product (kInputGrad: the layer below,
                   // whose dz it forms)
  uint32_t seed;   // that layer's Dropout seed this step
  float* gw;       // kWeightGrad: this step's plane of dW and db
  float* gb;

  __device__ __forceinline__ void copy(int r0, int c0, int m, int n,
                                       float* epi) const {
    if (kind == kForward) {
      if (threadIdx.x < TILE / 4) {
        const int c = c0 + 4 * threadIdx.x;
        int valid = n - c;
        valid = valid < 0 ? 0 : (valid > 4 ? 4 : valid);
        cp_async16(epi + 4 * threadIdx.x, valid ? L->b + c : L->b,
                   4 * valid);
      }
    } else if (kind == kInputGrad && L->act != kNone) {
      const Operand src = {L->act == kReLU ? L->z : L->h, L->pitch};
      copy16(src, epi, r0, c0, m, n, TILE);
    }
  }

  __device__ __forceinline__ void put(int r, int c, float v, int r0, int c0,
                                      const float* epi) const {
    if (kind == kWeightGrad) {
      if (r < L->din) gw[static_cast<long long>(r) * L->dout + c] = v;
      else gb[c] = v;  // the row of ones: db
      return;
    }
    const long long o = static_cast<long long>(r) * L->pitch + c;
    const long long flat = static_cast<long long>(r) * L->dout + c;
    if (kind == kForward) {
      const float z = __fadd_rn(v, epi[c - c0]);
      L->z[o] = z;
      float h = z;
      if (L->act != kNone) {
        h = activate(L->act, z);
        L->h[o] = h;
      }
      if (L->drop) L->d[o] = drop(*L, seed, flat, h);
    } else {
      const float g = L->drop ? drop(*L, seed, flat, v) : v;
      const float zh = L->act != kNone ? epi[(r - r0) * TILE + c - c0] : 0.0f;
      L->dz[o] = activation_grad(L->act, g, zh, zh);
    }
  }
};

// One product of a phase: C[m, n] = A @ B over K = k in `split` slices.
struct Job {
  int kind, m, n, k, split, tiles, tiles_n;
  Operand A, B;
  int ones;  // A's row of ones (kWeightGrad: din), else -1
  Epilogue epi;
};

__device__ __forceinline__ Job make_job(int kind, int m, int n, int k,
                                        int split, Operand A, Operand B,
                                        int ones, Epilogue epi) {
  const int tiles_n = (n + TILE - 1) / TILE;
  return {kind, m, n, k, split, ((m + TILE - 1) / TILE) * tiles_n, tiles_n,
          A, B, ones, epi};
}

// K slice j of `split`: whole stages, as evenly as they go (of K's s
// stages, j s / split to (j + 1) s / split); none is empty where split <=
// s. ops/fused_epoch.py's k_slices.
__device__ __forceinline__ void slice_of(int k, int split, int j, int* k0,
                                         int* k1) {
  const int stages = (k + BK - 1) / BK;
  *k0 = BK * (j * stages / split);
  *k1 = min(k, BK * ((j + 1) * stages / split));
}

template <bool kBF16>
__device__ void job_product(const Job& jb, int r0, int c0, int k0, int k1,
                            Smem& sm, float acc[4]) {
  switch (jb.kind) {
    case kForward:
      slice_product<false, false, kBF16>(jb.A, jb.B, jb.m, jb.n, r0, c0, k0,
                                         k1, -1, sm, acc);
      break;
    case kWeightGrad:
      slice_product<true, false, kBF16>(jb.A, jb.B, jb.m - 1, jb.n, r0, c0,
                                        k0, k1, jb.ones, sm, acc);
      break;
    default:
      slice_product<false, true, kBF16>(jb.A, jb.B, jb.m, jb.n, r0, c0, k0,
                                        k1, -1, sm, acc);
  }
}

// Split-K's second cluster barrier: each block arrives once it has read
// the partial rows written to it, and waits (settle) only before the
// group next writes partial rows, or before it leaves the kernel.
struct ClusterState {
  bool pending = false;
  __device__ __forceinline__ void settle() {
    if (pending) cluster_wait();
    pending = false;
  }
};

// Runs the products of one phase on the rank's clusters. The phase's group
// is its largest split: each cluster holds CLUSTER / group groups of
// `group` blocks, and round by round each group takes one tile (of the
// first job, then the second), block j of the group its K slice j. With
// group 1 each block stores its own tile; else block j of each group
// reduces rows [j rows, (j + 1) rows) of the tile: every block writes
// those rows of its partial tile into block j's shared memory (remote
// stores, no wait), and after the cluster barrier block j sums them,
// slice 0 first, and stores them.
__device__ __noinline__ void run_jobs(const Job* jobs, int n_jobs,
                                      const Rank& rk, bool bf16, Smem& sm,
                                      ClusterState& cs) {
  int group = 1, total = 0;
  for (int i = 0; i < n_jobs; ++i) {
    group = max(group, jobs[i].split);
    total += jobs[i].tiles;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = static_cast<int>(cluster.block_rank());
  const int per = CLUSTER / group;
  const int grp = crank / group;
  const int j = crank % group;
  const int n_clusters = rk.blocks / CLUSTER;
  const bool active = grp < per;
  const int slots = n_clusters * per;
  const int slot = grp * n_clusters + rk.block / CLUSTER;
  const int rounds = (total + slots - 1) / slots;
  const int rows = (TILE + group - 1) / group;  // a reducing block's rows
  for (int round = 0; round < rounds; ++round) {
    int u = round * slots + slot;
    const bool have = active && u < total;
    int ji = 0;
    while (ji + 1 < n_jobs && u >= jobs[ji].tiles) u -= jobs[ji++].tiles;
    const Job& jb = jobs[ji];
    const int r0 = (u / jb.tiles_n) * TILE;
    const int c0 = (u % jb.tiles_n) * TILE;
    // the elements this thread stores: its own four (group 1), or up to
    // two of the block's share of reduced rows
    auto element = [&](int e, int* r, int* c) {
      if (group == 1) {
        *r = r0 + threadIdx.x / TILE + 8 * e;
        *c = c0 + threadIdx.x % TILE;
        return have && *r < jb.m && *c < jb.n;
      }
      const int idx = threadIdx.x + e * THREADS;
      *r = r0 + j * rows + idx / TILE;
      *c = c0 + idx % TILE;
      return have && idx < TILE * rows && *r - r0 < TILE && *r < jb.m &&
             *c < jb.n;
    };
    __syncthreads();  // the round before is done with sm.epi
    if (have) jb.epi.copy(r0, c0, jb.m, jb.n, sm.epi);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const bool computes = have && j < jb.split;
    if (computes) {
      int k0, k1;
      slice_of(jb.k, jb.split, j, &k0, &k1);
      if (bf16) job_product<true>(jb, r0, c0, k0, k1, sm, acc);
      else job_product<false>(jb, r0, c0, k0, k1, sm, acc);
    } else {
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    if (group == 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, c;
        if (element(e, &r, &c)) jb.epi.put(r, c, acc[e], r0, c0, sm.epi);
      }
      continue;
    }
    cs.settle();
    if (computes) {
      // each partial row to the block of the group that reduces it
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = threadIdx.x + i * THREADS;
        const int row = e / TILE;
        const int owner = row / rows;
        float* dst = cluster.map_shared_rank(sm.part, grp * group + owner);
        dst[(j * rows + row - owner * rows) * TILE + e % TILE] = acc[i];
      }
    }
    cluster_arrive();
    cluster_wait();
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int r, c;
      if (!element(e, &r, &c)) continue;
      const int off = (r - r0 - j * rows) * TILE + (c - c0);
      float v = sm.part[off];
#pragma unroll
      for (int q = 1; q < CLUSTER; ++q)
        if (q < jb.split) v = __fadd_rn(v, sm.part[q * rows * TILE + off]);
      jb.epi.put(r, c, v, r0, c0, sm.epi);
    }
    cluster_arrive();  // this block's reads are done
    cs.pending = true;
  }
}

// The input of layer l in step `x` (the batch) as [batch, width] rows.
__device__ __forceinline__ Operand input_of(const Args& a, int l,
                                            const float* x) {
  if (l == 0) return {x, a.x_pitch};
  return {layers[l - 1].out, layers[l - 1].pitch};
}

// z = h_in @ w + b, h = act(z) and, with a Dropout, d = dropout(h), for one
// Dense layer in the step whose counter is `t`.
__device__ void forward_layer(const Args& a, const Rank& rk, int l,
                              const float* x, uint32_t t, Smem& sm,
                              ClusterState& cs) {
  const Layer& L = layers[l];
  const Epilogue epi = {kForward, &L, drop_seed(L, t), nullptr, nullptr};
  const Job job = make_job(kForward, a.batch, L.dout, L.din, L.split_fwd,
                           input_of(a, l, x), {L.wp, L.pitch}, -1, epi);
  run_jobs(&job, 1, rk, a.bf16 != 0, sm, cs);
}

// [dW; db] = [h_in, 1]^T @ dz and (but for the first layer) the previous
// layer's dz = act'(dropout'(dz @ W^T)), as one phase; the Dropout's VJP
// replays the forward's mask of the same step. dW and db go `g_off` floats
// past the layer's gw and gb.
__device__ void backward_layer(const Args& a, const Rank& rk, int l,
                               const float* x, uint32_t t, long long g_off,
                               Smem& sm, ClusterState& cs) {
  const Layer& L = layers[l];
  const Operand dz = {L.dz, L.pitch};
  Job jobs[2];
  const Epilogue dw = {kWeightGrad, &L, 0u, L.gw + g_off, L.gb + g_off};
  jobs[0] = make_job(kWeightGrad, L.din + 1, L.dout, a.batch, L.split_dw,
                     input_of(a, l, x), dz, L.din, dw);
  int n_jobs = 1;
  if (l > 0) {
    const Layer& P = layers[l - 1];
    const Epilogue dh = {kInputGrad, &P, drop_seed(P, t), nullptr, nullptr};
    jobs[n_jobs++] = make_job(kInputGrad, a.batch, L.din, L.dout, L.split_dh,
                              dz, {L.wp, L.pitch}, -1, dh);
  }
  run_jobs(jobs, n_jobs, rk, a.bf16 != 0, sm, cs);
}

// Softmax cross-entropy over the last layer's output: one row's loss, and
// the gradient with respect to the last layer's z, with the same sequence
// of operations as the tape. With kRegs > 0 (C up to kRegs classes) the
// row's logits and labels are loaded into registers first, all together
// (and z before the last loop, where the layer has an activation); with
// kRegs 0 each is loaded where it is used. The class weights are read-only
// inputs, loaded by the unrolled loop that sums them.
template <int kRegs>
__device__ __forceinline__ float row_loss(const Args& a, const Layer& L,
                                          const float* labels, int r,
                                          float inv_m) {
  const int C = L.dout;
  const int n = kRegs > 0 ? kRegs : C;  // the loops' bound
  const long long base = static_cast<long long>(r) * L.pitch;
  const float* logits = L.h + base;
  constexpr int N = kRegs > 0 ? kRegs : 1;
  float lg[N], lab[N];
  if constexpr (kRegs > 0) {
#pragma unroll
    for (int c = 0; c < N; ++c) lg[c] = c < C ? ld_cg(logits + c) : 0.0f;
#pragma unroll
    for (int c = 0; c < N; ++c) lab[c] = c < C ? __ldg(labels + c) : 0.0f;
  }
  auto logit = [&](int c) -> float {
    if constexpr (kRegs > 0) return lg[c];
    else return ld_cg(logits + c);
  };
  auto label = [&](int c) -> float {
    if constexpr (kRegs > 0) return lab[c];
    else return __ldg(labels + c);
  };
  float mx = logit(0);
#pragma unroll
  for (int c = 1; c < n; ++c)
    if (c < C) mx = fmaxf(mx, logit(c));
  float se = 0.0f;
#pragma unroll
  for (int c = 0; c < n; ++c)
    if (c < C) se = __fadd_rn(se, expf(__fsub_rn(logit(c), mx)));
  const float lse = logf(se);
  float dot = 0.0f;  // sum_c log_p[c] * labels[c]
#pragma unroll
  for (int c = 0; c < n; ++c) {
    if (c < C) {
      const float lp = __fsub_rn(__fsub_rn(logit(c), mx), lse);
      dot = __fadd_rn(dot, __fmul_rn(lp, label(c)));
    }
  }
  float nll = -dot;
  float g = inv_m;  // d loss / d nll
  if (a.cw != nullptr) {
    float w = 0.0f;  // the row's class weight
#pragma unroll
    for (int c = 0; c < n; ++c)
      if (c < C) w = __fadd_rn(w, __fmul_rn(label(c), __ldg(a.cw + c)));
    nll = __fmul_rn(nll, w);
    g = __fmul_rn(g, w);
  }
  g = -g;  // d loss / d (sum_c log_p[c] * labels[c])
  float gsum = 0.0f;
#pragma unroll
  for (int c = 0; c < n; ++c)
    if (c < C) gsum = __fadd_rn(gsum, __fmul_rn(g, label(c)));
  // log-softmax VJP: g_c - exp(log_p_c) * sum(g), then the activation's
  auto dz = [&](int c, float z) {
    const float lp = __fsub_rn(__fsub_rn(logit(c), mx), lse);
    const float d = __fsub_rn(__fmul_rn(g, label(c)),
                              __fmul_rn(expf(lp), gsum));
    L.dz[base + c] = activation_grad(L.act, d, z, logit(c));
  };
  if (L.act == kNone) {
#pragma unroll
    for (int c = 0; c < n; ++c)
      if (c < C) dz(c, logit(c));
  } else if constexpr (kRegs > 0) {
    float zz[N];
#pragma unroll
    for (int c = 0; c < N; ++c) zz[c] = c < C ? ld_cg(L.z + base + c) : 0.0f;
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (c < C) dz(c, zz[c]);
  } else {
    for (int c = 0; c < C; ++c) dz(c, ld_cg(L.z + base + c));
  }
  return nll;
}

// The step's loss: block 0, one thread a row; the batch mean summed in
// row order by one thread from the row losses in shared memory.
__device__ __noinline__ void loss_phase(const Args& a, const Rank& rk,
                                        int s, Smem& sm) {
  if (rk.block != 0) return;
  const Layer& L = layers[a.n_layers - 1];
  const int C = L.dout;
  const float* y = rk.yb + static_cast<long long>(s) * a.batch * C;
  const float inv_m = 1.0f / static_cast<float>(a.batch);
  // the row losses, a chunk of rows at a time, in the stages' room
  float* nll = sm.ring;
  constexpr int kChunk = 2 * NSTAGE * STAGE_FLOATS;
  float total = 0.0f;
  for (int first = 0; first < a.batch; first += kChunk) {
    const int last = min(a.batch, first + kChunk);
    for (int r = first + threadIdx.x; r < last; r += THREADS) {
      const float* labels = y + static_cast<long long>(r) * C;
      nll[r - first] = C <= LOSS_REGS
                           ? row_loss<LOSS_REGS>(a, L, labels, r, inv_m)
                           : row_loss<0>(a, L, labels, r, inv_m);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int rows = last - first;
      int r = 0;
      for (; r + 4 <= rows; r += 4) {
        const float4 v = *reinterpret_cast<const float4*>(nll + r);
        total = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(total, v.x), v.y),
                                    v.z), v.w);
      }
      for (; r < rows; ++r) total = __fadd_rn(total, nll[r]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0)
    rk.losses[s] = __fdiv_rn(total, static_cast<float>(a.batch));
}

// ---------------------------------------------------------------------------
// the optimizer and clip_norm, over the gradients' float4 units
// ---------------------------------------------------------------------------

// Where float4 unit u of the gradient rows lies: leaf (w0, b0, w1, ...),
// the offset of its first float in the leaf, and how many of its floats
// belong to the leaf (the rest is padding).
struct Unit {
  int leaf, off, n;
};

__device__ __forceinline__ Unit unit_of(long long u, int n_leaves) {
  int leaf = 0;
  while (leaf + 1 < n_leaves && u >= leaf_end[leaf]) ++leaf;
  const long long start = leaf == 0 ? 0 : leaf_end[leaf - 1];
  const Layer& L = layers[leaf / 2];
  const long long len =
      leaf % 2 == 0 ? static_cast<long long>(L.din) * L.dout : L.dout;
  const long long off = 4 * (u - start);
  return {leaf, static_cast<int>(off),
          static_cast<int>(min(4LL, len - off))};
}

// The leaf's parameter, gradient (plane 0) and slots.
struct Leaf {
  float* p;
  const float* g;
  float* s0;
  float* s1;
};

__device__ __forceinline__ Leaf leaf_ptrs(int leaf) {
  const Layer& L = layers[leaf / 2];
  if (leaf % 2 == 0) return {L.w, L.gw, L.s0w, L.s1w};
  return {L.b, L.gb, L.s0b, L.s1b};
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Four floats from p (n of them; the rest 0): one 16-byte load where `vec`.
__device__ __forceinline__ float4 load4(const float* p, int n, bool vec) {
  if (vec && n == 4) return ld_cg4(p);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (n > 0) v.x = ld_cg(p);
  if (n > 1) v.y = ld_cg(p + 1);
  if (n > 2) v.z = ld_cg(p + 2);
  if (n > 3) v.w = ld_cg(p + 3);
  return v;
}

__device__ __forceinline__ void store4(float* p, float4 v, int n, bool vec) {
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (n > 0) p[0] = v.x;
  if (n > 1) p[1] = v.y;
  if (n > 2) p[2] = v.z;
  if (n > 3) p[3] = v.w;
}

__device__ __forceinline__ float& elem(float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Units a thread takes at once: their loads are all issued before the
// first is used.
constexpr int UNITS = 2;

// clip_norm's first half: this block's sum of g^2 over its share of the
// gradient units (thread t of the rank's blocks takes units t, t + stride,
// ..., and each unit's floats in order; `g_off` floats past the gradient
// rows), reduced over the block's threads in a fixed order into
// partial[block].
__device__ __noinline__ void clip_phase(const Args& a, const Rank& rk,
                                        long long g_off,
                           Smem& sm) {
  const int n_leaves = 2 * a.n_layers;
  const long long units = leaf_end[n_leaves - 1];
  const long long first =
      static_cast<long long>(rk.block) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(rk.blocks) * blockDim.x;
  const float* g = rk.grads + g_off;
  float acc = 0.0f;
  for (long long u0 = first; u0 < units; u0 += UNITS * stride) {
    float4 v[UNITS];
    int n[UNITS];
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const long long u = u0 + k * stride;
      n[k] = u < units ? unit_of(u, n_leaves).n : 0;
      v[k] = load4(g + 4 * u, n[k], true);
    }
#pragma unroll
    for (int k = 0; k < UNITS; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < n[k]) {
          const float x = elem(v[k], i);
          acc = __fmaf_rn(x, x, acc);
        }
      }
  }
  float* red = sm.ring;  // the product stages, free between phases
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half /= 2) {
    if (threadIdx.x < half)
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) rk.partial[rk.block] = red[0];
}

// clip_norm's second half, in every block: the first warp sums the partial
// sums, lane j those of blocks j, j + 32, ... in order (their loads issued
// four at a time before they are added), then the lanes in a fixed
// butterfly; lane 0's total, the same in every block, gives
// min(1, clip_norm / (sqrt(total) + 1e-6)) rounded as the plain version
// rounds it (a reciprocal, then the product).
__device__ float clip_scale(const Args& a, const Rank& rk, Smem& sm) {
  float* red = sm.ring;
  if (threadIdx.x < 32) {
    float total = 0.0f;
    for (int i0 = threadIdx.x; i0 < rk.blocks; i0 += 4 * 32) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + 32 * k;
        v[k] = i < rk.blocks ? ld_cg(rk.partial + i) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i0 + 32 * k < rk.blocks) total = __fadd_rn(total, v[k]);
    }
    for (int lane = 16; lane > 0; lane /= 2)
      total = __fadd_rn(total, __shfl_xor_sync(0xffffffffu, total, lane));
    if (threadIdx.x == 0) {
      const float scale = __fmul_rn(
          __frcp_rn(__fadd_rn(__fsqrt_rn(total), 1e-6f)), a.clip_norm);
      red[0] = fminf(scale, 1.0f);
    }
  }
  __syncthreads();
  const float scale = red[0];
  __syncthreads();  // red is the stages' room
  return scale;
}

// Asks L2 for `bytes` at p, the rank's threads a 128-byte line each.
__device__ __forceinline__ void prefetch_l2(const Rank& rk, const void* p,
                                            long long bytes) {
  const long long lines = (bytes + 127) / 128;
  for (long long i = static_cast<long long>(rk.block) * blockDim.x +
                     threadIdx.x;
       i < lines; i += static_cast<long long>(rk.blocks) * blockDim.x)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(
        static_cast<const char*>(p) + 128 * i));
}

// Each element's update through the shared rule kOpt (apply_rule's switch
// folds to the one rule, so the phase runs little code), a thread's UNITS
// units at a time: the gradient, the parameter and the slots of every unit
// loaded (through L2: other blocks wrote them) before any is used. A
// weight whose kernel copy wp is apart from w is stored to both.
template <int kOpt>
__device__ __noinline__ void update_units(const Args& a, const Rank& rk,
                                          tinynn::Rule r, long long g_off,
                                          bool clip, float clip_by) {
  r.opt = kOpt;
  const int n_slots = tinynn::rule_slots(kOpt);
  const int n_leaves = 2 * a.n_layers;
  const long long units = leaf_end[n_leaves - 1];
  const long long first =
      static_cast<long long>(rk.block) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(rk.blocks) * blockDim.x;
  for (long long u0 = first; u0 < units; u0 += UNITS * stride) {
    Unit un[UNITS];
    Leaf lf[UNITS];
    bool vec[UNITS];
    float4 g[UNITS], p[UNITS], v0[UNITS], v1[UNITS];
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const long long u = u0 + k * stride;
      un[k] = u < units ? unit_of(u, n_leaves) : Unit{0, 0, 0};
      lf[k] = leaf_ptrs(un[k].leaf);
      const int o = un[k].off;
      vec[k] = aligned16(lf[k].p) && (n_slots < 1 || aligned16(lf[k].s0)) &&
               (n_slots < 2 || aligned16(lf[k].s1));
      g[k] = load4(lf[k].g + g_off + o, un[k].n, true);
      p[k] = load4(lf[k].p + o, un[k].n, vec[k]);
      v0[k] = n_slots > 0 ? load4(lf[k].s0 + o, un[k].n, vec[k]) : g[k];
      v1[k] = n_slots > 1 ? load4(lf[k].s1 + o, un[k].n, vec[k]) : g[k];
    }
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= un[k].n) continue;
        float gi = elem(g[k], i);
        if (clip) gi = __fmul_rn(gi, clip_by);
        float s0v = n_slots > 0 ? elem(v0[k], i) : 0.0f;
        float s1v = n_slots > 1 ? elem(v1[k], i) : 0.0f;
        elem(p[k], i) = tinynn::apply_rule(r, elem(p[k], i), gi, s0v, s1v);
        if (n_slots > 0) elem(v0[k], i) = s0v;
        if (n_slots > 1) elem(v1[k], i) = s1v;
      }
      const int o = un[k].off;
      store4(lf[k].p + o, p[k], un[k].n, vec[k]);
      if (n_slots > 0) store4(lf[k].s0 + o, v0[k], un[k].n, vec[k]);
      if (n_slots > 1) store4(lf[k].s1 + o, v1[k], un[k].n, vec[k]);
      const Layer& L = layers[un[k].leaf / 2];
      if (un[k].leaf % 2 == 0 && L.wp != L.w) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i >= un[k].n) continue;
          const int at = o + i;
          L.wp[static_cast<long long>(at / L.dout) * L.pitch + at % L.dout] =
              elem(p[k], i);
        }
      }
    }
  }
}

// The optimizer's phase: the step's scalars, clip_norm's scale, the next
// step's batch prefetched into L2, then the rule's update_units.
__device__ __noinline__ void optimizer_phase(const Args& a, const Rank& rk,
                                             int s, long long g_off,
                                             Smem& sm) {
  tinynn::Rule r = a.rule;
  r.s0 = __ldg(a.scalars + 2 * s);
  r.s1 = __ldg(a.scalars + 2 * s + 1);
  const bool clip = a.clip_norm > 0.0f;
  const float clip_by = clip ? clip_scale(a, rk, sm) : 1.0f;
  if (s + 1 < a.n_steps) {  // the next step's batch, on its way to L2
    const long long rows = a.batch;
    prefetch_l2(rk, rk.xb + (s + 1) * rows * a.x_pitch,
                4 * rows * a.x_pitch);
    const long long classes = layers[a.n_layers - 1].dout;
    prefetch_l2(rk, rk.yb + (s + 1) * rows * classes, 4 * rows * classes);
  }
  switch (r.opt) {
    case tinynn::kMomentum:
      update_units<tinynn::kMomentum>(a, rk, r, g_off, clip, clip_by);
      break;
    case tinynn::kAdam:
      update_units<tinynn::kAdam>(a, rk, r, g_off, clip, clip_by);
      break;
    case tinynn::kLion:
      update_units<tinynn::kLion>(a, rk, r, g_off, clip, clip_by);
      break;
    case tinynn::kRMSProp:
      update_units<tinynn::kRMSProp>(a, rk, r, g_off, clip, clip_by);
      break;
    case tinynn::kAdagrad:
      update_units<tinynn::kAdagrad>(a, rk, r, g_off, clip, clip_by);
      break;
    case tinynn::kAdadelta:
      update_units<tinynn::kAdadelta>(a, rk, r, g_off, clip, clip_by);
      break;
    default:
      update_units<tinynn::kSGD>(a, rk, r, g_off, clip, clip_by);
  }
}

// Before the first step: each weight's kernel copy wp, where it is apart
// from w, filled from w (the rank's blocks share the floats).
__device__ __noinline__ void fill_copies(const Args& a, const Rank& rk) {
  const long long first =
      static_cast<long long>(rk.block) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(rk.blocks) * blockDim.x;
  for (int l = 0; l < a.n_layers; ++l) {
    const Layer& L = layers[l];
    if (L.wp == L.w) continue;
    const long long n = static_cast<long long>(L.din) * L.dout;
    for (long long i = first; i < n; i += stride)
      L.wp[(i / L.dout) * L.pitch + i % L.dout] = ld_cg(L.w + i);
  }
}

// A load of a count with acquire semantics at the card's scope.
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The barrier between two phases, over the blocks of this block's rank:
// csrc/ring.cuh's rank_barrier (the same count) with its fences folded
// into the count's accesses: after the block's barrier thread 0 adds 1
// with release semantics (no wait for the add to return) and polls with
// acquire semantics, then the block's barrier again. A wait over
// kSpinLimitNs traps. Every thread of the block calls it.
__device__ __forceinline__ void phase_barrier(tinynn::Group& g) {
  __syncthreads();
  ++g.barriers;
  if (threadIdx.x == 0) {
    unsigned* arrive = tinynn::count_of(g, g.rank, tinynn::kArrive);
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(arrive)
                 : "memory");
    const unsigned target = g.barriers * static_cast<unsigned>(g.blocks);
    unsigned long long start = 0;
    for (unsigned polls = 0;
         static_cast<int>(ld_acquire(arrive) - target) < 0; ++polls) {
      if ((polls & 1023u) == 0) {
        const unsigned long long now = global_ns();
        if (polls == 0) start = now;
        else if (now - start > tinynn::kSpinLimitNs) __trap();
      }
    }
  }
  __syncthreads();
}

// One launch's kernel; kRanked (n_ranks > 1) compiles the exchange in, so
// the one-rank kernel keeps no trace of it. Two blocks an SM.
template <bool kRanked>
__global__ void __launch_bounds__(THREADS, 2)
fused_epoch_kernel(const __grid_constant__ Args a) {
  // the stages and tiles in dynamic shared memory (past 48 KB)
  extern __shared__ __align__(16) unsigned char dynamic_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(dynamic_smem);
  // the rank's view lives in shared memory, not in registers: the product
  // tiles need those
  __shared__ Rank rk;
  tinynn::Group g = tinynn::group_of(a.sync, a.n_ranks, a.blocks);
  if (threadIdx.x < a.n_layers)
    layers[threadIdx.x] = a.tables[g.rank * MAX_LAYERS + threadIdx.x];
  const long long din = a.x_pitch;
  if (threadIdx.x == 0) {
    const long long dout = a.tables[a.n_layers - 1].dout;
    const long long r = g.rank;
    rk = {a.xb + r * a.n_steps * a.batch * din,
          a.yb + r * a.n_steps * a.batch * dout, a.losses + r * a.n_steps,
          a.partial + r * a.blocks, a.grads + r * a.grad_stride, g.block,
          g.blocks};
    long long end = 0;
    for (int l = 0; l < a.n_layers; ++l) {
      const Layer& L = a.tables[l];
      end += (static_cast<long long>(L.din) * L.dout + 3) / 4;
      leaf_end[2 * l] = end;
      end += (L.dout + 3) / 4;
      leaf_end[2 * l + 1] = end;
    }
  }
  __syncthreads();
  const bool timed =
      a.phase_ns != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long last = timed ? global_ns() : 0;
  auto mark = [&](int phase) {
    if (timed) {
      const unsigned long long now = global_ns();
      a.phase_ns[phase] += now - last;
      last = now;
    }
  };
  ClusterState cs;
  fill_copies(a, rk);
  phase_barrier(g);
  const int L = a.n_layers;
  const bool clip = a.clip_norm > 0.0f;
  // the phases of a rank are separated by barriers over its blocks alone
  auto barrier = [&](int phase) {
    phase_barrier(g);
    mark(phase);
  };
  // with ranks: the floats from one plane of the gradients to the next;
  // the exchange writes the mean into plane 2
  const long long plane = kRanked ? a.n_ranks * a.grad_stride : 0;
  const long long mean_off = 2 * plane;
  for (int s = 0; s < a.n_steps; ++s) {
    const float* x = rk.xb + static_cast<long long>(s) * a.batch * din;
    // the Dropout seeds' step: the counter before the update, offset by
    // the rank so that ranks draw different masks
    const uint32_t t =
        tinynn::rank_step(a.t0 + static_cast<uint32_t>(s), g.rank);
    const long long written = (s & 1) * plane;  // this step's plane
    for (int l = 0; l < L; ++l) {
      forward_layer(a, rk, l, x, t, sm, cs);
      barrier(l);
    }
    loss_phase(a, rk, s, sm);
    barrier(L);
    for (int l = L - 1; l >= 0; --l) {
      backward_layer(a, rk, l, x, t, written, sm, cs);
      // with ranks the all-rank arrival below takes the last backward's
      // barrier: the phase ends with block 0's own share, and every wait
      // for other blocks, its rank's too, goes to the exchange's phase
      if (!kRanked || l > 0) barrier(2 * L - l);
      else mark(2 * L);
    }
    int phase = 2 * L + 1;
    if constexpr (kRanked) {
      // K6: every rank's gradients published, then each rank's mean
      tinynn::exchange_arrive(g, a.skew);
      const float* planes = a.grads + written;
      const long long stride = a.grad_stride;
      tinynn::exchange_pass(
          g, [&](int q) { return planes + q * stride; },
          a.grads + mean_off + g.rank * stride, a.n_grad, true, true,
          a.ring_scale);
      barrier(phase++);
    }
    if (clip) {
      clip_phase(a, rk, mean_off, sm);
      barrier(phase++);
    }
    optimizer_phase(a, rk, s, mean_off, sm);
    barrier(phase);
  }
  cs.settle();  // no block leaves while another reads its partial tiles
}

template <bool kRanked>
cudaLaunchConfig_t launch_config(int blocks, cudaLaunchAttribute* attr,
                                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = sizeof(Smem);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = CLUSTER;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

// The one-rank or the ranked kernel's co-resident clusters on the current
// device, blocks an SM, and SMs.
template <bool kRanked>
int grid_of(int* clusters, int* blocks_per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fused_epoch_kernel<kRanked>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fused_epoch_kernel<kRanked>, THREADS, sizeof(Smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = launch_config<kRanked>(CLUSTER, attr, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, fused_epoch_kernel<kRanked>, &cfg));
}

}  // namespace

// The grid a launch can use: the clusters of CLUSTER blocks the card holds
// at once (`*clusters`, `*cluster`), the blocks an SM holds and the SM
// count, for the one-rank kernel (ranked 0) or the ranked one. Each of n
// ranks takes clusters / n of them.
extern "C" int tinynn_fused_epoch_grid(int ranked, int* clusters,
                                       int* cluster, int* blocks_per_sm,
                                       int* sms) {
  *cluster = CLUSTER;
  return ranked ? grid_of<true>(clusters, blocks_per_sm, sms)
                : grid_of<false>(clusters, blocks_per_sm, sms);
}

// The bytes of one rank's layer table in device memory.
extern "C" long long tinynn_fused_epoch_table_bytes() {
  return static_cast<long long>(sizeof(Layer)) * MAX_LAYERS;
}

// One epoch of `n_steps` train steps on each of `n_ranks` ranks of
// `blocks` blocks (a multiple of the cluster size; n_ranks * blocks within
// what tinynn_fused_epoch_grid reports), in one cooperative launch of
// clusters. `dims` holds (din, dout, activation, dropout, pitch) for each
// of the `n_layers` Dense layers (pitch: dout rounded up to a multiple of
// 4), `plan` the K-splits of its forward, dW and dh products (1 to the
// cluster size, at most the product's 32-deep stages), `drops` (seed index,
// keep threshold) and `drop_scales` the scale of each layer's Dropout (read
// where dropout is 1), `layer_ptrs` the 13 device pointers of each layer of
// each rank, rank by rank (w, b, gw, gb, s0w, s0b, s1w, s1b, z, h, d, dz,
// wp; a slot the rule does not have, and d without a Dropout, are null; z,
// h, d, dz and wp have rows of `pitch` floats, wp == w where w's rows are
// 16-byte aligned; each rank's gw and gb lie in its row of `grads`,
// [planes, n_ranks, grad_stride] with n_grad floats a row used, laid out
// as grad_layout in ops/fused_epoch.py: each leaf on a whole float4 after
// the one before; one plane with one rank, three with more, see Args;
// grad_stride >= n_grad, a multiple of 4). `tables` is a device buffer of
// n_ranks * tinynn_fused_epoch_table_bytes(). `xb` holds [n_ranks, n_steps,
// batch] rows of `x_pitch` floats (a multiple of 4), `yb` and `losses` one
// block per rank (see Args); `partial` is a scratch of `partial_len` floats
// (at least the launch's blocks). `sync` holds n_ranks * 2 zeroed counts.
// `skew_rank` (-1: none) holds that rank back `skew_ns` before each step's
// all-rank arrival (a check of the exchange's flow control). `opt`,
// `c0`-`c3` and `wd` are the rule (csrc/optim_rules.cuh), `scalars`
// [n_steps, 2] its per-step scalars, `t0` the step count before the epoch,
// `clip_norm` the clipping norm (0: off). `phase_ns`, where not null,
// accumulates each phase's time (see Args). Launches on `stream` and does
// not synchronise. Returns the CUDA error of the launch (0 when it was
// accepted); cudaErrorNotSupported when the device cannot launch
// cooperatively, cudaErrorInvalidValue for arguments out of range.
extern "C" int tinynn_fused_epoch(
    int n_ranks, int blocks, int n_layers, const int* dims, const int* plan,
    const unsigned int* drops, const float* drop_scales,
    void* const* layer_ptrs, void* tables, const float* xb, int x_pitch,
    const float* yb, const float* class_weight, const float* scalars,
    float* losses, float* partial, int partial_len, float* grads,
    long long n_grad, long long grad_stride, unsigned* sync, int batch,
    int n_steps, unsigned int t0, int opt, float c0, float c1, float c2,
    float c3, float wd, float clip_norm, int bf16, int skew_rank,
    long long skew_ns, unsigned long long* phase_ns, void* stream) {
  if (n_ranks < 1 || n_layers < 1 || n_layers > MAX_LAYERS || batch < 1 ||
      n_steps < 1 || opt < tinynn::kSGD || opt > tinynn::kAdadelta ||
      grad_stride < n_grad || grad_stride % 4 != 0 || x_pitch % 4 != 0 ||
      blocks < CLUSTER || blocks % CLUSTER != 0 ||
      (reinterpret_cast<uintptr_t>(grads) & 15u) != 0 ||
      (reinterpret_cast<uintptr_t>(xb) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);

  int clusters = 0, per_sm = 0, sms = 0;
  const int grid_err = n_ranks > 1 ? grid_of<true>(&clusters, &per_sm, &sms)
                                   : grid_of<false>(&clusters, &per_sm, &sms);
  if (grid_err != 0) return grid_err;
  if (static_cast<long long>(blocks) * n_ranks >
      static_cast<long long>(clusters) * CLUSTER)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (clip_norm > 0.0f && partial_len < blocks * n_ranks)
    return static_cast<int>(cudaErrorInvalidValue);

  std::vector<Layer> table(static_cast<size_t>(n_ranks) * MAX_LAYERS);
  for (int r = 0; r < n_ranks; ++r) {
    long long offset = 0;  // grad_layout: each leaf on a whole float4
    for (int l = 0; l < n_layers; ++l) {
      Layer& L = table[r * MAX_LAYERS + l];
      L.din = dims[5 * l];
      L.dout = dims[5 * l + 1];
      L.act = dims[5 * l + 2];
      L.drop = dims[5 * l + 3];
      L.pitch = dims[5 * l + 4];
      L.split_fwd = plan[PLAN_PER_LAYER * l];
      L.split_dw = plan[PLAN_PER_LAYER * l + 1];
      L.split_dh = plan[PLAN_PER_LAYER * l + 2];
      const int stages[3] = {(L.din + BK - 1) / BK, (batch + BK - 1) / BK,
                             (L.dout + BK - 1) / BK};
      const int splits[3] = {L.split_fwd, L.split_dw, L.split_dh};
      for (int i = 0; i < 3; ++i)
        if (splits[i] < 1 || splits[i] > CLUSTER || splits[i] > stages[i])
          return static_cast<int>(cudaErrorInvalidValue);
      if (L.din < 1 || L.dout < 1 || L.pitch < L.dout || L.pitch % 4 != 0 ||
          (l == 0 && x_pitch < L.din))
        return static_cast<int>(cudaErrorInvalidValue);
      L.seed_index = drops[2 * l];
      L.threshold = drops[2 * l + 1];
      L.scale = drop_scales[l];
      float* const* p = reinterpret_cast<float* const*>(
          layer_ptrs + PTRS_PER_LAYER * (r * n_layers + l));
      L.w = p[0];
      L.b = p[1];
      L.gw = p[2];
      L.gb = p[3];
      L.s0w = p[4];
      L.s0b = p[5];
      L.s1w = p[6];
      L.s1b = p[7];
      L.z = p[8];
      L.h = p[9];
      L.d = p[10];
      L.dz = p[11];
      L.wp = p[12];
      L.out = L.drop ? L.d : L.h;
      float* row = grads + r * grad_stride;
      const long long nw = static_cast<long long>(L.din) * L.dout;
      if (L.gw != row + offset) return static_cast<int>(cudaErrorInvalidValue);
      offset += (nw + 3) / 4 * 4;
      if (L.gb != row + offset) return static_cast<int>(cudaErrorInvalidValue);
      offset += (L.dout + 3) / 4 * 4;
      const uintptr_t scratch =
          reinterpret_cast<uintptr_t>(L.z) | reinterpret_cast<uintptr_t>(L.h) |
          reinterpret_cast<uintptr_t>(L.dz) |
          reinterpret_cast<uintptr_t>(L.wp) |
          (L.drop ? reinterpret_cast<uintptr_t>(L.d) : 0u);
      if ((scratch & 15u) != 0 || (reinterpret_cast<uintptr_t>(L.b) & 15u) ||
          (L.wp == L.w && (L.pitch != L.dout)))
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (offset > n_grad) return static_cast<int>(cudaErrorInvalidValue);
  }
  // pageable memory: the call returns once the table has been staged, so
  // it may go out of scope before the copy runs
  err = cudaMemcpyAsync(tables, table.data(), table.size() * sizeof(Layer),
                        cudaMemcpyHostToDevice,
                        static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);

  Args a = {};
  a.n_layers = n_layers;
  a.batch = batch;
  a.n_steps = n_steps;
  a.bf16 = bf16;
  a.t0 = t0;
  a.clip_norm = clip_norm;
  a.rule = {opt, 0.0f, 0.0f, c0, c1, c2, c3, wd};
  a.n_ranks = n_ranks;
  a.blocks = blocks;
  a.x_pitch = x_pitch;
  a.tables = static_cast<const Layer*>(tables);
  a.xb = xb;
  a.yb = yb;
  a.cw = class_weight;
  a.scalars = scalars;
  a.losses = losses;
  a.partial = partial;
  a.grads = grads;
  a.n_grad = n_grad;
  a.sync = sync;
  a.grad_stride = grad_stride;
  a.skew = {skew_rank, skew_ns};
  a.ring_scale = static_cast<float>(1.0 / n_ranks);
  a.phase_ns = phase_ns;
  cudaLaunchAttribute attr[2];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_ranks > 1) {
    const cudaLaunchConfig_t cfg =
        launch_config<true>(blocks * n_ranks, attr, s);
    err = cudaLaunchKernelEx(&cfg, fused_epoch_kernel<true>, a);
  } else {
    const cudaLaunchConfig_t cfg = launch_config<false>(blocks, attr, s);
    err = cudaLaunchKernelEx(&cfg, fused_epoch_kernel<false>, a);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
