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
//   cooperative launch: as many blocks as fit on the card at once
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), with the phases
//   of a step separated by grid-wide barriers (an arrival count in device
//   memory, csrc/ring.cuh's rank_barrier). Per step: one phase per Dense
//   forward, one for the
//   loss, one per Dense backward (dW, db and the previous layer's dz
//   together), one for the optimizer: 2 x layers + 2 barriers, 12 for the
//   flagship MLP (one more with clip_norm). Every gradient is taken
//   before any weight changes.
// - The state does not fit on an SM: the flagship's parameters and Adam
//   moments are 2.24 MB against 227 KB of shared memory per SM. They stay in
//   device memory, updated in place, with the gradients (0.75 MB) and the
//   activations (0.42 MB at batch 128); all of it stays resident in the
//   50 MB L2 across the steps, which plays VMEM's part. Data written inside
//   the launch is read through L2 (ld_cg), never from a stale L1 line.
// - Within a phase, blocks take 32x32 output tiles in a grid-stride loop and
//   stage 32-deep slices of both operands in shared memory. Each output
//   element is owned by one thread, which runs its K loop in a fixed order;
//   the loss and the bias gradients are summed by one thread each, in row
//   order. No float atomics, so two runs on the same inputs give
//   bit-identical results, whatever the grid size.
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
// - clip_norm: one more phase a step after the backward: each block sums
//   g^2 over a fixed share of the gradients and reduces it in a fixed order
//   in shared memory; after a grid barrier every block sums the per-block
//   partial sums in one fixed order. No float atomics, so it keeps the
//   promise below.
// - Ranks (K6, the data-parallel megakernel): the JAX package runs this
//   kernel on each device of a mesh axis, on the device's batch shard, and
//   between the backward and the optimizer sums the gradients over the
//   axis with an in-kernel ring of remote DMAs (`grad_ring_all_reduce`,
//   tinynn_autograd_tpu/ops/fused_epoch.py:114), then takes their mean.
//   Here n ranks share the card in ONE launch: the co-resident blocks,
//   rounded down to a multiple of n, are split into n groups, and each rank
//   runs every phase on its own replica, slots, gradients, activations and
//   batch shard, with the barriers above over its own blocks only. Its
//   layer table (pointers to all that) sits in device memory, copied to
//   shared memory at the start: 16 layers a rank would pass the launch's
//   4 KB parameter limit at two ranks. The exchange (csrc/ring.cuh, the
//   device code of P3) takes the last backward's barrier and one more
//   phase: the all-rank arrival, then each rank's pass sums every rank's
//   flat gradient buffer in the ring's order, times 1/n, into a buffer of
//   its own, so clip_norm and the rule act on the mean, as the JAX
//   optimizer does after its ring. The gradients are
//   double-buffered by step parity: step s writes plane s % 2, so a rank
//   that runs ahead writes step s + 1's gradients while slower ranks still
//   read step s's, and it reaches step s + 2's only after step s + 1's
//   arrival, which every rank makes after its pass of step s. Rank r
//   seeds its Dropouts with step t + 7919 r (the JAX kernel's offset).
//   Ranks meet only through the exchange's counts, never a grid barrier.
//   With one rank there is no exchange, and the result is the
//   single-device kernel's, bit for bit.
// - f32 everywhere. With `bf16` set (set_matmul_precision("bf16")), each
//   product operand is rounded to bf16 on load and widened again, and the
//   products accumulate in f32, as the TPU kernel's bf16 operands with f32
//   accumulation do. The loss and optimizer arithmetic use the _rn
//   intrinsics so that the compiler does not contract them into FMAs: they
//   round where the plain PyTorch version rounds.
//
// What bounds it: a flagship step (784-200-100-70-30-10, batch 128) is
// about 102.9 MFLOP of products (forward, weight gradients, input gradients
// but the first layer's), which at the H100's 67 TFLOP/s f32 FMA peak is
// about 1.54 us a step, 0.60 ms for a 390-step epoch: compute-bound. The
// bytes it must move are about 163 MB an epoch, mostly the batches, about
// 49 us at 3.35 TB/s. With n ranks at a global batch of 128 each rank
// does 1/n of the products on 1/n of the blocks; the exchange adds one
// all-rank arrival and one pass that reads the n ranks' 746 KB of
// gradients from L2 (see ring.cuh). What holds this simple design back:
// 12 grid barriers a step, and narrow layers that leave most blocks idle
// (the first layer's forward is 28 tiles of 25 stages each, on 264
// blocks). Sharding the state into shared memory, splitting K, and tensor
// cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <vector>

#include "hash.cuh"
#include "optim_rules.cuh"
#include "ring.cuh"

namespace {

using tinynn::global_ns;
using tinynn::ld_cg;

constexpr int MAX_LAYERS = 16;
constexpr int THREADS = 256;
constexpr int TILE = 32;         // output tile edge
constexpr int BK = 32;           // depth of one shared-memory stage
constexpr int PER = TILE / 16;   // outputs per thread along each tile edge
constexpr int PTRS_PER_LAYER = 12;

enum Act { kNone = 0, kReLU = 1, kSigmoid = 2, kTanh = 3 };

struct Layer {
  int din, dout, act;
  int drop;             // 1 when a Dropout follows the layer (rate > 0)
  uint32_t seed_index;  // the Dropout's position among the seeded layers
  uint32_t threshold;   // keep where the hash's bits are below it
  float scale;          // 1 / (1 - rate), as f32
  float* w;    // [din, dout], updated in place
  float* b;    // [1, dout], updated in place
  float* gw;   // gradients, same shapes
  float* gb;
  float* s0w;  // the rule's first slot (null when it has none)
  float* s0b;
  float* s1w;  // its second slot (null when it has none)
  float* s1b;
  float* z;    // pre-activation [batch, dout]
  float* h;    // activation output [batch, dout]; == z without activation
  float* d;    // the Dropout's output [batch, dout] (null without one)
  float* dz;   // loss gradient with respect to z [batch, dout]
  const float* out;  // what the next layer reads: d with a Dropout, else h
};

struct Args {
  int n_layers, batch, n_steps, bf16;
  uint32_t t0;           // the optimizer's step count before the epoch
  float clip_norm;       // global-norm clipping of the gradients; 0 is off
  tinynn::Rule rule;     // the rule, its constants and weight decay; the
                         // scalars s0, s1 are set each step
  int n_ranks, blocks;   // the ranks, and the blocks each rank takes
  const Layer* tables;   // [n_ranks][MAX_LAYERS] in device memory: each
                         // rank's layers (its own replica and scratch)
  const float* xb;       // [n_ranks, n_steps, batch, layer[0].din]
  const float* yb;       // [n_ranks, n_steps, batch, dout of the last]
  const float* cw;       // class weights [dout of the last layer] or null
  const float* scalars;  // [n_steps, 2]: each step's (s0, s1)
  float* losses;         // [n_ranks, n_steps]: each rank's batch mean
  float* row_loss;       // [n_ranks, batch] scratch
  float* partial;        // [n_ranks, blocks] scratch: clip_norm's partials
  float* grads;          // [planes, n_ranks, grad_stride]: each rank's
  long long n_grad;      // n_grad gradients, which its layers' gw and gb
  long long grad_stride; // point into in plane 0. With ranks, 3 planes:
                         // the gradients of even steps, of odd steps,
                         // and each rank's mean after the exchange
  int vec;               // the planes' rows are 16-byte aligned
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

// One block's view of its rank: its shard of the batches, its outputs and
// scratch, and where it sits.
struct Rank {
  const float* xb;
  const float* yb;
  float* losses;
  float* row_loss;
  float* partial;
  float* grads;
  int block, blocks;  // the block's index among the rank's blocks
};

// A matrix as the product reads it: element (i, j) at p[i * rs + j * cs].
struct View {
  const float* p;
  int rs, cs;
};

struct Smem {
  float a[BK][TILE + 1];  // k-major; the pad spreads the banks
  float b[BK][TILE + 1];
};

__device__ __forceinline__ float load_operand(const View& v, int i, int j,
                                              bool bf16) {
  const float x = ld_cg(v.p + static_cast<long long>(i) * v.rs +
                         static_cast<long long>(j) * v.cs);
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ int tiles_of(int m, int n) {
  return ((m + TILE - 1) / TILE) * ((n + TILE - 1) / TILE);
}

// One TILE x TILE tile of C[m,n] = A[m,k] @ B[k,n]; `epi(row, col, sum)`
// stores each element. The whole block calls it.
template <class Epilogue>
__device__ void product_tile(const View& A, const View& B, int m, int n,
                             int k, int tile, bool bf16, Smem& sm,
                             Epilogue epi) {
  const int tiles_n = (n + TILE - 1) / TILE;
  const int r0 = (tile / tiles_n) * TILE;
  const int c0 = (tile % tiles_n) * TILE;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  // walk each operand tile along the operand's unit stride, so that
  // neighbouring threads load neighbouring addresses
  const bool a_k_unit = (A.cs == 1);
  const bool b_n_unit = (B.cs == 1);

  float acc[PER][PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
#pragma unroll
    for (int j = 0; j < PER; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int it = 0; it < (TILE * BK) / THREADS; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int ar = a_k_unit ? idx / BK : idx % TILE;
      const int ak = a_k_unit ? idx % BK : idx / TILE;
      sm.a[ak][ar] = (r0 + ar < m && k0 + ak < k)
                         ? load_operand(A, r0 + ar, k0 + ak, bf16)
                         : 0.0f;
      const int bk = b_n_unit ? idx / TILE : idx % BK;
      const int bc = b_n_unit ? idx % TILE : idx / BK;
      sm.b[bk][bc] = (k0 + bk < k && c0 + bc < n)
                         ? load_operand(B, k0 + bk, c0 + bc, bf16)
                         : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[PER], bv[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) av[i] = sm.a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < PER; ++j) bv[j] = sm.b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < PER; ++i)
#pragma unroll
        for (int j = 0; j < PER; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = c0 + tx + 16 * j;
      if (r < m && c < n) epi(r, c, acc[i][j]);
    }
  }
}

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

// z = h_in @ w + b, h = act(z) and, with a Dropout, d = dropout(h), for one
// Dense layer in the step whose counter is `t`.
__device__ void forward_layer(const Args& a, const Rank& rk, int l,
                              const float* x, uint32_t t, Smem& sm) {
  const Layer& L = layers[l];
  const View in = {l == 0 ? x : layers[l - 1].out, L.din, 1};
  const View w = {L.w, L.dout, 1};
  const uint32_t seed = drop_seed(L, t);
  const int tiles = tiles_of(a.batch, L.dout);
  for (int tile = rk.block; tile < tiles; tile += rk.blocks) {
    product_tile(in, w, a.batch, L.dout, L.din, tile, a.bf16, sm,
                 [&](int r, int c, float v) {
                   const float z = __fadd_rn(v, ld_cg(L.b + c));
                   const long long o = static_cast<long long>(r) * L.dout + c;
                   L.z[o] = z;
                   float h = z;
                   if (L.act != kNone) {
                     h = activate(L.act, z);
                     L.h[o] = h;
                   }
                   if (L.drop) L.d[o] = drop(L, seed, o, h);
                 });
  }
}

// Softmax cross-entropy over the last layer's output: the step's loss and
// the gradient with respect to the last layer's z. One block; one thread a
// row, with the same sequence of operations as the tape.
__device__ void loss_phase(const Args& a, const Rank& rk, int s) {
  if (rk.block != 0) return;
  const Layer& L = layers[a.n_layers - 1];
  const int C = L.dout;
  const float* y = rk.yb + static_cast<long long>(s) * a.batch * C;
  const float inv_m = 1.0f / static_cast<float>(a.batch);
  for (int r = threadIdx.x; r < a.batch; r += blockDim.x) {
    const long long base = static_cast<long long>(r) * C;
    const float* logits = L.h + base;
    const float* labels = y + base;
    float mx = ld_cg(logits);
    for (int c = 1; c < C; ++c) mx = fmaxf(mx, ld_cg(logits + c));
    float se = 0.0f;
    for (int c = 0; c < C; ++c)
      se = __fadd_rn(se, expf(__fsub_rn(ld_cg(logits + c), mx)));
    const float lse = logf(se);
    float dot = 0.0f;  // sum_c log_p[c] * labels[c]
    float w = 1.0f;    // the row's class weight
    if (a.cw != nullptr) w = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float lp = __fsub_rn(__fsub_rn(ld_cg(logits + c), mx), lse);
      const float lab = __ldg(labels + c);
      dot = __fadd_rn(dot, __fmul_rn(lp, lab));
      if (a.cw != nullptr) w = __fadd_rn(w, __fmul_rn(lab, __ldg(a.cw + c)));
    }
    float nll = -dot;
    float g = inv_m;  // d loss / d nll
    if (a.cw != nullptr) {
      nll = __fmul_rn(nll, w);
      g = __fmul_rn(g, w);
    }
    rk.row_loss[r] = nll;
    g = -g;  // d loss / d (sum_c log_p[c] * labels[c])
    float gsum = 0.0f;
    for (int c = 0; c < C; ++c)
      gsum = __fadd_rn(gsum, __fmul_rn(g, __ldg(labels + c)));
    // log-softmax VJP: g_c - exp(log_p_c) * sum(g), then the activation's
    for (int c = 0; c < C; ++c) {
      const float lp = __fsub_rn(__fsub_rn(ld_cg(logits + c), mx), lse);
      const float d = __fsub_rn(__fmul_rn(g, __ldg(labels + c)),
                                __fmul_rn(expf(lp), gsum));
      L.dz[base + c] = activation_grad(L.act, d, ld_cg(L.z + base + c),
                                       ld_cg(L.h + base + c));
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // this block wrote the row losses: plain loads see them after the
    // barrier, from L1
    float total = 0.0f;
    for (int r = 0; r < a.batch; ++r) total = __fadd_rn(total, rk.row_loss[r]);
    rk.losses[s] = __fdiv_rn(total, static_cast<float>(a.batch));
  }
}

// dW = h_in^T @ dz, db = sum over rows of dz, and (but for the first layer)
// the previous layer's dz = act'(dropout'(dz @ W^T)), as one phase of work
// items; the Dropout's VJP replays the forward's mask of the same step.
// dW and db go `g_off` floats past the layer's gw and gb.
__device__ void backward_layer(const Args& a, const Rank& rk, int l,
                               const float* x, uint32_t t, long long g_off,
                               Smem& sm) {
  const Layer& L = layers[l];
  float* gw = L.gw + g_off;  // this step's plane of the gradients
  float* gb = L.gb + g_off;
  const View h_t = {l == 0 ? x : layers[l - 1].out, 1, L.din};  // [din, B]
  const View dz = {L.dz, L.dout, 1};                           // [batch, dout]
  const View w_t = {L.w, 1, L.dout};                           // [dout, din]
  const int n_dw = tiles_of(L.din, L.dout);
  const int n_dh = l > 0 ? tiles_of(a.batch, L.din) : 0;
  const int n_db = (L.dout + THREADS - 1) / THREADS;
  for (int item = rk.block; item < n_dw + n_dh + n_db; item += rk.blocks) {
    if (item < n_dw) {
      product_tile(h_t, dz, L.din, L.dout, a.batch, item, a.bf16, sm,
                   [&](int r, int c, float v) {
                     gw[static_cast<long long>(r) * L.dout + c] = v;
                   });
    } else if (item < n_dw + n_dh) {
      const Layer& P = layers[l - 1];
      const uint32_t seed = drop_seed(P, t);
      product_tile(dz, w_t, a.batch, L.din, L.dout, item - n_dw, a.bf16, sm,
                   [&](int r, int c, float v) {
                     const long long o = static_cast<long long>(r) * P.dout + c;
                     const float g = P.drop ? drop(P, seed, o, v) : v;
                     P.dz[o] = activation_grad(P.act, g, ld_cg(P.z + o),
                                               ld_cg(P.h + o));
                   });
    } else {
      const int c = (item - n_dw - n_dh) * THREADS + threadIdx.x;
      if (c < L.dout) {
        float sum = 0.0f;
        for (int r = 0; r < a.batch; ++r)
          sum = __fadd_rn(sum, ld_cg(L.dz + static_cast<long long>(r) * L.dout + c));
        gb[c] = sum;
      }
    }
  }
}

// clip_norm's first half: this block's sum of g^2 over its share of the
// gradients (the optimizer phase's grid-stride share, layer by layer; `g_off`
// floats past gw and gb), reduced over the block's threads in a fixed order
// into partial[block].
__device__ void clip_phase(const Args& a, const Rank& rk, long long g_off,
                           Smem& sm) {
  const long long first = static_cast<long long>(rk.block) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(rk.blocks) * blockDim.x;
  float acc = 0.0f;
  for (int l = 0; l < a.n_layers; ++l) {
    const Layer& L = layers[l];
    const long long nw = static_cast<long long>(L.din) * L.dout;
    for (long long i = first; i < nw; i += stride) {
      const float g = ld_cg(L.gw + g_off + i);
      acc = __fmaf_rn(g, g, acc);
    }
    for (long long i = first; i < L.dout; i += stride) {
      const float g = ld_cg(L.gb + g_off + i);
      acc = __fmaf_rn(g, g, acc);
    }
  }
  float* red = &sm.a[0][0];  // the product tiles' stage, free between phases
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
// sums, lane j those of blocks j, j + 32, ... in order, then the lanes in a
// fixed butterfly; lane 0's total, the same in every block, gives
// min(1, clip_norm / (sqrt(total) + 1e-6)) rounded as the plain version
// rounds it (a reciprocal, then the product).
__device__ float clip_scale(const Args& a, const Rank& rk, Smem& sm) {
  float* red = &sm.a[0][0];
  if (threadIdx.x < 32) {
    float total = 0.0f;
    for (int i = threadIdx.x; i < rk.blocks; i += 32)
      total = __fadd_rn(total, ld_cg(rk.partial + i));
    for (int lane = 16; lane > 0; lane /= 2)
      total = __fadd_rn(total, __shfl_xor_sync(0xffffffffu, total, lane));
    if (threadIdx.x == 0) {
      const float scale = __fmul_rn(
          __frcp_rn(__fadd_rn(__fsqrt_rn(total), 1e-6f)), a.clip_norm);
      red[0] = fminf(scale, 1.0f);
    }
  }
  __syncthreads();
  return red[0];
}

// One element's update through the shared rule; the parameter and the
// slots the rule has are read through L2 (other blocks wrote them in
// earlier steps).
__device__ __forceinline__ void update(const tinynn::Rule& r, int n_slots,
                                       float* p, const float* g, float* s0,
                                       float* s1, long long i, bool clip,
                                       float clip_by) {
  float gi = ld_cg(g + i);
  if (clip) gi = __fmul_rn(gi, clip_by);
  float v0 = n_slots > 0 ? ld_cg(s0 + i) : 0.0f;
  float v1 = n_slots > 1 ? ld_cg(s1 + i) : 0.0f;
  p[i] = tinynn::apply_rule(r, ld_cg(p + i), gi, v0, v1);
  if (n_slots > 0) s0[i] = v0;
  if (n_slots > 1) s1[i] = v1;
}

__device__ void optimizer_phase(const Args& a, const Rank& rk, int s,
                                long long g_off, Smem& sm) {
  tinynn::Rule r = a.rule;
  r.s0 = __ldg(a.scalars + 2 * s);
  r.s1 = __ldg(a.scalars + 2 * s + 1);
  const int n_slots = tinynn::rule_slots(r.opt);
  const bool clip = a.clip_norm > 0.0f;
  const float clip_by = clip ? clip_scale(a, rk, sm) : 1.0f;
  const long long first = static_cast<long long>(rk.block) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(rk.blocks) * blockDim.x;
  for (int l = 0; l < a.n_layers; ++l) {
    const Layer& L = layers[l];
    const long long nw = static_cast<long long>(L.din) * L.dout;
    for (long long i = first; i < nw; i += stride)
      update(r, n_slots, L.w, L.gw + g_off, L.s0w, L.s1w, i, clip, clip_by);
    for (long long i = first; i < L.dout; i += stride)
      update(r, n_slots, L.b, L.gb + g_off, L.s0b, L.s1b, i, clip, clip_by);
  }
}

// One launch's kernel; kRanked (n_ranks > 1) compiles the exchange in, so
// the one-rank kernel keeps no trace of it. Two blocks an SM: 264 blocks on
// the H100.
template <bool kRanked>
__global__ void __launch_bounds__(THREADS, 2)
fused_epoch_kernel(const __grid_constant__ Args a) {
  __shared__ Smem sm;
  // the rank's view lives in shared memory, not in registers: the product
  // tiles need those
  __shared__ Rank rk;
  tinynn::Group g = tinynn::group_of(a.sync, a.n_ranks, a.blocks);
  if (threadIdx.x < a.n_layers)
    layers[threadIdx.x] = a.tables[g.rank * MAX_LAYERS + threadIdx.x];
  const long long din = a.tables[0].din;
  if (threadIdx.x == 0) {
    const long long dout = a.tables[a.n_layers - 1].dout;
    const long long r = g.rank;
    rk = {a.xb + r * a.n_steps * a.batch * din,
          a.yb + r * a.n_steps * a.batch * dout, a.losses + r * a.n_steps,
          a.row_loss + r * a.batch, a.partial + r * a.blocks,
          a.grads + r * a.grad_stride, g.block, g.blocks};
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
  // the phases of a rank are separated by barriers over its blocks alone
  auto barrier = [&](int phase) {
    tinynn::rank_barrier(g);
    mark(phase);
  };
  const int L = a.n_layers;
  const bool clip = a.clip_norm > 0.0f;
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
      forward_layer(a, rk, l, x, t, sm);
      barrier(l);
    }
    loss_phase(a, rk, s);
    barrier(L);
    for (int l = L - 1; l >= 0; --l) {
      backward_layer(a, rk, l, x, t, written, sm);
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
          a.grads + mean_off + g.rank * stride, a.n_grad, a.vec != 0, true,
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
}

// The co-resident blocks per SM of the one-rank or the ranked kernel, and
// the SM count.
int grid_of(bool ranked, int* blocks_per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm,
      ranked ? fused_epoch_kernel<true> : fused_epoch_kernel<false>,
      THREADS, 0));
}

}  // namespace

// The grid a launch uses: co-resident blocks per SM and the SM count. Each
// of n ranks takes blocks_per_sm * sms / n of them; blocks_per_sm is the
// greater of the one-rank and the ranked kernel's (a scratch sized by it
// fits either).
extern "C" int tinynn_fused_epoch_grid(int* blocks_per_sm, int* sms) {
  int ranked = 0;
  int err = grid_of(false, blocks_per_sm, sms);
  if (err != 0) return err;
  err = grid_of(true, &ranked, sms);
  if (ranked > *blocks_per_sm) *blocks_per_sm = ranked;
  return err;
}

// The bytes of one rank's layer table in device memory.
extern "C" long long tinynn_fused_epoch_table_bytes() {
  return static_cast<long long>(sizeof(Layer)) * MAX_LAYERS;
}

// One epoch of `n_steps` train steps on each of `n_ranks` ranks, in one
// cooperative launch. `dims` holds (din, dout, activation, dropout) for each
// of the `n_layers` Dense layers, `drops` (seed index, keep threshold) and
// `drop_scales` the scale of each layer's Dropout (read where dropout is
// 1), `layer_ptrs` the 12 device pointers of each layer of each rank, rank
// by rank (w, b, gw, gb, s0w, s0b, s1w, s1b, z, h, d, dz; a slot the rule
// does not have, and d without a Dropout, are null; each rank's gw and gb
// lie in its row of `grads`, [planes, n_ranks, grad_stride] with n_grad
// floats a row used: one plane with one rank, three with more, see Args;
// grad_stride >= n_grad). `tables` is a device buffer of n_ranks *
// tinynn_fused_epoch_table_bytes(). `xb`, `yb`, `losses` and `row_loss`
// hold one block per rank (see Args); `partial` is a scratch of
// `partial_len` floats (at least the launch's blocks). `sync` holds
// n_ranks * 2 zeroed counts. `skew_rank` (-1: none) holds that rank back
// `skew_ns` before each step's all-rank arrival (a check of the
// exchange's flow control). `opt`, `c0`-`c3` and `wd`
// are the rule (csrc/optim_rules.cuh), `scalars` [n_steps, 2] its per-step
// scalars, `t0` the step count before the epoch, `clip_norm` the clipping
// norm (0: off). `phase_ns`, where not null, accumulates each phase's time
// (see Args). Launches on `stream` and does not synchronise. Returns the
// CUDA error of the launch (0 when it was accepted); cudaErrorNotSupported
// when the device cannot launch cooperatively.
extern "C" int tinynn_fused_epoch(
    int n_ranks, int n_layers, const int* dims, const unsigned int* drops,
    const float* drop_scales, void* const* layer_ptrs, void* tables,
    const float* xb, const float* yb, const float* class_weight,
    const float* scalars, float* losses, float* row_loss, float* partial,
    int partial_len, float* grads, long long n_grad, long long grad_stride,
    unsigned* sync, int batch, int n_steps, unsigned int t0, int opt,
    float c0, float c1, float c2, float c3, float wd, float clip_norm,
    int bf16, int skew_rank, long long skew_ns, unsigned long long* phase_ns,
    void* stream) {
  if (n_ranks < 1 || n_layers < 1 || n_layers > MAX_LAYERS || batch < 1 ||
      n_steps < 1 || opt < tinynn::kSGD || opt > tinynn::kAdadelta ||
      grad_stride < n_grad)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);

  int blocks_per_sm = 0, sms = 0;
  const int grid_err = grid_of(n_ranks > 1, &blocks_per_sm, &sms);
  if (grid_err != 0) return grid_err;
  const int blocks = blocks_per_sm * sms / n_ranks;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (clip_norm > 0.0f && partial_len < blocks * n_ranks)
    return static_cast<int>(cudaErrorInvalidValue);

  std::vector<Layer> table(static_cast<size_t>(n_ranks) * MAX_LAYERS);
  for (int r = 0; r < n_ranks; ++r) {
    for (int l = 0; l < n_layers; ++l) {
      Layer& L = table[r * MAX_LAYERS + l];
      L.din = dims[4 * l];
      L.dout = dims[4 * l + 1];
      L.act = dims[4 * l + 2];
      L.drop = dims[4 * l + 3];
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
      L.out = L.drop ? L.d : L.h;
    }
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
  a.tables = static_cast<const Layer*>(tables);
  a.xb = xb;
  a.yb = yb;
  a.cw = class_weight;
  a.scalars = scalars;
  a.losses = losses;
  a.row_loss = row_loss;
  a.partial = partial;
  a.grads = grads;
  a.n_grad = n_grad;
  a.sync = sync;
  a.grad_stride = grad_stride;
  a.vec = grad_stride % 4 == 0 &&
          (reinterpret_cast<uintptr_t>(grads) & 15u) == 0;
  a.skew = {skew_rank, skew_ns};
  a.ring_scale = static_cast<float>(1.0 / n_ranks);
  a.phase_ns = phase_ns;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      n_ranks > 1 ? reinterpret_cast<const void*>(fused_epoch_kernel<true>)
                  : reinterpret_cast<const void*>(fused_epoch_kernel<false>),
      dim3(blocks * n_ranks), dim3(THREADS), params, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
