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
// ReLU, Sigmoid or Tanh (Flatten is a reshape done by the caller), softmax
// cross-entropy with optional class weights, and SGD or Adam with weight
// decay.
//
// How the TPU design translates:
// - The sequential grid becomes a loop over the steps inside ONE persistent
//   cooperative launch: as many blocks as fit on the card at once
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), with the phases
//   of a step separated by grid-wide barriers (cooperative_groups
//   this_grid().sync()). Per step: one phase per Dense forward, one for the
//   loss, one per Dense backward (dW, db and the previous layer's dz
//   together), one for the optimizer: 2 x layers + 2 barriers, 12 for the
//   flagship MLP. Every gradient is taken before any weight changes.
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
// 49 us at 3.35 TB/s. What holds this simple design back: 12 grid barriers
// a step, and narrow layers that leave most SMs idle (the first layer's
// forward is 28 tiles of 25 stages each, on 132 SMs). Sharding the state
// into shared memory, splitting K, and tensor cores are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LAYERS = 16;
constexpr int THREADS = 256;
constexpr int TILE = 32;         // output tile edge
constexpr int BK = 32;           // depth of one shared-memory stage
constexpr int PER = TILE / 16;   // outputs per thread along each tile edge
constexpr int PTRS_PER_LAYER = 11;

enum Act { kNone = 0, kReLU = 1, kSigmoid = 2, kTanh = 3 };
enum Opt { kSGD = 0, kAdam = 1 };

struct Layer {
  int din, dout, act;
  float* w;   // [din, dout], updated in place
  float* b;   // [1, dout], updated in place
  float* gw;  // gradients, same shapes
  float* gb;
  float* mw;  // Adam first moments (null for SGD)
  float* mb;
  float* vw;  // Adam second moments (null for SGD)
  float* vb;
  float* z;   // pre-activation [batch, dout]
  float* h;   // activation output [batch, dout]; == z without activation
  float* dz;  // loss gradient with respect to z [batch, dout]
};

struct Args {
  int n_layers, batch, n_steps, opt, bf16;
  float b1c, b2c, eps, wd;  // 1 - beta1, 1 - beta2, epsilon, weight decay
  const float* xb;       // [n_steps, batch, layer[0].din]
  const float* yb;       // [n_steps, batch, layer[n_layers - 1].dout]
  const float* cw;       // class weights [dout of the last layer] or null
  const float* scalars;  // [n_steps, 2]: Adam (-lr/c1, rsqrt(c2)); SGD (-lr, 0)
  float* losses;         // [n_steps]
  float* row_loss;       // [batch] scratch
  // [2 * n_layers + 2] or null: block 0's time (ns) from one barrier to the
  // next, summed over the steps, for each phase: the forwards, the loss,
  // the backwards (last layer first), the optimizer
  unsigned long long* phase_ns;
  Layer layer[MAX_LAYERS];
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

// A load of data written inside the launch: through L2 (never a stale L1
// line), and volatile with a memory clobber, so that the compiler neither
// merges it with a load of an earlier step nor moves it across a barrier
// (__ldcg is a plain asm statement that it may hoist or merge).
__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float load_operand(const View& v, int i, int j,
                                              bool bf16) {
  const float x = ld_cg(v.p + static_cast<long long>(i) * v.rs +
                         static_cast<long long>(j) * v.cs);
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
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

// z = h_in @ w + b and h = act(z), for one Dense layer.
__device__ void forward_layer(const Args& a, int l, const float* x,
                              Smem& sm) {
  const Layer& L = a.layer[l];
  const View in = {l == 0 ? x : a.layer[l - 1].h, L.din, 1};
  const View w = {L.w, L.dout, 1};
  const int tiles = tiles_of(a.batch, L.dout);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    product_tile(in, w, a.batch, L.dout, L.din, t, a.bf16, sm,
                 [&](int r, int c, float v) {
                   const float z = __fadd_rn(v, ld_cg(L.b + c));
                   const long long o = static_cast<long long>(r) * L.dout + c;
                   L.z[o] = z;
                   if (L.act != kNone) L.h[o] = activate(L.act, z);
                 });
  }
}

// Softmax cross-entropy over the last layer's output: the step's loss and
// the gradient with respect to the last layer's z. One block; one thread a
// row, with the same sequence of operations as the tape.
__device__ void loss_phase(const Args& a, int s) {
  if (blockIdx.x != 0) return;
  const Layer& L = a.layer[a.n_layers - 1];
  const int C = L.dout;
  const float* y = a.yb + static_cast<long long>(s) * a.batch * C;
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
    a.row_loss[r] = nll;
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
    for (int r = 0; r < a.batch; ++r) total = __fadd_rn(total, a.row_loss[r]);
    a.losses[s] = __fdiv_rn(total, static_cast<float>(a.batch));
  }
}

// dW = h_in^T @ dz, db = sum over rows of dz, and (but for the first layer)
// the previous layer's dz = act'(dz @ W^T), as one phase of work items.
__device__ void backward_layer(const Args& a, int l, const float* x,
                               Smem& sm) {
  const Layer& L = a.layer[l];
  const View h_t = {l == 0 ? x : a.layer[l - 1].h, 1, L.din};  // [din, batch]
  const View dz = {L.dz, L.dout, 1};                           // [batch, dout]
  const View w_t = {L.w, 1, L.dout};                           // [dout, din]
  const int n_dw = tiles_of(L.din, L.dout);
  const int n_dh = l > 0 ? tiles_of(a.batch, L.din) : 0;
  const int n_db = (L.dout + THREADS - 1) / THREADS;
  for (int t = blockIdx.x; t < n_dw + n_dh + n_db; t += gridDim.x) {
    if (t < n_dw) {
      product_tile(h_t, dz, L.din, L.dout, a.batch, t, a.bf16, sm,
                   [&](int r, int c, float v) {
                     L.gw[static_cast<long long>(r) * L.dout + c] = v;
                   });
    } else if (t < n_dw + n_dh) {
      const Layer& P = a.layer[l - 1];
      product_tile(dz, w_t, a.batch, L.din, L.dout, t - n_dw, a.bf16, sm,
                   [&](int r, int c, float v) {
                     const long long o = static_cast<long long>(r) * P.dout + c;
                     P.dz[o] = activation_grad(P.act, v, ld_cg(P.z + o),
                                               ld_cg(P.h + o));
                   });
    } else {
      const int c = (t - n_dw - n_dh) * THREADS + threadIdx.x;
      if (c < L.dout) {
        float sum = 0.0f;
        for (int r = 0; r < a.batch; ++r)
          sum = __fadd_rn(sum, ld_cg(L.dz + static_cast<long long>(r) * L.dout + c));
        L.gb[c] = sum;
      }
    }
  }
}

// One optimizer update of one parameter element, as nn/optimizer.py's.
__device__ __forceinline__ void update(const Args& a, float* p,
                                       const float* g, float* m, float* v,
                                       long long i, float scale,
                                       float rsqrt_c2) {
  const float gi = ld_cg(g + i);
  const float pi = ld_cg(p + i);
  float step;
  if (a.opt == kAdam) {
    float mi = ld_cg(m + i);
    float vi = ld_cg(v + i);
    mi = __fadd_rn(mi, __fmul_rn(a.b1c, __fsub_rn(gi, mi)));
    vi = __fadd_rn(vi, __fmul_rn(a.b2c, __fsub_rn(__fmul_rn(gi, gi), vi)));
    m[i] = mi;
    v[i] = vi;
    step = __fdiv_rn(__fmul_rn(scale, mi),
                     __fadd_rn(__fmul_rn(__fsqrt_rn(vi), rsqrt_c2), a.eps));
  } else {
    step = __fmul_rn(scale, gi);
  }
  if (a.wd != 0.0f) step = __fsub_rn(step, __fmul_rn(a.wd, pi));
  p[i] = __fadd_rn(pi, step);
}

__device__ void optimizer_phase(const Args& a, int s) {
  const float scale = __ldg(a.scalars + 2 * s);
  const float rsqrt_c2 = __ldg(a.scalars + 2 * s + 1);
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int l = 0; l < a.n_layers; ++l) {
    const Layer& L = a.layer[l];
    const long long nw = static_cast<long long>(L.din) * L.dout;
    for (long long i = first; i < nw; i += stride)
      update(a, L.w, L.gw, L.mw, L.vw, i, scale, rsqrt_c2);
    for (long long i = first; i < L.dout; i += stride)
      update(a, L.b, L.gb, L.mb, L.vb, i, scale, rsqrt_c2);
  }
}

__global__ void __launch_bounds__(THREADS)
fused_epoch_kernel(const __grid_constant__ Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Smem sm;
  const bool timed = a.phase_ns != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long last = timed ? global_ns() : 0;
  auto barrier = [&](int phase) {
    grid.sync();
    if (timed) {
      const unsigned long long now = global_ns();
      a.phase_ns[phase] += now - last;
      last = now;
    }
  };
  const int L = a.n_layers;
  for (int s = 0; s < a.n_steps; ++s) {
    const float* x = a.xb + static_cast<long long>(s) * a.batch * a.layer[0].din;
    for (int l = 0; l < L; ++l) {
      forward_layer(a, l, x, sm);
      barrier(l);
    }
    loss_phase(a, s);
    barrier(L);
    for (int l = L - 1; l >= 0; --l) {
      backward_layer(a, l, x, sm);
      barrier(2 * L - l);
    }
    optimizer_phase(a, s);
    barrier(2 * L + 1);
  }
}

}  // namespace

// The grid the launch uses: co-resident blocks per SM and the SM count.
extern "C" int tinynn_fused_epoch_grid(int* blocks_per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fused_epoch_kernel, THREADS, 0));
}

// One epoch of `n_steps` train steps. `dims` holds (din, dout, activation)
// for each of the `n_layers` Dense layers, `layer_ptrs` the 11 device
// pointers of each (w, b, gw, gb, mw, mb, vw, vb, z, h, dz; the moments are
// null for SGD). `phase_ns`, where not null, accumulates each phase's time
// (see Args). Launches on `stream` and does not synchronise. Returns the
// CUDA error of the launch (0 when it was accepted); cudaErrorNotSupported
// when the device cannot launch cooperatively.
extern "C" int tinynn_fused_epoch(
    int n_layers, const int* dims, void* const* layer_ptrs, const float* xb,
    const float* yb, const float* class_weight, const float* scalars,
    float* losses, float* row_loss, int batch, int n_steps, int opt,
    float b1c, float b2c, float eps, float wd, int bf16,
    unsigned long long* phase_ns, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || batch < 1 || n_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);

  Args a = {};
  a.n_layers = n_layers;
  a.batch = batch;
  a.n_steps = n_steps;
  a.opt = opt;
  a.bf16 = bf16;
  a.b1c = b1c;
  a.b2c = b2c;
  a.eps = eps;
  a.wd = wd;
  a.xb = xb;
  a.yb = yb;
  a.cw = class_weight;
  a.scalars = scalars;
  a.losses = losses;
  a.row_loss = row_loss;
  a.phase_ns = phase_ns;
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = a.layer[l];
    L.din = dims[3 * l];
    L.dout = dims[3 * l + 1];
    L.act = dims[3 * l + 2];
    float* const* p =
        reinterpret_cast<float* const*>(layer_ptrs + PTRS_PER_LAYER * l);
    L.w = p[0];
    L.b = p[1];
    L.gw = p[2];
    L.gb = p[3];
    L.mw = p[4];
    L.mb = p[5];
    L.vw = p[6];
    L.vb = p[7];
    L.z = p[8];
    L.h = p[9];
    L.dz = p[10];
  }

  int blocks_per_sm = 0, sms = 0;
  const int grid_err = tinynn_fused_epoch_grid(&blocks_per_sm, &sms);
  if (grid_err != 0) return grid_err;
  if (blocks_per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_epoch_kernel),
      dim3(blocks_per_sm * sms), dim3(THREADS), params, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
