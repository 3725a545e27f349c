// Recurrent kernels for Hopper (sm_90a): K5, the LSTM forward; K5b, its
// backward; K5c, the GRU forward; K5d, its backward. One launch runs every
// time step of one layer in one direction.
//
// Replaces the TPU kernels of tinynn_autograd_tpu/ops/recurrent_kernel.py:
// `_fwd_kernel` (:71, through lstm_fwd_pallas), `_bwd_kernel` (:137, through
// lstm_bwd_pallas), `_gru_fwd_kernel` (:226) and `_gru_bwd_kernel` (:288).
// There the grid walks chunks of time steps in order on one core, with wh
// (or wh^T) whole in VMEM and the carried state in VMEM scratch; a step is
// one MXU product [B, H] x [H, G H] (the backward's [B, G H] x [G H, H]) and
// the gate arithmetic, G = 4 gates for the LSTM (i, f, g, o) and 3 for the
// GRU (z, r, n).
//
// How the TPU design translates:
// - wh does not fit one SM: at H = 256 the LSTM's [256, 1024] f32 is 1 MB
//   against the 227 KB of shared memory a block may use. A thread block
//   cluster of CS blocks (1, 2, 4 or 8: the fewest whose shares fit) splits
//   the hidden units: block q owns units [q U, q U + U), U = ceil(H / CS),
//   and keeps in shared memory, for the whole launch, the G gate columns of
//   wh for its units (forward) or the rows of wh for them (backward). A
//   cluster owns R batch rows (1 to 8); clusters are independent, so
//   several of them fill the card. A block of this size holds an SM alone
//   and a cluster needs CS SMs of one GPC, so the card holds fewer clusters
//   than SMs / CS: the wrapper asks it (tinynn_recurrent_max_clusters) and
//   picks the fewest rows whose clusters run in one wave.
// - A step's product needs the whole carried row (h forward; the gate
//   cotangent dz backward), but each block makes only its own units' part
//   of it. Each thread stores the values it makes into its own block's
//   panel and into every other block's (distributed shared memory), and
//   one cluster barrier a step hands the panels over. Panels are double
//   buffered: a block stores into the buffer that the others read during
//   the step before, and every block finished that step before the barrier
//   that ended it.
// - The backward's dh = dz @ wh^T needs every block's dz: each block
//   receives the whole dz row (as above) and multiplies it by the rows of wh
//   of its own units. Every sum has one fixed order and there are no
//   atomics, so reruns are bit-identical.
// - reverse=True walks the time index backwards in the forward and forwards
//   in the backward, as the TPU kernels flip their index maps.
//
// What bounds it at config 8 (B = 64, T = 128, H = 256, f32): the LSTM
// forward does 4.30 GFLOP (64 us at 67 TFLOP/s f32 FMA) and moves 85 MB
// (25 us at 3.35 TB/s). But each of the 128 steps needs the one before: a
// step is a [R, 256] x [256, 128] product in each block, the gate
// arithmetic and a cluster barrier, whose latency, not the card's rates,
// sets the time. This first version keeps every operand in shared memory and
// multiplies on the CUDA cores in f32; tensor cores and weights held in
// registers are later work.
//
// Shape rule: any T, B >= 1 and H >= 1 whose share fits: U <= 256 and the
// share, two panels of R rows and the partial sums within 227 KB. With
// clusters of 8 that holds up to H = 328 (LSTM) and H = 384 (GRU). The
// wrapper (ops/recurrent_kernel.py, `plan`) picks CS and R; `layout`
// below and `_layout` there compute the same sizes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_KPARTS = 8;
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use (227 KB)

enum Cell { kLSTM = 0, kGRU = 1 };

// The sizes of one launch.
struct Layout {
  int U;        // hidden units a block owns
  int K;        // the product's depth, padded to a multiple of 4: a panel row
  int N;        // the product's columns in a block
  int kparts;   // the product's partitions of K (their sums meet in `red`)
  int kchunk;   // K a partition takes, a multiple of 4
  size_t smem;  // dynamic shared memory, bytes
};

int round4(int x) { return (x + 3) / 4 * 4; }

Layout layout(int H, int G, bool backward, int cluster, int rows) {
  Layout l;
  l.U = (H + cluster - 1) / cluster;
  l.K = round4(backward ? G * H : H);
  l.N = backward ? l.U : G * l.U;
  l.kparts = THREADS / l.N;
  if (l.kparts < 1) l.kparts = 1;
  if (l.kparts > MAX_KPARTS) l.kparts = MAX_KPARTS;
  l.kchunk = round4((l.K + l.kparts - 1) / l.kparts);
  l.smem = sizeof(float) * (static_cast<size_t>(l.K) * l.N +
                            2 * static_cast<size_t>(rows) * l.K +
                            static_cast<size_t>(l.kparts) * rows * l.N);
  return l;
}

struct Args {
  const float* in;     // forward: xp [T,B,4H] or ap [T,B,3H]; backward: gt
  const float* w;      // element (i, j) at w[i ws0 + j ws1]: wh [H, G H]
                       // forward, wh^T [G H, H] backward
  long long ws0, ws1;
  const float* h0;     // forward: [B, H]
  const float* c0;     // LSTM forward: [B, H]
  const float* gates;  // backward: [T, B, G H]
  const float* a1;     // LSTM backward: cs; GRU backward: hprev [T, B, H]
  const float* a2;     // LSTM backward: cprev; GRU backward: un [T, B, H]
  float* o0;           // forward: hs [T,B,H]; backward: dzs or das [T,B,G H]
  float* o1;           // LSTM forward: cs; GRU forward: un; GRU backward: dus
  float* o2;           // forward: gates [T, B, G H]
  float* dh0;          // backward: [B, H]
  float* dc0;          // LSTM backward: [B, H]
  unsigned long long* phase_ns;  // null, or [PHASES] (see PhaseClock)
  int T, B, H, reverse;
  Layout l;
};

constexpr int PHASES = 4;

// Where, when `phase_ns` is not null, block 0's thread 0 adds the time of
// each phase of the launch (globaltimer, ns): 0 the set-up (the share of wh
// and the panels), then per step the phases in the kernel's order (forward:
// 1 the product, 2 the gate arithmetic and the stores, 3 the cluster
// barrier; backward: 1 the gate arithmetic and the stores, 2 the barrier,
// 3 the product). A phase ends when thread 0 leaves it, so the barrier's
// time includes the wait for the slowest block.
struct PhaseClock {
  unsigned long long* out;
  unsigned long long last = 0, sum[PHASES] = {};

  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ explicit PhaseClock(unsigned long long* phase_ns)
      : out(blockIdx.x == 0 && threadIdx.x == 0 ? phase_ns : nullptr) {
    if (out) last = now();
  }
  __device__ void mark(int phase) {
    if (!out) return;
    const unsigned long long t = now();
    sum[phase] += t - last;
    last = t;
  }
  __device__ void flush() {
    if (out)
      for (int p = 0; p < PHASES; ++p) out[p] += sum[p];
  }
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ long long at(int t, int B, int b, int width) {
  return (static_cast<long long>(t) * B + b) * width;
}

// red[kp][r][n] = sum over k of partition kp of P[r][k] W[k][n]: P is the
// [R, K] panel, W the block's [K, N] share. A thread takes one (n, kp) at a
// time and all R rows, so each W element is read once a step; neighbouring
// lanes take neighbouring n (conflict-free), and the panel's 16-byte reads
// are broadcasts.
template <int R>
__device__ void product(const float* P, const float* W, float* red,
                        const Layout& l) {
  const int K = l.K, N = l.N;
  for (int i = threadIdx.x; i < N * l.kparts; i += THREADS) {
    const int n = i % N;
    const int kp = i / N;
    const int k_begin = kp * l.kchunk;
    const int k_end = min(K, k_begin + l.kchunk);
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    const float* wn = W + n;
#pragma unroll 2
    for (int k = k_begin; k < k_end; k += 4) {
      const float w0 = wn[k * N];
      const float w1 = wn[(k + 1) * N];
      const float w2 = wn[(k + 2) * N];
      const float w3 = wn[(k + 3) * N];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(P + r * K + k);
        acc[r] = fmaf(p.x, w0, acc[r]);
        acc[r] = fmaf(p.y, w1, acc[r]);
        acc[r] = fmaf(p.z, w2, acc[r]);
        acc[r] = fmaf(p.w, w3, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) red[(kp * R + r) * N + n] = acc[r];
  }
}

// The product's value at (r, n): the partitions' sums in order.
template <int R>
__device__ __forceinline__ float product_at(const float* red, const Layout& l,
                                            int r, int n) {
  float s = 0.0f;
  for (int kp = 0; kp < l.kparts; ++kp) s += red[(kp * R + r) * l.N + n];
  return s;
}

// Stores v at dst in this block's panel and at the same place in every other
// block's of the cluster.
__device__ __forceinline__ void share(cg::cluster_group& cluster, float* dst,
                                      float v, int rank, int cs) {
  *dst = v;
  for (int q = 0; q < cs; ++q)
    if (q != rank) *cluster.map_shared_rank(dst, q) = v;
}

// ---------------------------------------------------------------------------
// K5 and K5c: the forward. Shared memory: ws[K][N] (column n = g U + j is
// wh's column g H + u0 + j), panel[2][R][K] (h), red[kparts][R][N].
// Thread i < R U takes row i / U and unit u0 + i % U of the gate arithmetic,
// and keeps the LSTM's c in a register.
// ---------------------------------------------------------------------------
template <int R, int CELL>
__global__ void __launch_bounds__(THREADS)
recurrent_forward_kernel(const __grid_constant__ Args a) {
  constexpr int G = CELL == kLSTM ? 4 : 3;
  PhaseClock clock(a.phase_ns);
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const Layout& l = a.l;
  const int H = a.H, B = a.B, U = l.U, K = l.K, N = l.N;
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / cs) * R;
  const int u0 = rank * U;
  float* ws = smem;
  float* panel = ws + static_cast<size_t>(K) * N;
  float* red = panel + 2 * R * K;

  for (int i = threadIdx.x; i < K * N; i += THREADS) {
    const int k = i / N, n = i % N, u = u0 + n % U;
    const long long col = (n / U) * H + u;
    ws[i] = k < H && u < H ? a.w[k * a.ws0 + col * a.ws1] : 0.0f;
  }
  // panel 0: the cluster's rows of h0; panel 1 and the padding: zero
  for (int i = threadIdx.x; i < 2 * R * K; i += THREADS) {
    const int r = (i / K) % R, k = i % K;
    panel[i] = i < R * K && row0 + r < B && k < H ? a.h0[(row0 + r) * H + k]
                                                   : 0.0f;
  }
  const int pr = threadIdx.x / U, pj = threadIdx.x % U;
  const int b = row0 + pr, u = u0 + pj;
  const bool own = threadIdx.x < R * U && b < B && u < H;
  float c = 0.0f;
  if constexpr (CELL == kLSTM) {
    if (own) c = a.c0[b * H + u];
  }
  // every block's panels are set before any block stores into them
  cluster.sync();
  clock.mark(0);

  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    const float* cur = panel + (s & 1) * R * K;
    float* next = panel + ((s + 1) & 1) * R * K;
    // the pair's projected inputs, in flight during the product
    float x[G];
    if (own) {
      const float* xt = a.in + at(t, B, b, G * H) + u;
#pragma unroll
      for (int g = 0; g < G; ++g) x[g] = xt[g * H];
    }
    product<R>(cur, ws, red, l);
    __syncthreads();
    clock.mark(1);
    if (own) {
      const long long o = at(t, B, b, H) + u;
      float* gp = a.o2 + at(t, B, b, G * H) + u;
      float h;
      if constexpr (CELL == kLSTM) {
        const float ig = sigmoid(x[0] + product_at<R>(red, l, pr, pj));
        const float fg = sigmoid(x[1] + product_at<R>(red, l, pr, U + pj));
        const float gg = tanhf(x[2] + product_at<R>(red, l, pr, 2 * U + pj));
        const float og = sigmoid(x[3] + product_at<R>(red, l, pr, 3 * U + pj));
        c = fg * c + ig * gg;
        h = og * tanhf(c);
        gp[0] = ig;
        gp[H] = fg;
        gp[2 * H] = gg;
        gp[3 * H] = og;
        a.o1[o] = c;
      } else {
        const float hp = cur[pr * K + u];
        const float uz = product_at<R>(red, l, pr, pj);
        const float ur = product_at<R>(red, l, pr, U + pj);
        const float un = product_at<R>(red, l, pr, 2 * U + pj);
        const float z = sigmoid(x[0] + uz);
        const float r = sigmoid(x[1] + ur);
        const float n = tanhf(x[2] + r * un);
        h = (1.0f - z) * n + z * hp;
        gp[0] = z;
        gp[H] = r;
        gp[2 * H] = n;
        a.o1[o] = un;
      }
      a.o0[o] = h;
      if (s + 1 < a.T) share(cluster, next + pr * K + u, h, rank, cs);
    }
    clock.mark(2);
    // hands the new h over; after the last step no block reads another's
    // memory, so every block may exit
    if (s + 1 < a.T) cluster.sync();
    clock.mark(3);
  }
  clock.flush();
}

// ---------------------------------------------------------------------------
// K5b and K5d: the backward, last step first (first step first for a reverse
// cell). Shared memory: ws[K][N] with ws[k][j] = wh[u0 + j][k] (the rows of
// wh for the block's units), panel[2][R][K] (the LSTM's dz, the GRU's du),
// red[kparts][R][U]. The pair threads carry (dh, dc) in registers.
// ---------------------------------------------------------------------------
template <int R, int CELL>
__global__ void __launch_bounds__(THREADS)
recurrent_backward_kernel(const __grid_constant__ Args a) {
  constexpr int G = CELL == kLSTM ? 4 : 3;
  PhaseClock clock(a.phase_ns);
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const Layout& l = a.l;
  const int H = a.H, B = a.B, U = l.U, K = l.K, N = l.N;
  const int GH = G * H;
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / cs) * R;
  const int u0 = rank * U;
  float* ws = smem;
  float* panel = ws + static_cast<size_t>(K) * N;
  float* red = panel + 2 * R * K;

  for (int i = threadIdx.x; i < K * N; i += THREADS) {
    const int k = i / N, u = u0 + i % N;
    ws[i] = k < GH && u < H ? a.w[k * a.ws0 + u * a.ws1] : 0.0f;
  }
  for (int i = threadIdx.x; i < 2 * R * K; i += THREADS) panel[i] = 0.0f;
  const int pr = threadIdx.x / U, pj = threadIdx.x % U;
  const int b = row0 + pr, u = u0 + pj;
  const bool own = threadIdx.x < R * U && b < B && u < H;

  // the pair's inputs of a step: the output cotangent, the gates, and the
  // LSTM's c and c_prev or the GRU's h_prev and un
  float gt = 0.0f, g4[G] = {}, v1 = 0.0f, v2 = 0.0f;
  auto load = [&](int s) {
    const int t = a.reverse ? s : a.T - 1 - s;
    const long long o = at(t, B, b, H) + u;
    gt = a.in[o];
    v1 = a.a1[o];
    v2 = a.a2[o];
    const float* gp = a.gates + at(t, B, b, GH) + u;
#pragma unroll
    for (int g = 0; g < G; ++g) g4[g] = gp[g * H];
  };
  if (own) load(0);
  float dh = 0.0f, dc = 0.0f;
  cluster.sync();
  clock.mark(0);

  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? s : a.T - 1 - s;
    float keep = 0.0f;
    if (own) {
      float* P = panel + (s & 1) * R * K + pr * K + u;
      float* d0 = a.o0 + at(t, B, b, GH) + u;
      if constexpr (CELL == kLSTM) {
        const float ig = g4[0], fg = g4[1], gg = g4[2], og = g4[3];
        const float tc = tanhf(v1);
        const float dht = gt + dh;
        const float dout = dht * tc;
        const float dct = dht * og * (1.0f - tc * tc) + dc;
        const float di = dct * gg;
        const float dg = dct * ig;
        const float df = dct * v2;
        const float dz[4] = {di * ig * (1.0f - ig), df * fg * (1.0f - fg),
                             dg * (1.0f - gg * gg), dout * og * (1.0f - og)};
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          d0[g * H] = dz[g];
          share(cluster, P + g * H, dz[g], rank, cs);
        }
        dc = dct * fg;
      } else {
        const float z = g4[0], r = g4[1], n = g4[2];
        const float dht = gt + dh;
        const float dzg = dht * (v1 - n);
        const float dn = dht * (1.0f - z) * (1.0f - n * n);
        const float dr = dn * v2;
        const float dun = dn * r;
        const float daz = dzg * z * (1.0f - z);
        const float dar = dr * r * (1.0f - r);
        float* d1 = a.o1 + at(t, B, b, GH) + u;
        d0[0] = daz;
        d0[H] = dar;
        d0[2 * H] = dn;
        d1[0] = daz;
        d1[H] = dar;
        d1[2 * H] = dun;
        share(cluster, P, daz, rank, cs);
        share(cluster, P + H, dar, rank, cs);
        share(cluster, P + 2 * H, dun, rank, cs);
        keep = dht * z;
      }
    }
    clock.mark(1);
    cluster.sync();
    clock.mark(2);
    if (own && s + 1 < a.T) load(s + 1);
    product<R>(panel + (s & 1) * R * K, ws, red, l);
    __syncthreads();
    if (own) {
      const float p = product_at<R>(red, l, pr, pj);
      dh = CELL == kLSTM ? p : keep + p;
    }
    clock.mark(3);
  }
  clock.flush();
  // the last barrier above ended every access to another block's memory
  if (own) {
    a.dh0[b * H + u] = dh;
    if constexpr (CELL == kLSTM) a.dc0[b * H + u] = dc;
  }
}

using Kernel = void (*)(Args);

template <int CELL, bool BACKWARD, int R>
Kernel kernel_rows() {
  if constexpr (BACKWARD)
    return recurrent_backward_kernel<R, CELL>;
  else
    return recurrent_forward_kernel<R, CELL>;
}

// The kernel that takes `rows` batch rows a cluster, or null.
template <int CELL, bool BACKWARD>
Kernel kernel_for(int rows) {
  switch (rows) {
    case 1: return kernel_rows<CELL, BACKWARD, 1>();
    case 2: return kernel_rows<CELL, BACKWARD, 2>();
    case 3: return kernel_rows<CELL, BACKWARD, 3>();
    case 4: return kernel_rows<CELL, BACKWARD, 4>();
    case 5: return kernel_rows<CELL, BACKWARD, 5>();
    case 6: return kernel_rows<CELL, BACKWARD, 6>();
    case 7: return kernel_rows<CELL, BACKWARD, 7>();
    case 8: return kernel_rows<CELL, BACKWARD, 8>();
    default: return nullptr;
  }
}

// A launch on clusters of `cluster` blocks, each on `rows` batch rows.
struct Launch {
  Kernel kernel = nullptr;
  Layout l;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
};

// Checks the plan (cluster, rows) for batch B and hidden width H, and fills
// `x` with its kernel, layout and configuration, the kernel allowed its
// shared memory.
template <int CELL, bool BACKWARD>
cudaError_t prepare(int B, int H, int cluster, int rows, cudaStream_t stream,
                    Launch* x) {
  constexpr int G = CELL == kLSTM ? 4 : 3;
  if (B < 1 || H < 1 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return cudaErrorInvalidValue;
  x->kernel = kernel_for<CELL, BACKWARD>(rows);
  x->l = layout(H, G, BACKWARD, cluster, rows);
  if (x->kernel == nullptr || x->l.U * rows > THREADS ||
      x->l.smem > SMEM_LIMIT)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      x->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(x->l.smem));
  if (err != cudaSuccess) return err;
  x->cfg.gridDim = dim3(((B + rows - 1) / rows) * cluster);
  x->cfg.blockDim = dim3(THREADS);
  x->cfg.dynamicSmemBytes = x->l.smem;
  x->cfg.stream = stream;
  x->attr[0].id = cudaLaunchAttributeClusterDimension;
  x->attr[0].val.clusterDim.x = cluster;
  x->attr[0].val.clusterDim.y = 1;
  x->attr[0].val.clusterDim.z = 1;
  x->cfg.attrs = x->attr;
  x->cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int CELL, bool BACKWARD>
int launch(Args a, int cluster, int rows, void* stream) {
  if (a.T < 1) return static_cast<int>(cudaErrorInvalidValue);
  Launch x;
  cudaError_t err = prepare<CELL, BACKWARD>(
      a.B, a.H, cluster, rows, static_cast<cudaStream_t>(stream), &x);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.l = x.l;
  err = cudaLaunchKernelEx(&x.cfg, x.kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int CELL, bool BACKWARD>
int max_clusters(int H, int cluster, int rows, int* out) {
  Launch x;
  const cudaError_t err =
      prepare<CELL, BACKWARD>(rows, H, cluster, rows, nullptr, &x);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, x.kernel, &x.cfg));
}

}  // namespace

// Each function launches one kernel on `stream` and does not synchronise;
// it returns the CUDA error of the launch (0 when it was accepted). Every
// tensor is contiguous f32 but wh (wh^T), read through its strides.
// `cluster` and `rows` come from the wrapper's plan; `phase_ns`, where not
// null, accumulates block 0's time in each phase (see PhaseClock).

// K5: (hs, cs [T,B,H], gates [T,B,4H]) of the LSTM over xp [T,B,4H] (the
// input projection with its bias), wh [H,4H], h0 and c0 [B,H].
extern "C" int tinynn_lstm_forward(const float* xp, const float* wh,
                                   long long ws0, long long ws1,
                                   const float* h0, const float* c0,
                                   float* hs, float* cs, float* gates, int T,
                                   int B, int H, int reverse, int cluster,
                                   int rows, unsigned long long* phase_ns,
                                   void* stream) {
  Args a = {};
  a.in = xp;
  a.w = wh;
  a.ws0 = ws0;
  a.ws1 = ws1;
  a.h0 = h0;
  a.c0 = c0;
  a.o0 = hs;
  a.o1 = cs;
  a.o2 = gates;
  a.T = T;
  a.B = B;
  a.H = H;
  a.reverse = reverse;
  a.phase_ns = phase_ns;
  return launch<kLSTM, false>(a, cluster, rows, stream);
}

// K5b: (dzs [T,B,4H], dh0, dc0 [B,H]) from the output cotangent gt
// [T,B,H], the forward's gates [T,B,4H], cs and cprev [T,B,H], and whT
// [4H,H].
extern "C" int tinynn_lstm_backward(const float* gt, const float* gates,
                                    const float* cs, const float* cprev,
                                    const float* whT, long long ws0,
                                    long long ws1, float* dzs, float* dh0,
                                    float* dc0, int T, int B, int H,
                                    int reverse, int cluster, int rows,
                                    unsigned long long* phase_ns,
                                    void* stream) {
  Args a = {};
  a.in = gt;
  a.gates = gates;
  a.a1 = cs;
  a.a2 = cprev;
  a.w = whT;
  a.ws0 = ws0;
  a.ws1 = ws1;
  a.o0 = dzs;
  a.dh0 = dh0;
  a.dc0 = dc0;
  a.T = T;
  a.B = B;
  a.H = H;
  a.reverse = reverse;
  a.phase_ns = phase_ns;
  return launch<kLSTM, true>(a, cluster, rows, stream);
}

// K5c: (hs [T,B,H], gates (z, r, n) [T,B,3H], un [T,B,H]) of the GRU over
// ap [T,B,3H] (the input projection with its bias), wh [H,3H] and h0 [B,H].
extern "C" int tinynn_gru_forward(const float* ap, const float* wh,
                                  long long ws0, long long ws1,
                                  const float* h0, float* hs, float* gates,
                                  float* un, int T, int B, int H, int reverse,
                                  int cluster, int rows,
                                  unsigned long long* phase_ns,
                                  void* stream) {
  Args a = {};
  a.in = ap;
  a.w = wh;
  a.ws0 = ws0;
  a.ws1 = ws1;
  a.h0 = h0;
  a.o0 = hs;
  a.o1 = un;
  a.o2 = gates;
  a.T = T;
  a.B = B;
  a.H = H;
  a.reverse = reverse;
  a.phase_ns = phase_ns;
  return launch<kGRU, false>(a, cluster, rows, stream);
}

// K5d: (das, dus [T,B,3H], dh0 [B,H]) from gt, hprev [T,B,H], the gates
// [T,B,3H], un [T,B,H] and whT [3H,H].
extern "C" int tinynn_gru_backward(const float* gt, const float* hprev,
                                   const float* gates, const float* un,
                                   const float* whT, long long ws0,
                                   long long ws1, float* das, float* dus,
                                   float* dh0, int T, int B, int H,
                                   int reverse, int cluster, int rows,
                                   unsigned long long* phase_ns,
                                   void* stream) {
  Args a = {};
  a.in = gt;
  a.a1 = hprev;
  a.a2 = un;
  a.gates = gates;
  a.w = whT;
  a.ws0 = ws0;
  a.ws1 = ws1;
  a.o0 = das;
  a.o1 = dus;
  a.dh0 = dh0;
  a.T = T;
  a.B = B;
  a.H = H;
  a.reverse = reverse;
  a.phase_ns = phase_ns;
  return launch<kGRU, true>(a, cluster, rows, stream);
}

// The most clusters of `cluster` blocks, each on `rows` batch rows, of the
// kernel for (gru, backward) at hidden width H that the card holds at once
// (cudaOccupancyMaxActiveClusters), in *out. The wrapper's plan keeps a
// launch within one such wave.
extern "C" int tinynn_recurrent_max_clusters(int gru, int backward, int H,
                                             int cluster, int rows,
                                             int* out) {
  if (gru)
    return backward ? max_clusters<kGRU, true>(H, cluster, rows, out)
                    : max_clusters<kGRU, false>(H, cluster, rows, out);
  return backward ? max_clusters<kLSTM, true>(H, cluster, rows, out)
                  : max_clusters<kLSTM, false>(H, cluster, rows, out);
}
