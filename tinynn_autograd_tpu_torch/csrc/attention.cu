// Flash attention for Hopper (sm_90a): the forward and the two recompute
// backward kernels of softmax(Q K^T * scale [+ causal/window mask]) V.
//
// Replaces the TPU kernels of tinynn_autograd_tpu/ops/attention.py:
// - attention_forward_kernel: K4, `_fwd_kernel` (:250) and its direct-softmax
//   form `_fwd_kernel_single` (:218), launched by `_fwd_pallas` (:297).
// - attention_backward_dq_kernel and attention_backward_dkv_kernel: K4d,
//   `_dq_kernel` (:650) and `_dkv_kernel` (:690), launched by `_bwd_pallas`
//   (:744); they also compute what K4b (`_bwd_kernel_single`, :390, the
//   whole-plane fused backward) and K4c (`_dq_kernel_band`/`_dkv_kernel_band`,
//   :505/:531, the banded backward) compute: the TPU picks among the four
//   forms by what fits its VMEM, and the VJP is the same.
//
// What it computes, not how: the TPU kernels batch G heads per grid step and
// walk key tiles on a sequential grid axis, carrying the online-softmax
// state in VMEM scratch. Here one block of 256 threads owns one (head,
// 64-row tile) and loops over the tiles of the other axis itself, keeping
// its running state in registers; blocks run in parallel in no order.
// - Every score tile is [64 queries, 64 keys]; thread (ty, tx) of a 16 x 16
//   layout holds its 4 x 4 block in registers and a 4-row x d/16-column
//   block of the [64, d] output tile.
// - Operands sit in shared memory with the contraction index as the row, so
//   a thread reads its 4 values of each operand as one float4: Q, K, V and
//   dO transposed ([d][64]) for the score products, V, K, Q and dO as they
//   are ([64][d]) for the products into the outputs, P and dS written
//   transposed from registers.
// - The online softmax runs in f32 registers; a row's 64 scores live in 16
//   lanes of one warp and meet through shuffles. Masked scores are -inf and
//   their p is 0, so a row that a whole tile hides (a window narrower than a
//   tile) adds nothing, and its running max stays -inf until a visible key
//   arrives.
// - Causal and window tiles that are wholly masked are skipped in the loop
//   bounds (the TPU's `jc` clamp, :319-327); diagonal and edge tiles, and
//   ragged T, are masked element by element.
// - GQA: the block of query head h reads kv head h / (H/Hkv) directly; the
//   dk/dv block of a kv head loops over its group's query heads, so dk and dv
//   are each written once. Dropout hashes with the head index b*Hkv + kvh
//   and the seed seed + (h % group) * 2654435761, as the JAX package's
//   per-group calls do, so the masks agree bit for bit.
// - Each output is written once, with no float atomics: reruns are
//   bit-identical.
// - f32 operands are multiplied in full f32 with FMA on the CUDA cores,
//   never in TF32. Head dims up to 128 (templates for 32, 64 and 128; a
//   smaller d is zero-padded in shared memory).
//
// What bounds it on this card: at the long-context config (B=4, H=8, T=2048,
// d=64, causal) the forward is 17.2 GFLOP on the visible half of the score
// plane against 67 MB of traffic, so f32 FMA (67 TFLOP/s) bounds it, at
// 0.257 ms; the backward pair is 43 GFLOP, 0.641 ms. The backward kernels
// recompute S and dP in both kernels (7 products a tile where the bound
// counts 5). The design does nothing yet about the FMA rate's own limit:
// tensor cores (wgmma, TF32 or bf16, which change the numerics), TMA copies
// overlapped with the products and a persistent schedule are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 64;        // rows and columns of a score tile
constexpr int THREADS = 256;    // 16 x 16 threads
constexpr int PAD = 4;          // keeps rows 16-byte aligned, spreads banks
constexpr int SP = TILE + PAD;  // pitch of the [*][64] buffers
constexpr unsigned GOLDEN = 2654435761u;

struct Shape {
  int b, h, hkv, tq, tk, d;
};
struct Strides {
  long long b, h, t;  // element strides; the head dim has stride 1
};
struct Options {
  float scale;
  int causal, window, dropout;
  unsigned thresh;
  float inv;
  unsigned seed;
};

// The JAX package's `_tile_keep_mask` for one element, in wrapping uint32.
__device__ __forceinline__ bool keep(unsigned hh, unsigned qi, unsigned ki,
                                     const Shape& s, unsigned seed,
                                     unsigned thresh) {
  unsigned x = (hh * static_cast<unsigned>(s.tq) + qi) *
                   static_cast<unsigned>(s.tk) + ki;
  x += seed * GOLDEN;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return x < thresh;
}

__device__ __forceinline__ bool visible(int qi, int ki, const Shape& s,
                                        const Options& o) {
  if (qi >= s.tq || ki >= s.tk) return false;
  if (!o.causal) return true;
  return ki <= qi && (o.window == 0 || qi - ki < o.window);
}

// Rows [r0, r0 + 64) of a [n, d] head slice (row stride st), zero-padded to
// [64, D], transposed into dst[c * SP + r].
template <int D>
__device__ __forceinline__ void load_t(float* dst, const float* src,
                                       long long st, int r0, int n, int d) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    float v = 0.0f;
    if (r0 + r < n && c < d) v = src[(r0 + r) * st + c];
    dst[c * SP + r] = v;
  }
}

// The same rows as they are: dst[r * (D + PAD) + c].
template <int D>
__device__ __forceinline__ void load_r(float* dst, const float* src,
                                       long long st, int r0, int n, int d) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    float v = 0.0f;
    if (r0 + r < n && c < d) v = src[(r0 + r) * st + c];
    dst[r * (D + PAD) + c] = v;
  }
}

// acc[i][j] = sum_c at[c][ty*4+i] * bt[c][tx*4+j] over c < D: a score tile
// from two transposed operands.
template <int D>
__device__ __forceinline__ void tile_nt(float (&acc)[4][4],
                                        const float* __restrict__ at,
                                        const float* __restrict__ bt, int ty,
                                        int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(at + c * SP + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(bt + c * SP + tx * 4);
    const float ar[4] = {a.x, a.y, a.z, a.w};
    const float br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// out[i][j] += sum_k pt[k][ty*4+i] * x[k][tx*NC+j] over k < 64: a [64, D]
// output tile from a transposed score tile and a row-major operand.
template <int D>
__device__ __forceinline__ void tile_nn(float (&out)[4][D / 16],
                                        const float* __restrict__ pt,
                                        const float* __restrict__ x, int ty,
                                        int tx) {
  constexpr int NC = D / 16;
#pragma unroll 4
  for (int k = 0; k < TILE; ++k) {
    const float4 p = *reinterpret_cast<const float4*>(pt + k * SP + ty * 4);
    const float pr[4] = {p.x, p.y, p.z, p.w};
    const float* row = x + k * (D + PAD) + tx * NC;
    float xr[NC];
    if constexpr (NC % 4 == 0) {
#pragma unroll
      for (int q = 0; q < NC / 4; ++q) {
        const float4 t = reinterpret_cast<const float4*>(row)[q];
        xr[4 * q] = t.x;
        xr[4 * q + 1] = t.y;
        xr[4 * q + 2] = t.z;
        xr[4 * q + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < NC / 2; ++q) {
        const float2 t = reinterpret_cast<const float2*>(row)[q];
        xr[2 * q] = t.x;
        xr[2 * q + 1] = t.y;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) out[i][j] = fmaf(pr[i], xr[j], out[i][j]);
  }
}

// The key tiles [lo, hi] that query tile q0 can see.
__device__ __forceinline__ void key_range(int q0, const Shape& s,
                                          const Options& o, int* lo,
                                          int* hi) {
  *lo = 0;
  *hi = (s.tk - 1) / TILE;
  if (o.causal) {
    *hi = min(*hi, (q0 + TILE - 1) / TILE);
    if (o.window) *lo = max(0, q0 - o.window + 1) / TILE;
  }
}

// One block per (b*H + h, query tile); the heaviest causal tiles first.
template <int D>
__global__ void __launch_bounds__(THREADS)
attention_forward_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, Shape s, Strides sq,
                         Strides sk, Strides sv, Options opt) {
  constexpr int NC = D / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][SP]
  float* kt = qt + D * SP;                        // [D][SP]
  float* vs = kt + D * SP;                        // [64][D + PAD]
  float* pt = vs + TILE * (D + PAD);              // [64 keys][SP]

  const int bh = blockIdx.x;
  const int b = bh / s.h, h = bh % s.h;
  const int group = s.h / s.hkv, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TILE;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kh = k + b * sk.b + kvh * sk.h;
  const float* vh = v + b * sv.b + kvh * sv.h;
  const unsigned hh = b * s.hkv + kvh;
  const unsigned seed = opt.seed + static_cast<unsigned>(h % group) * GOLDEN;

  load_t<D>(qt, q + b * sq.b + h * sq.h, sq.t, q0, s.tq, s.d);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  int j_lo, j_hi;
  key_range(q0, s, opt, &j_lo, &j_hi);
  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * TILE;
    __syncthreads();  // the last tile's kt, vs and pt are consumed
    load_t<D>(kt, kh, sk.t, k0, s.tk, s.d);
    load_r<D>(vs, vh, sv.t, k0, s.tk, s.d);
    __syncthreads();
    float sc[4][4];
    tile_nt<D>(sc, qt, kt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mt = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (visible(qi, k0 + tx * 4 + jj, s, opt)) {
          sc[i][jj] *= opt.scale;
          mt = fmaxf(mt, sc[i][jj]);
        } else {
          sc[i][jj] = -INFINITY;
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      const float alpha = (mn == -INFINITY) ? 1.0f : expf(m[i] - mn);
      float rs = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int ki = k0 + tx * 4 + jj;
        const float p = (sc[i][jj] == -INFINITY) ? 0.0f : expf(sc[i][jj] - mn);
        rs += p;
        float pd = p;
        if (opt.dropout)
          pd = keep(hh, qi, ki, s, seed, opt.thresh) ? p * opt.inv : 0.0f;
        pt[(tx * 4 + jj) * SP + ty * 4 + i] = pd;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      m[i] = mn;
    }
    __syncthreads();  // pt complete
    tile_nn<D>(acc, pt, vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= s.tq) continue;
    const long long row = static_cast<long long>(bh) * s.tq + qi;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx * NC + c;
      if (col < s.d) o[row * s.d + col] = acc[i][c] / l[i];
    }
    if (tx == 0) lse[row] = m[i] + logf(l[i]);
  }
}

// dq: one block per (b*H + h, query tile), looping over the visible key
// tiles: S = Q K^T, dP = dO V^T, dS = P (dP - D) scale, dQ += dS K.
template <int D>
__global__ void __launch_bounds__(THREADS)
attention_backward_dq_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, Shape s, Strides sq,
                             Strides sk, Strides sv, Strides sdo,
                             Options opt) {
  constexpr int NC = D / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [D][SP]
  float* dot = qt + D * SP;                       // [D][SP]
  float* kt = dot + D * SP;                       // [D][SP]
  float* vt = kt + D * SP;                        // [D][SP]
  float* ks = vt + D * SP;                        // [64][D + PAD]
  float* dst = ks + TILE * (D + PAD);             // [64 keys][SP]

  const int bh = blockIdx.x;
  const int b = bh / s.h, h = bh % s.h;
  const int group = s.h / s.hkv, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TILE;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kh = k + b * sk.b + kvh * sk.h;
  const float* vh = v + b * sv.b + kvh * sv.h;
  const unsigned hh = b * s.hkv + kvh;
  const unsigned seed = opt.seed + static_cast<unsigned>(h % group) * GOLDEN;

  load_t<D>(qt, q + b * sq.b + h * sq.h, sq.t, q0, s.tq, s.d);
  load_t<D>(dot, dout + b * sdo.b + h * sdo.h, sdo.t, q0, s.tq, s.d);
  float lr[4], dr[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    const long long row = static_cast<long long>(bh) * s.tq + qi;
    lr[i] = qi < s.tq ? lse[row] : 0.0f;
    dr[i] = qi < s.tq ? delta[row] : 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  int j_lo, j_hi;
  key_range(q0, s, opt, &j_lo, &j_hi);
  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * TILE;
    __syncthreads();
    load_t<D>(kt, kh, sk.t, k0, s.tk, s.d);
    load_t<D>(vt, vh, sv.t, k0, s.tk, s.d);
    load_r<D>(ks, kh, sk.t, k0, s.tk, s.d);
    __syncthreads();
    float sc[4][4], dp[4][4];
    tile_nt<D>(sc, qt, kt, ty, tx);
    tile_nt<D>(dp, dot, vt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int ki = k0 + tx * 4 + jj;
        float ds = 0.0f;
        if (visible(qi, ki, s, opt)) {
          const float p = expf(sc[i][jj] * opt.scale - lr[i]);
          float d = dp[i][jj];
          if (opt.dropout)
            d = keep(hh, qi, ki, s, seed, opt.thresh) ? d * opt.inv : 0.0f;
          ds = p * (d - dr[i]) * opt.scale;
        }
        dst[(tx * 4 + jj) * SP + ty * 4 + i] = ds;
      }
    }
    __syncthreads();
    tile_nn<D>(acc, dst, ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= s.tq) continue;
    const long long row = static_cast<long long>(bh) * s.tq + qi;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx * NC + c;
      if (col < s.d) dq[row * s.d + col] = acc[i][c];
    }
  }
}

// dk, dv: one block per (b*Hkv + kvh, key tile), looping over the group's
// query heads and each one's visible query tiles, in the transposed tile
// (keys as rows): S^T = K Q^T, dP^T = V dO^T; dV += P_d^T dO,
// dK += dS^T Q, where P_d is the dropped and rescaled p.
template <int D>
__global__ void __launch_bounds__(THREADS)
attention_backward_dkv_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              Shape s, Strides sq, Strides sk, Strides sv,
                              Strides sdo, Options opt) {
  constexpr int NC = D / 16;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [D][SP]
  float* vt = kt + D * SP;                        // [D][SP]
  float* qt = vt + D * SP;                        // [D][SP]
  float* dot = qt + D * SP;                       // [D][SP]
  float* qs = dot + D * SP;                       // [64][D + PAD]
  float* dos = qs + TILE * (D + PAD);             // [64][D + PAD]
  // [64 queries][SP]: overlays qt and dot (2 * D * SP >= 64 * SP for
  // D >= 32), which are consumed before it is written; at d=64 that keeps
  // the block at 104 KB, so that two fit on an SM
  float* buf = qt;

  const int bkv = blockIdx.x;
  const int b = bkv / s.hkv, kvh = bkv % s.hkv;
  const int group = s.h / s.hkv;
  const int k0 = blockIdx.y * TILE;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const unsigned hh = bkv;

  load_t<D>(kt, k + b * sk.b + kvh * sk.h, sk.t, k0, s.tk, s.d);
  load_t<D>(vt, v + b * sv.b + kvh * sv.h, sv.t, k0, s.tk, s.d);

  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[i][c] = adv[i][c] = 0.0f;

  // the query tiles that see this key tile
  const int nq = (s.tq + TILE - 1) / TILE;
  int i_lo = 0, i_hi = nq - 1;
  if (opt.causal) {
    i_lo = k0 / TILE;
    if (opt.window) i_hi = min(i_hi, (k0 + TILE - 1 + opt.window - 1) / TILE);
  }
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const unsigned seed = opt.seed + static_cast<unsigned>(gi) * GOLDEN;
    const float* qh = q + b * sq.b + h * sq.h;
    const float* doh = dout + b * sdo.b + h * sdo.h;
    const long long head_row = (static_cast<long long>(b) * s.h + h) * s.tq;
    for (int it = i_lo; it <= i_hi; ++it) {
      const int q0 = it * TILE;
      __syncthreads();
      load_t<D>(qt, qh, sq.t, q0, s.tq, s.d);
      load_t<D>(dot, doh, sdo.t, q0, s.tq, s.d);
      load_r<D>(qs, qh, sq.t, q0, s.tq, s.d);
      load_r<D>(dos, doh, sdo.t, q0, s.tq, s.d);
      float lc[4], dc[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qi = q0 + tx * 4 + jj;
        lc[jj] = qi < s.tq ? lse[head_row + qi] : 0.0f;
        dc[jj] = qi < s.tq ? delta[head_row + qi] : 0.0f;
      }
      __syncthreads();
      float st[4][4], dpt[4][4];
      tile_nt<D>(st, kt, qt, ty, tx);
      tile_nt<D>(dpt, vt, dot, ty, tx);
      __syncthreads();  // qt and dot consumed: buf overlays them
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ki = k0 + ty * 4 + i;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int qi = q0 + tx * 4 + jj;
          float pd = 0.0f, ds = 0.0f;
          if (visible(qi, ki, s, opt)) {
            const float p = expf(st[i][jj] * opt.scale - lc[jj]);
            float d = dpt[i][jj];
            pd = p;
            if (opt.dropout) {
              const bool kp = keep(hh, qi, ki, s, seed, opt.thresh);
              pd = kp ? p * opt.inv : 0.0f;
              d = kp ? d * opt.inv : 0.0f;
            }
            ds = p * (d - dc[jj]) * opt.scale;
          }
          buf[(tx * 4 + jj) * SP + ty * 4 + i] = pd;
          st[i][jj] = ds;  // kept for the dK product
        }
      }
      __syncthreads();
      tile_nn<D>(adv, buf, dos, ty, tx);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          buf[(tx * 4 + jj) * SP + ty * 4 + i] = st[i][jj];
      __syncthreads();
      tile_nn<D>(adk, buf, qs, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + ty * 4 + i;
    if (ki >= s.tk) continue;
    const long long row = static_cast<long long>(bkv) * s.tk + ki;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx * NC + c;
      if (col < s.d) {
        dk[row * s.d + col] = adk[i][c];
        dv[row * s.d + col] = adv[i][c];
      }
    }
  }
}

template <int D>
constexpr size_t forward_smem() {
  return sizeof(float) * (2 * D * SP + TILE * (D + PAD) + TILE * SP);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * D * SP + TILE * (D + PAD) + TILE * SP);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * D * SP + 2 * TILE * (D + PAD));
}

// Raises a kernel's dynamic shared-memory limit to what it uses (above the
// default 48 KB), once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

template <int D>
cudaError_t launch_forward(const float* q, const float* k, const float* v,
                           float* o, float* lse, const Shape& s,
                           const Strides& sq, const Strides& sk,
                           const Strides& sv, const Options& opt,
                           cudaStream_t stream) {
  static bool done = false;
  const size_t bytes = forward_smem<D>();
  cudaError_t err = allow_smem(attention_forward_kernel<D>, bytes, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.h, (s.tq + TILE - 1) / TILE);
  attention_forward_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, k, v, o, lse, s, sq, sk, sv, opt);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* delta,
                      float* dq, const Shape& s, const Strides& sq,
                      const Strides& sk, const Strides& sv,
                      const Strides& sdo, const Options& opt,
                      cudaStream_t stream) {
  static bool done = false;
  const size_t bytes = dq_smem<D>();
  cudaError_t err = allow_smem(attention_backward_dq_kernel<D>, bytes, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.h, (s.tq + TILE - 1) / TILE);
  attention_backward_dq_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, k, v, dout, lse, delta, dq, s, sq, sk, sv, sdo, opt);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, float* dk, float* dv,
                       const Shape& s, const Strides& sq, const Strides& sk,
                       const Strides& sv, const Strides& sdo,
                       const Options& opt, cudaStream_t stream) {
  static bool done = false;
  const size_t bytes = dkv_smem<D>();
  cudaError_t err =
      allow_smem(attention_backward_dkv_kernel<D>, bytes, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.hkv, (s.tk + TILE - 1) / TILE);
  attention_backward_dkv_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, s, sq, sk, sv, sdo, opt);
  return cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and does not synchronise. q is
// [b, h, tq, d], k and v [b, hkv, tk, d], dout like q, each given by its
// (batch, head, row) element strides with a unit-stride head dim; o, dq
// [b, h, tq, d], dk, dv [b, hkv, tk, d], lse and delta [b, h, tq] are
// contiguous. window 0 means none; dropout 0 means none. Returns the CUDA
// error of the launch (0 when it was accepted); a head dim above 128 is
// cudaErrorInvalidValue.

extern "C" int tinynn_attention_forward(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int h, int hkv, int tq, int tk, int d, long long sqb, long long sqh,
    long long sqt, long long skb, long long skh, long long skt,
    long long svb, long long svh, long long svt, float scale, int causal,
    int window, int dropout, unsigned thresh, float inv, unsigned seed,
    void* stream) {
  const Shape s{b, h, hkv, tq, tk, d};
  const Strides sq{sqb, sqh, sqt}, sk{skb, skh, skt}, sv{svb, svh, svt};
  const Options opt{scale, causal, window, dropout, thresh, inv, seed};
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 32)
    err = launch_forward<32>(qf, kf, vf, of, lf, s, sq, sk, sv, opt, st);
  else if (d <= 64)
    err = launch_forward<64>(qf, kf, vf, of, lf, s, sq, sk, sv, opt, st);
  else if (d <= 128)
    err = launch_forward<128>(qf, kf, vf, of, lf, s, sq, sk, sv, opt, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int tinynn_attention_backward_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int h, int hkv,
    int tq, int tk, int d, long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt, long long svb,
    long long svh, long long svt, long long sdb, long long sdh,
    long long sdt, float scale, int causal, int window, int dropout,
    unsigned thresh, float inv, unsigned seed, void* stream) {
  const Shape s{b, h, hkv, tq, tk, d};
  const Strides sq{sqb, sqh, sqt}, sk{skb, skh, skt}, sv{svb, svh, svt},
      sdo{sdb, sdh, sdt};
  const Options opt{scale, causal, window, dropout, thresh, inv, seed};
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* df = static_cast<const float*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  const auto* ef = static_cast<const float*>(delta);
  auto* gf = static_cast<float*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 32)
    err = launch_dq<32>(qf, kf, vf, df, lf, ef, gf, s, sq, sk, sv, sdo, opt,
                        st);
  else if (d <= 64)
    err = launch_dq<64>(qf, kf, vf, df, lf, ef, gf, s, sq, sk, sv, sdo, opt,
                        st);
  else if (d <= 128)
    err = launch_dq<128>(qf, kf, vf, df, lf, ef, gf, s, sq, sk, sv, sdo, opt,
                         st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int tinynn_attention_backward_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int h,
    int hkv, int tq, int tk, int d, long long sqb, long long sqh,
    long long sqt, long long skb, long long skh, long long skt,
    long long svb, long long svh, long long svt, long long sdb,
    long long sdh, long long sdt, float scale, int causal, int window,
    int dropout, unsigned thresh, float inv, unsigned seed, void* stream) {
  const Shape s{b, h, hkv, tq, tk, d};
  const Strides sq{sqb, sqh, sqt}, sk{skb, skh, skt}, sv{svb, svh, svt},
      sdo{sdb, sdh, sdt};
  const Options opt{scale, causal, window, dropout, thresh, inv, seed};
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* df = static_cast<const float*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  const auto* ef = static_cast<const float*>(delta);
  auto* kg = static_cast<float*>(dk);
  auto* vg = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 32)
    err = launch_dkv<32>(qf, kf, vf, df, lf, ef, kg, vg, s, sq, sk, sv, sdo,
                         opt, st);
  else if (d <= 64)
    err = launch_dkv<64>(qf, kf, vf, df, lf, ef, kg, vg, s, sq, sk, sv, sdo,
                         opt, st);
  else if (d <= 128)
    err = launch_dkv<128>(qf, kf, vf, df, lf, ef, kg, vg, s, sq, sk, sv, sdo,
                          opt, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
