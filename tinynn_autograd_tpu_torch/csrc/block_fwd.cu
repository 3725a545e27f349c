// The fused pre-LN transformer-block forward for Hopper (sm_90a), K7: one
// launch computes a whole TransformerBlock's forward for x [B, T, D] f32.
//
// Replaces the TPU kernel `_block_fwd_kernel`
// (tinynn_autograd_tpu/ops/block_kernel.py:51), launched by
// `block_fwd_pallas` (:83). There each grid step holds `batch_block` batch
// rows and every weight in VMEM, and computes the whole block for its rows.
// Here the weights do not fit an SM (3.1 MB at D 256, 12.6 MB at D 512,
// against 227 KB of shared memory) and blocks run in parallel in no order.
// So ONE cooperative launch of as many blocks as fit on the card at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, never two waves)
// walks seven phases, separated by grid barriers:
//   (a) xn = LN(x; g1, be1)                              a warp a row
//   (b) q, k, v = xn @ wq, xn @ wk, xn @ wv              64x64 output tiles
//   (c) ctx = softmax(q_h k_h^T / sqrt(hd) [causal]) v_h a (batch, head,
//       64-query tile) task, online softmax over 64-key tiles, so T = 2048
//       needs no [T, T] plane; causal key tiles past the diagonal skipped
//   (d) x2 = x + ctx @ wo, written into out
//   (e) yn = LN(x2; g2, be2)
//   (f) hbuf = gelu_tanh(yn @ w1 + b1)
//   (g) out = x2 + hbuf @ w2 + b2, in place: each element is read and
//       written by the one thread that owns it
// The intermediates (xn, q, k, v, ctx, yn [B*T, D], hbuf [B*T, hidden];
// 42 MB at config 6) live in a scratch the caller allocates, and are read
// back through the 50 MB L2, which plays VMEM's part. Whatever the launch
// wrote itself is read with volatile ld.global.cg (a plain __ldcg may be
// merged across a grid barrier); x and the weights with read-only loads.
//
// It computes what `_block_fwd_kernel` computes, not how:
// - Every product runs in full f32 FMA on the CUDA cores, never TF32. A
//   thread of the 16x16 layout owns a 4x4 block of a 64x64 output tile and
//   runs its K loop in a fixed order; operand stages 16 deep sit in shared
//   memory, double-buffered, the next one fetched into registers while the
//   current one is consumed. No float atomics: reruns are bit-identical,
//   whatever the grid size.
// - LayerNorm as `_ln` (:45): the mean, then the mean of the squared
//   deviations, then rsqrt(var + eps); tanh-approximate GELU (:78).
// - Masked scores are -inf and their p is 0 (the TPU kernel's -1e30 gives
//   the same p = 0: every causal row sees key 0); the softmax is online, its
//   sum divided out at the end. Head dims up to 128 (templates for 32, 64
//   and 128; a smaller head dim is zero-padded in shared memory), D and the
//   MLP width multiples of 4 (16-byte loads).
//
// What bounds it on this card: f32 FMA. Config 6's block (B 32, T 128, D
// 256) is 6.98 GFLOP (6.71 causal) against 11.5 MB of x, out and weights:
// 104 us at 67 TFLOP/s against 3.4 us at 3.35 TB/s; 6b's block (B 4, T
// 2048, D 512, causal) 68.7 GFLOP, 1.03 ms. What the design does about it:
// nothing beyond the plain tile loop above (4x4 register tiles from
// shared-memory float4s, every SM busy in every phase); tensor cores
// (wgmma in TF32 or bf16, which change the numerics), TMA and larger tiles
// are later work. Six grid barriers (~1.4 us each) are its fixed cost.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;    // 16 x 16 threads
constexpr int TILE = 64;        // output tiles, query and key tiles
constexpr int BK = 16;          // depth of one product stage
constexpr int PAD = 4;          // keeps rows 16-byte aligned, spreads banks
constexpr int SP = TILE + PAD;  // pitch of the [*][64] buffers

struct Args {
  const float *x, *wq, *wk, *wv, *wo, *w1, *b1, *w2, *b2, *g1, *be1, *g2,
      *be2;
  float* out;
  float *xn, *q, *k, *v, *ctx, *yn, *hbuf;  // scratch
  int b, t, d, hidden, heads, hd, causal;
  float eps, scale;
  unsigned long long* phase_ns;  // null, or [PHASES] (see the kernel)
};

constexpr int PHASES = 7;  // (a) to (g)

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Loads of data written inside the launch: through L2, never a stale L1
// line (see csrc/fused_epoch.cu).
__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_cg4(const float* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// dst = LN(src) row by row, a warp a row.
__device__ void layer_norm_rows(const float* src, const float* __restrict__ g,
                                const float* __restrict__ be, float* dst,
                                int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * (THREADS / 32);
  for (int r = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5); r < rows;
       r += n_warps) {
    const float* row = src + static_cast<long long>(r) * d;
    float s = 0.0f;
    for (int c = lane; c < d; c += 32) s += ld_cg(row + c);
    const float mu = warp_sum(s) / d;
    float ss = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float dv = ld_cg(row + c) - mu;
      ss = fmaf(dv, dv, ss);
    }
    const float rstd = rsqrtf(warp_sum(ss) / d + eps);
    float* o = dst + static_cast<long long>(r) * d;
    for (int c = lane; c < d; c += 32)
      o[c] = (ld_cg(row + c) - mu) * rstd * __ldg(g + c) + __ldg(be + c);
  }
}

// One product of a phase: c = epilogue(a @ w), a [m, k] written in this
// launch, w [k, n] a weight; the epilogue is v = acc, then res + v where
// res is given, then v + bias where bias is given, then gelu_tanh(v) where
// gelu is set: the plain version's order of operations.
struct Product {
  const float* a;
  const float* w;
  const float* res;   // [m, n] or null (read with ld_cg: it may be c)
  const float* bias;  // [n] or null
  float* c;
  int m, n, k, gelu;
};

// The 64x64 output tile (row0, col0) of p. smem holds two stages of each
// operand, k-major: As[2][BK][SP], Bs[2][BK][SP].
__device__ void product_tile(const Product& p, int row0, int col0,
                             float* smem) {
  float* As = smem;
  float* Bs = smem + 2 * BK * SP;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // loader: A's 64 rows x 16 k and W's 16 k x 64 columns as one float4 each
  const int ar = tid >> 2, ak = (tid & 3) * 4;
  const int wk = tid >> 4, wc = (tid & 15) * 4;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 ra, rw;
  auto fetch = [&](int k0) {
    const int gr = row0 + ar, gk = k0 + ak;
    ra = (gr < p.m && gk < p.k)
             ? ld_cg4(p.a + static_cast<long long>(gr) * p.k + gk)
             : zero;
    const int gw = k0 + wk, gc = col0 + wc;
    rw = (gw < p.k && gc < p.n)
             ? __ldg(reinterpret_cast<const float4*>(
                   p.w + static_cast<long long>(gw) * p.n + gc))
             : zero;
  };
  auto stash = [&](int buf) {
    float* as = As + buf * BK * SP;
    as[(ak + 0) * SP + ar] = ra.x;
    as[(ak + 1) * SP + ar] = ra.y;
    as[(ak + 2) * SP + ar] = ra.z;
    as[(ak + 3) * SP + ar] = ra.w;
    *reinterpret_cast<float4*>(Bs + buf * BK * SP + wk * SP + wc) = rw;
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int n_stages = (p.k + BK - 1) / BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_stages) fetch((s + 1) * BK);
    const float* as = As + buf * BK * SP;
    const float* bs = Bs + buf * BK * SP;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(as + kk * SP + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(bs + kk * SP + tx * 4);
      const float ar4[4] = {av.x, av.y, av.z, av.w};
      const float br4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar4[i], br4[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (s + 1 < n_stages) stash(buf ^ 1);
    __syncthreads();
  }

  const int gc = col0 + tx * 4;
  if (gc >= p.n) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= p.m) continue;
    const long long o = static_cast<long long>(gr) * p.n + gc;
    float v[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
    if (p.res) {
      const float4 r = ld_cg4(p.res + o);
      v[0] = r.x + v[0];
      v[1] = r.y + v[1];
      v[2] = r.z + v[2];
      v[3] = r.w + v[3];
    }
    if (p.bias) {
      const float4 bb = __ldg(reinterpret_cast<const float4*>(p.bias + gc));
      v[0] += bb.x;
      v[1] += bb.y;
      v[2] += bb.z;
      v[3] += bb.w;
    }
    if (p.gelu) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = gelu_tanh(v[j]);
    }
    *reinterpret_cast<float4*>(p.c + o) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// A phase of n_products products of one shape, their tiles spread over the
// grid (a row of tiles to neighbouring blocks, which share A's rows in L2).
__device__ void products(const Product* ps, int n_products, float* smem) {
  const int tiles_n = (ps[0].n + TILE - 1) / TILE;
  const int tiles = ((ps[0].m + TILE - 1) / TILE) * tiles_n;
  for (int task = blockIdx.x; task < n_products * tiles; task += gridDim.x) {
    const int which = task / tiles, tile = task % tiles;
    product_tile(ps[which], (tile / tiles_n) * TILE, (tile % tiles_n) * TILE,
                 smem);
  }
}

// Rows [r0, r0 + 64) of a head's [t, hd] slice (row stride st), zero-padded
// to [64, HD], transposed into dst[c * SP + r].
template <int HD>
__device__ __forceinline__ void load_t(float* dst, const float* src,
                                       long long st, int r0, int n, int hd) {
  for (int idx = threadIdx.x; idx < TILE * HD; idx += THREADS) {
    const int r = idx / HD, c = idx % HD;
    float v = 0.0f;
    if (r0 + r < n && c < hd) v = ld_cg(src + (r0 + r) * st + c);
    dst[c * SP + r] = v;
  }
}

// The same rows as they are: dst[r * (HD + PAD) + c].
template <int HD>
__device__ __forceinline__ void load_r(float* dst, const float* src,
                                       long long st, int r0, int n, int hd) {
  for (int idx = threadIdx.x; idx < TILE * HD; idx += THREADS) {
    const int r = idx / HD, c = idx % HD;
    float v = 0.0f;
    if (r0 + r < n && c < hd) v = ld_cg(src + (r0 + r) * st + c);
    dst[r * (HD + PAD) + c] = v;
  }
}

// Phase (c): ctx for one (batch, head, query tile) task after another; the
// heaviest causal tiles first.
template <int HD>
__device__ void attention(const Args& a, float* smem) {
  constexpr int NC = HD / 16;
  float* qt = smem;                // [HD][SP]
  float* kt = qt + HD * SP;        // [HD][SP]
  float* vs = kt + HD * SP;        // [64][HD + PAD]
  float* pt = vs + TILE * (HD + PAD);  // [64 keys][SP]
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n_q = (a.t + TILE - 1) / TILE;
  const int n_bh = a.b * a.heads;
  const long long st = a.d;
  for (int task = blockIdx.x; task < n_bh * n_q; task += gridDim.x) {
    const int bh = task % n_bh;
    const int q0 = (n_q - 1 - task / n_bh) * TILE;
    const long long base =
        static_cast<long long>(bh / a.heads) * a.t * a.d +
        static_cast<long long>(bh % a.heads) * a.hd;
    __syncthreads();  // the last task's buffers are consumed
    load_t<HD>(qt, a.q + base, st, q0, a.t, a.hd);

    float m[4], l[4], acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
    }
    const int j_hi =
        a.causal ? min(n_q - 1, q0 / TILE) : (a.t - 1) / TILE;
    for (int j = 0; j <= j_hi; ++j) {
      const int k0 = j * TILE;
      __syncthreads();  // the last key tile's kt, vs and pt are consumed
      load_t<HD>(kt, a.k + base, st, k0, a.t, a.hd);
      load_r<HD>(vs, a.v + base, st, k0, a.t, a.hd);
      __syncthreads();
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.0f;
#pragma unroll 8
      for (int c = 0; c < HD; ++c) {
        const float4 qa =
            *reinterpret_cast<const float4*>(qt + c * SP + ty * 4);
        const float4 kb =
            *reinterpret_cast<const float4*>(kt + c * SP + tx * 4);
        const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
        const float kr[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            sc[i][jj] = fmaf(qr[i], kr[jj], sc[i][jj]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty * 4 + i;
        float mt = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int ki = k0 + tx * 4 + jj;
          if (qi < a.t && ki < a.t && (!a.causal || ki <= qi)) {
            sc[i][jj] *= a.scale;
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
          const float p =
              (sc[i][jj] == -INFINITY) ? 0.0f : expf(sc[i][jj] - mn);
          rs += p;
          pt[(tx * 4 + jj) * SP + ty * 4 + i] = p;
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
#pragma unroll 4
      for (int kk = 0; kk < TILE; ++kk) {
        const float4 pv =
            *reinterpret_cast<const float4*>(pt + kk * SP + ty * 4);
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
        const float* row = vs + kk * (HD + PAD) + tx * NC;
        float vr[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) vr[c] = row[c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc[i][c] = fmaf(pr[i], vr[c], acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      if (qi >= a.t) continue;
      float* o = a.ctx + base + static_cast<long long>(qi) * a.d;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx * NC + c;
        if (col < a.hd) o[col] = acc[i][c] / l[i];
      }
    }
  }
}

// The dynamic shared memory of a block: the attention phase's buffers, or
// the products' two stages of each operand, whichever is larger.
template <int HD>
constexpr int smem_floats() {
  constexpr int attn = 2 * HD * SP + TILE * (HD + PAD) + TILE * SP;
  return attn > 4 * BK * SP ? attn : 4 * BK * SP;
}

// Where `phase_ns` is not null, block 0's thread 0 adds the time of each
// phase (globaltimer, ns) into phase_ns[p]: from the barrier that ended the
// phase before (the launch's start for (a)) to the barrier that ends this
// one; (g) gets a barrier of its own only then.
template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 2 : 1)
block_fwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int rows = a.b * a.t;
  const bool timed = a.phase_ns && blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long last = timed ? globaltimer() : 0;
  auto end_phase = [&](int phase) {
    grid.sync();
    if (timed) {
      const unsigned long long now = globaltimer();
      a.phase_ns[phase] += now - last;
      last = now;
    }
  };

  layer_norm_rows(a.x, a.g1, a.be1, a.xn, rows, a.d, a.eps);  // (a)
  end_phase(0);
  {
    const Product qkv[3] = {
        {a.xn, a.wq, nullptr, nullptr, a.q, rows, a.d, a.d, 0},
        {a.xn, a.wk, nullptr, nullptr, a.k, rows, a.d, a.d, 0},
        {a.xn, a.wv, nullptr, nullptr, a.v, rows, a.d, a.d, 0}};
    products(qkv, 3, smem);  // (b)
  }
  end_phase(1);
  attention<HD>(a, smem);  // (c)
  end_phase(2);
  {
    const Product o = {a.ctx, a.wo, a.x, nullptr, a.out, rows, a.d, a.d, 0};
    products(&o, 1, smem);  // (d): x2 into out
  }
  end_phase(3);
  layer_norm_rows(a.out, a.g2, a.be2, a.yn, rows, a.d, a.eps);  // (e)
  end_phase(4);
  {
    const Product up = {a.yn, a.w1, nullptr, a.b1, a.hbuf, rows, a.hidden,
                        a.d, 1};
    products(&up, 1, smem);  // (f)
  }
  end_phase(5);
  {
    const Product down = {a.hbuf, a.w2, a.out, a.b2, a.out, rows, a.d,
                          a.hidden, 0};
    products(&down, 1, smem);  // (g)
  }
  if (a.phase_ns) end_phase(6);
}

template <int HD>
cudaError_t grid_of(int* blocks_per_sm, int* sms, int* smem_bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *smem_bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(block_fwd_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, block_fwd_kernel<HD>, THREADS, *smem_bytes);
}

template <int HD>
cudaError_t launch(Args& a, cudaStream_t stream) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  int per_sm = 0, sms = 0, smem = 0;
  err = grid_of<HD>(&per_sm, &sms, &smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(block_fwd_kernel<HD>),
      dim3(per_sm * sms), dim3(THREADS), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The grid a launch at head dim `hd` uses: co-resident blocks per SM, the
// SM count and the dynamic shared memory of a block.
extern "C" int tinynn_block_fwd_grid(int hd, int* blocks_per_sm, int* sms,
                                     int* smem_bytes) {
  cudaError_t err;
  if (hd >= 1 && hd <= 32)
    err = grid_of<32>(blocks_per_sm, sms, smem_bytes);
  else if (hd > 32 && hd <= 64)
    err = grid_of<64>(blocks_per_sm, sms, smem_bytes);
  else if (hd > 64 && hd <= 128)
    err = grid_of<128>(blocks_per_sm, sms, smem_bytes);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// One block forward: x [b, t, d] -> out [b, t, d], all contiguous f32 on
// one device. `weights` holds the 12 device pointers wq, wk, wv, wo [d, d],
// w1 [d, hidden], b1 [hidden], w2 [hidden, d], b2, g1, be1, g2, be2 [d] (the
// order of PARAM_NAMES in ops/block_kernel.py); `scratch` 6 b t d + b t
// hidden floats. d % heads == 0, d / heads <= 128, d and hidden multiples of
// 4. `phase_ns`, where not null, accumulates each phase's time (see the
// kernel). Launches on `stream` and does not synchronise. Returns the CUDA
// error of the launch (0 when it was accepted): cudaErrorInvalidValue for a
// shape it does not take, cudaErrorNotSupported when the device cannot
// launch cooperatively.
extern "C" int tinynn_block_fwd(const void* x, void* const* weights,
                                void* out, void* scratch, int b, int t, int d,
                                int hidden, int heads, int causal, float eps,
                                float scale, unsigned long long* phase_ns,
                                void* stream) {
  if (b < 1 || t < 1 || d < 1 || hidden < 1 || heads < 1 || d % heads ||
      d % 4 || hidden % 4 || d / heads > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  Args a;
  a.x = static_cast<const float*>(x);
  a.wq = w[0];
  a.wk = w[1];
  a.wv = w[2];
  a.wo = w[3];
  a.w1 = w[4];
  a.b1 = w[5];
  a.w2 = w[6];
  a.b2 = w[7];
  a.g1 = w[8];
  a.be1 = w[9];
  a.g2 = w[10];
  a.be2 = w[11];
  a.out = static_cast<float*>(out);
  const long long rd = static_cast<long long>(b) * t * d;
  float* s = static_cast<float*>(scratch);
  a.xn = s;
  a.q = s + rd;
  a.k = s + 2 * rd;
  a.v = s + 3 * rd;
  a.ctx = s + 4 * rd;
  a.yn = s + 5 * rd;
  a.hbuf = s + 6 * rd;
  a.b = b;
  a.t = t;
  a.d = d;
  a.hidden = hidden;
  a.heads = heads;
  a.hd = d / heads;
  a.causal = causal;
  a.eps = eps;
  a.scale = scale;
  a.phase_ns = phase_ns;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a.hd <= 32)
    err = launch<32>(a, st);
  else if (a.hd <= 64)
    err = launch<64>(a, st);
  else
    err = launch<128>(a, st);
  return static_cast<int>(err);
}
