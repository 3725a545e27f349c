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
// state in VMEM scratch. Here one block owns one (head, 64-row tile) and
// loops over the tiles of the other axis itself, keeping its running state
// in registers; blocks run in parallel in no order.
// - Causal and window tiles that are wholly masked are skipped in the loop
//   bounds (the TPU's `jc` clamp, :319-327); diagonal and edge tiles, and
//   ragged T, are masked element by element. Masked scores are -inf and
//   their p is 0.
// - GQA: the block of query head h reads kv head h / (H/Hkv) directly; the
//   dk/dv block of a kv head loops over its group's query heads, so dk and dv
//   are each written once. Dropout hashes with the head index b*Hkv + kvh
//   and the seed seed + (h % group) * 2654435761, as the JAX package's
//   per-group calls do, so the masks agree bit for bit.
// - Each output is written once, with no float atomics: reruns are
//   bit-identical. Head dims up to 128 (templates for 32, 64 and 128; a
//   smaller d is zero-padded in shared memory).
//
// All three kernels multiply on the tensor cores, `mma.sync` m16n8k8 TF32
// with f32 accumulators, in 3xTF32: each f32 operand is split into a TF32
// high part (rounded to nearest, ties away) and a TF32 low part (the
// remainder cut towards zero), and lo hi' + hi lo' + hi hi' are issued, as
// CUTLASS's OpMultiplyAddFastF32 does (and as PyTorch's f32 SDPA does on
// this card). `ops/tf32.py` is the same split on the CPU, bit for bit. The
// tensor cores' accumulation cuts towards zero, so long sums are kept short:
// the score products sum their small terms apart, and each looped tile's
// share of an output is summed apart and added to it once (an f32 add
// rounded to nearest). Against a float64 plain version the kernels' error
// then stays within that of the f32 plain version (cuBLAS, TF32 off) at the
// long-context shapes, where one running sum missed it by up to 13x.
//
// The forward: a block is 4 warps and 64 query rows; each warp owns 16 rows
// with their running max and sum. Q is loaded once, K and V come in 32-key
// tiles by cp.async, double-buffered. S = Q K^T lands in m16n8
// accumulators, the online softmax (masks, scale, dropout) runs on them in
// f32 registers, a row's max and sum meeting over the 4 lanes of its quad
// in two shuffles, and the accumulators feed P.V as its A fragments, so P
// never leaves the registers; each tile's share of O is summed apart and
// added once to the rescaled O (o = o alpha + share). Q and K fragments
// come by ldmatrix, and every warp splits the K and V values it reads in
// registers: faster on the H100 than splitting each tile once a block into
// shared high and low planes, than 128-row blocks of 8 warps (level at
// config 6b, slower at T=512, where their grid is under one wave) and than
// warps owning 32 rows (out of registers).
//
// The backward pair, dq (over query tiles) and dk/dv (over key tiles):
// - Every product (S and dP in both kernels, dQ = dS K, dV = P_d^T dO,
//   dK = dS^T Q) runs in 3xTF32 as above.
// - A block is 4 warps; each warp owns 16 rows of the block's 64 (query rows
//   in dq, key rows in dk/dv), with their lse and delta, P and dS in its
//   registers. An m16n8 accumulator's columns 2t and 2t + 1 serve as the
//   next product's A fragment columns t and t + 4 once the B operand's rows
//   are read in that order, so P and dS never leave the registers.
// - The resident operands (Q and dO in dq, K and V in dk/dv) are loaded once;
//   the looped ones (K and V; Q, dO, lse and delta) come in 32-row tiles by
//   cp.async (16-byte copies where rows are 16-byte aligned, else 4-byte),
//   double-buffered so that tile j + 1 lands while tile j is multiplied. One
//   copy of each serves both its fragment reads: at a pitch of d + 4 floats
//   (4 mod 32 words) the row-major reads and the permuted-row reads are both
//   free of bank conflicts.
// - Softmax, the masks, the dropout hash and ds = p (dp - D) scale run in
//   f32 registers.
//
// What bounds them on this card: at the long-context config (B=4, H=8,
// T=2048, d=64, causal) the forward is 17.2 GFLOP on the visible half of the
// score plane against 67 MB of traffic, 51.6 GFLOP of TF32 in 3xTF32 at the
// tensor cores' 494.7 TFLOP/s: 0.104 ms (0.257 ms at f32 FMA, 67 TFLOP/s).
// The backward pair does 7 products a tile (both kernels recompute S and
// dP), 60 GFLOP, three TF32 products each: 180 GFLOP, 0.364 ms. The kernels
// issue their MMAs with the operand splits, the softmax, the elementwise
// work and the fragment loads beside them on the same schedulers (the
// forward splits each K and V value once in each of its four warps); a
// fused backward that computes S and dP once (without float atomics),
// `wgmma` with K-major operands and TMA copies are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

using tinynn::split_tf32;

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

// The C-key tiles [lo, hi] that the R query rows from q0 can see.
template <int R, int C>
__device__ __forceinline__ void key_range(int q0, const Shape& s,
                                          const Options& o, int* lo,
                                          int* hi) {
  *lo = 0;
  *hi = (s.tk - 1) / C;
  if (o.causal) {
    *hi = min(*hi, (q0 + R - 1) / C);
    if (o.window) *lo = max(0, q0 - o.window + 1) / C;
  }
}

// ---------------------------------------------------------------------------
// The three kernels' common parts: 3xTF32 products on the tensor cores
// (mma.sync m16n8k8), warps that own 16 rows each, cp.async-pipelined
// looped tiles.
// ---------------------------------------------------------------------------

constexpr int BM = 64;       // rows a block owns: 4 warps x 16
constexpr int BN = 32;       // rows of a looped tile
constexpr int THREADS = 128;

// The shared-memory pitch of a [rows][D] operand: D + 4 floats, 4 mod 32
// words for D = 32, 64 and 128, so that every fragment read below is free
// of bank conflicts: a row-major read (row g, column t) hits bank 4g + t,
// and a permuted-row read (row 2t or 2t + 1, column g) bank 8t + g (+ 4).
// Rows stay 16-byte aligned for the cp.async copies.
template <int D>
__host__ __device__ constexpr int pitch() {
  return D + 4;
}

// c += a b on one m16n8k8 tile: TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One A fragment split into its TF32 high and low parts.
struct FragA {
  unsigned hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2,
                                      float x3) {
    split_tf32(x0, hi[0], lo[0]);
    split_tf32(x1, hi[1], lo[1]);
    split_tf32(x2, hi[2], lo[2]);
    split_tf32(x3, hi[3], lo[3]);
  }
};

// A B fragment, already split: b0 and b1 at offsets o0 and o1 of a tile's
// high and low planes.
struct FragB {
  unsigned h0, h1, l0, l1;
};
__device__ __forceinline__ FragB frag_b(const float* hi, const float* lo,
                                        int o0, int o1) {
  return {__float_as_uint(hi[o0]), __float_as_uint(hi[o1]),
          __float_as_uint(lo[o0]), __float_as_uint(lo[o1])};
}
// A B fragment split in registers: b0 and b1 at offsets o0 and o1 of a
// tile of f32 values.
__device__ __forceinline__ FragB split_b(const float* x, int o0, int o1) {
  FragB b;
  split_tf32(x[o0], b.h0, b.l0);
  split_tf32(x[o1], b.h1, b.l1);
  return b;
}

// c += a b in 3xTF32 (CUTLASS's OpMultiplyAddFastF32 scheme): the two
// small cross terms first, then hi hi'; the lo lo' term (~2^-22 of the
// product) is dropped.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.lo, b.h0, b.h1);
  mma_tf32(c, a.hi, b.l0, b.l1);
  mma_tf32(c, a.hi, b.h0, b.h1);
}

// The same with the small terms summed in their own accumulator `cs`: the
// tensor cores' accumulation cuts towards zero, and over the head dim's 8
// steps three cuts a step into one sum would cost it several units in the
// last place.
__device__ __forceinline__ void mma3s(float (&c)[4], float (&cs)[4],
                                      const FragA& a, const FragB& b) {
  mma_tf32(cs, a.lo, b.h0, b.h1);
  mma_tf32(cs, a.hi, b.l0, b.l1);
  mma_tf32(c, a.hi, b.h0, b.h1);
}

// The A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 8) of a
// row-major [*][pitch] operand: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4).
template <int P>
__device__ __forceinline__ void load_a(FragA& a, const float* x, int r0,
                                       int c0, int g, int t) {
  const float* p = x + (r0 + g) * P + c0 + t;
  a.set(p[0], p[8 * P], p[4], p[8 * P + 4]);
}

// The A fragment of a score tile's 8 columns from the m16n8 accumulator
// that holds them: a thread's accumulator has columns 2t and 2t + 1, which
// serve as the A layout's t and t + 4 once the B operand's rows are read
// in that order (row 2t for k = t, row 2t + 1 for k = t + 4).
__device__ __forceinline__ void acc_to_a(FragA& a, const float (&c)[4]) {
  a.set(c[0], c[2], c[1], c[3]);
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Queues the copy of rows [r0, r0 + R) of a [n, d] head slice (row stride
// st) into dst[r * pitch + c], zero-filled past n and d: 16 bytes a copy
// where the rows are 16-byte aligned (`vec`), else 4.
template <int R, int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long st, int r0, int n, int d,
                                          bool vec) {
  constexpr int P = pitch<D>();
  if (vec) {
    constexpr int C4 = D / 4;
#pragma unroll
    for (int it = 0; it < R * C4 / THREADS; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int r = idx / C4, c = (idx % C4) * 4;
      const int left = d - c;
      const int valid =
          r0 + r < n ? (left >= 4 ? 4 : (left > 0 ? left : 0)) : 0;
      const float* p = valid ? src + (r0 + r) * st + c : src;
      cp_async16(dst + r * P + c, p, 4 * valid);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < R * D / THREADS; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int r = idx / D, c = idx % D;
      const bool valid = r0 + r < n && c < d;
      cp_async4(dst + r * P + c, valid ? src + (r0 + r) * st + c : src,
                valid ? 4 : 0);
    }
  }
}

// Splits a landed [BN][pitch] tile for the B fragments: its high parts over
// the values, its low parts into `lo`. Once per block and tile, where each
// of the four warps would otherwise split every element it reads (the
// dk/dv kernel; the dq kernel splits in registers, see there).
template <int D>
__device__ __forceinline__ void split_tile(float* x, float* lo) {
  constexpr int P = pitch<D>(), C4 = D / 4;
#pragma unroll
  for (int it = 0; it < BN * C4 / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int at = (idx / C4) * P + (idx % C4) * 4;
    float4 v = *reinterpret_cast<const float4*>(x + at);
    unsigned h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    *reinterpret_cast<float4*>(x + at) =
        make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                    __uint_as_float(h[2]), __uint_as_float(h[3]));
    *reinterpret_cast<float4*>(lo + at) =
        make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                    __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// Which operands' rows are 16-byte aligned (set by the launch).
enum : int { kVecQ = 1, kVecK = 2, kVecV = 4, kVecDO = 8 };

// Queries [q_lo, q_hi] against keys [k_lo, k_hi]: 0 when every pair is
// masked, 2 when every pair is visible, 1 otherwise.
__device__ __forceinline__ int band(int q_lo, int q_hi, int k_lo, int k_hi,
                                    const Shape& s, const Options& o) {
  if (q_lo >= s.tq || k_lo >= s.tk) return 0;
  if (o.causal) {
    if (k_lo > q_hi) return 0;
    if (o.window && q_lo - k_hi >= o.window) return 0;
  }
  const bool inside = q_hi < s.tq && k_hi < s.tk &&
                      (!o.causal || (k_hi <= q_lo &&
                                     (!o.window || q_hi - k_lo < o.window)));
  return inside ? 2 : 1;
}

// Four 8 x 4 f32 blocks of shared memory in one instruction (ldmatrix of
// four 8 x 8 b16 matrices): thread i gives the address of row i % 8 of
// block i / 8 and receives, from each block, the word at (row g, column t).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const float* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The forward: one block per (b*H + h, 64-row query tile), the heaviest
// causal tiles first; warp w owns query rows 16w..16w+15 with their running
// max m and sum l in registers (a row's values sit in the 4 lanes of one
// quad). Loops over the visible 32-key tiles: S = Q K^T into registers, the
// online softmax in place (p, then the dropped and rescaled p_d), and the
// tile's share of P_d V from S's accumulators as A fragments (V's rows read
// in their column order), added once to the rescaled O. Q and K fragments
// come by ldmatrix, V's by scalar loads; each warp splits what it reads in
// registers (three blocks an SM at d=64).
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 3 : 1)
attention_forward_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, Shape s, Strides sq,
                         Strides sk, Strides sv, Options opt, int vec) {
  constexpr int P = pitch<D>();
  constexpr int KD = D / 8;   // 8-wide steps over the head dim
  constexpr int NK = BN / 8;  // 8-key steps over a key tile
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BM][P]
  float* ks = qs + BM * P;                        // [2][BN][P]
  float* vs = ks + 2 * BN * P;                    // [2][BN][P]

  const int bh = blockIdx.x;
  const int b = bh / s.h, h = bh % s.h;
  const int group = s.h / s.hkv, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const float* kh = k + b * sk.b + kvh * sk.h;
  const float* vh = v + b * sv.b + kvh * sv.h;
  const unsigned hh = b * s.hkv + kvh;
  const unsigned seed = opt.seed + static_cast<unsigned>(h % group) * GOLDEN;

  int j_lo, j_hi;
  key_range<BM, BN>(q0, s, opt, &j_lo, &j_hi);
  load_rows<BM, D>(qs, q + b * sq.b + h * sq.h, sq.t, q0, s.tq, s.d,
                   vec & kVecQ);
  load_rows<BN, D>(ks, kh, sk.t, j_lo * BN, s.tk, s.d, vec & kVecK);
  load_rows<BN, D>(vs, vh, sv.t, j_lo * BN, s.tk, s.d, vec & kVecV);
  cp_async_commit();

  // this thread's two rows, g and g + 8 of the warp's 16: element e of an
  // accumulator is row e >> 1
  const int qa = q0 + r0 + g;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[KD][4];
#pragma unroll
  for (int c = 0; c < KD; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int stage = (j - j_lo) & 1;
    const float* kt = ks + stage * BN * P;
    const float* vt = vs + stage * BN * P;
    cp_async_wait_all();
    __syncthreads();  // tile j landed; tile j - 1's stage is free
    if (j < j_hi) {
      load_rows<BN, D>(ks + (stage ^ 1) * BN * P, kh, sk.t, (j + 1) * BN,
                       s.tk, s.d, vec & kVecK);
      load_rows<BN, D>(vs + (stage ^ 1) * BN * P, vh, sv.t, (j + 1) * BN,
                       s.tk, s.d, vec & kVecV);
    }
    cp_async_commit();
    const int k0 = j * BN;
    const int vis = band(q0 + r0, q0 + r0 + 15, k0, k0 + BN - 1, s, opt);
    if (vis == 0) continue;  // the warp's rows see none of these keys

    // S, its small terms summed apart. Q's A fragment: blocks (rows 0-7,
    // columns 0-3), (8-15, 0-3), (0-7, 4-7), (8-15, 4-7); K's B fragments
    // of key tiles n and n + 1: (keys 0-7 of n, columns 0-3), (n, 4-7),
    // (n + 1, 0-3), (n + 1, 4-7)
    float sc[NK][4], scs[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = scs[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned r[4];
      ldsm_x4(r, qs + (r0 + (lane & 7) + (lane & 8)) * P + kk * 8 +
                     (lane >> 4) * 4);
      FragA qf;
      qf.set(__uint_as_float(r[0]), __uint_as_float(r[1]),
             __uint_as_float(r[2]), __uint_as_float(r[3]));
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        ldsm_x4(r, kt + (n * 8 + (lane & 7) + (lane >> 4) * 8) * P + kk * 8 +
                       (lane & 8) / 2);
        FragB b0, b1;
        split_tf32(__uint_as_float(r[0]), b0.h0, b0.l0);
        split_tf32(__uint_as_float(r[1]), b0.h1, b0.l1);
        split_tf32(__uint_as_float(r[2]), b1.h0, b1.l0);
        split_tf32(__uint_as_float(r[3]), b1.h1, b1.l1);
        mma3s(sc[n], scs[n], qf, b0);
        mma3s(sc[n + 1], scs[n + 1], qf, b1);
      }
    }

    // the online softmax: scaled scores, masked ones -inf; each row's max
    // and sum meet over the 4 lanes of its quad
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qa + (e & 2) * 4;
        const int ki = k0 + n * 8 + 2 * t + (e & 1);
        float x = -INFINITY;
        if (vis == 2 || visible(qi, ki, s, opt))
          x = (sc[n][e] + scs[n][e]) * opt.scale;
        sc[n][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float mn = fmaxf(m[r], mt[r]);
      alpha[r] = (mn == -INFINITY) ? 1.0f : expf(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[n][e];
        const float p = (x == -INFINITY) ? 0.0f : expf(x - m[e >> 1]);
        rs[e >> 1] += p;
        float pd = p;
        if (opt.dropout) {
          const int qi = qa + (e & 2) * 4;
          const int ki = k0 + n * 8 + 2 * t + (e & 1);
          pd = keep(hh, qi, ki, s, seed, opt.thresh) ? p * opt.inv : 0.0f;
        }
        sc[n][e] = pd;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }

    // the tile's share of P_d V, V's rows read in the accumulators' column
    // order, summed apart and added once to the rescaled O
    float part[KD][4];
#pragma unroll
    for (int c = 0; c < KD; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[c][e] = 0.0f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      FragA a;
      acc_to_a(a, sc[n]);
#pragma unroll
      for (int c = 0; c < KD; ++c) {
        const int at = (n * 8 + 2 * t) * P + c * 8 + g;
        mma3(part[c], a, split_b(vt, at, at + P));
      }
    }
#pragma unroll
    for (int c = 0; c < KD; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[c][e] = acc[c][e] * alpha[e >> 1] + part[c][e];
  }
  cp_async_wait_all();

  const long long rowa = static_cast<long long>(bh) * s.tq + qa;
#pragma unroll
  for (int c = 0; c < KD; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c * 8 + 2 * t + (e & 1);
      if (qa + (e & 2) * 4 < s.tq && col < s.d)
        o[(rowa + (e & 2) * 4) * s.d + col] = acc[c][e] / l[e >> 1];
    }
  if (t == 0) {
    if (qa < s.tq) lse[rowa] = m[0] + logf(l[0]);
    if (qa + 8 < s.tq) lse[rowa + 8] = m[1] + logf(l[1]);
  }
}

// dq: one block per (b*H + h, 64-row query tile); warp w owns query rows
// 16w..16w+15. Loops over the visible 32-key tiles: S = Q K^T and
// dP = dO V^T into registers, dS = P (dP - D) scale in place, dQ += dS K.
// Each warp splits the K and V values it reads in registers: with three
// products a tile that keeps the block at 168 registers a thread and
// 69,632 bytes at d=64, three blocks an SM, which ran faster on the H100
// than the dk/dv kernel's shared split planes at two blocks.
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 3 : 1)
attention_backward_dq_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, Shape s, Strides sq,
                             Strides sk, Strides sv, Strides sdo,
                             Options opt, int vec) {
  constexpr int P = pitch<D>();
  constexpr int KD = D / 8;   // 8-wide steps over the head dim
  constexpr int NK = BN / 8;  // 8-key steps over a key tile
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BM][P]
  float* dos = qs + BM * P;                       // [BM][P]
  float* ks = dos + BM * P;                       // [2][BN][P]
  float* vs = ks + 2 * BN * P;                    // [2][BN][P]

  const int bh = blockIdx.x;
  const int b = bh / s.h, h = bh % s.h;
  const int group = s.h / s.hkv, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const float* kh = k + b * sk.b + kvh * sk.h;
  const float* vh = v + b * sv.b + kvh * sv.h;
  const unsigned hh = b * s.hkv + kvh;
  const unsigned seed = opt.seed + static_cast<unsigned>(h % group) * GOLDEN;

  int j_lo, j_hi;
  key_range<BM, BN>(q0, s, opt, &j_lo, &j_hi);
  load_rows<BM, D>(qs, q + b * sq.b + h * sq.h, sq.t, q0, s.tq, s.d,
                   vec & kVecQ);
  load_rows<BM, D>(dos, dout + b * sdo.b + h * sdo.h, sdo.t, q0, s.tq, s.d,
                   vec & kVecDO);
  load_rows<BN, D>(ks, kh, sk.t, j_lo * BN, s.tk, s.d, vec & kVecK);
  load_rows<BN, D>(vs, vh, sv.t, j_lo * BN, s.tk, s.d, vec & kVecV);
  cp_async_commit();

  // this thread's two rows, g and g + 8 of the warp's 16
  const int qa = q0 + r0 + g, qb = qa + 8;
  const long long rowa = static_cast<long long>(bh) * s.tq + qa;
  const long long rowb = rowa + 8;
  const float la = qa < s.tq ? lse[rowa] : 0.0f;
  const float lb = qb < s.tq ? lse[rowb] : 0.0f;
  const float da = qa < s.tq ? delta[rowa] : 0.0f;
  const float db = qb < s.tq ? delta[rowb] : 0.0f;
  float acc[KD][4];
#pragma unroll
  for (int c = 0; c < KD; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int stage = (j - j_lo) & 1;
    const float* kt = ks + stage * BN * P;
    const float* vt = vs + stage * BN * P;
    cp_async_wait_all();
    __syncthreads();  // tile j landed; tile j - 1's stage is free
    if (j < j_hi) {
      load_rows<BN, D>(ks + (stage ^ 1) * BN * P, kh, sk.t, (j + 1) * BN,
                       s.tk, s.d, vec & kVecK);
      load_rows<BN, D>(vs + (stage ^ 1) * BN * P, vh, sv.t, (j + 1) * BN,
                       s.tk, s.d, vec & kVecV);
    }
    cp_async_commit();
    const int k0 = j * BN;
    const int vis = band(q0 + r0, q0 + r0 + 15, k0, k0 + BN - 1, s, opt);
    if (vis == 0) continue;  // the warp's rows see none of these keys

    // S and dP, their small terms summed apart
    float sc[NK][4], dp[NK][4], scs[NK][4], dps[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = scs[n][e] =
          dps[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      FragA qa_, oa_;
      load_a<P>(qa_, qs, r0, kk * 8, g, t);
      load_a<P>(oa_, dos, r0, kk * 8, g, t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int o = (n * 8 + g) * P + kk * 8 + t;
        mma3s(sc[n], scs[n], qa_, split_b(kt, o, o + 4));
        mma3s(dp[n], dps[n], oa_, split_b(vt, o, o + 4));
      }
    }

    // dS in place of S: element e of tile n is row (e < 2 ? qa : qb), key
    // k0 + 8n + 2t + (e & 1)
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = e < 2 ? qa : qb;
        const int ki = k0 + n * 8 + 2 * t + (e & 1);
        float ds = 0.0f;
        if (vis == 2 || visible(qi, ki, s, opt)) {
          const float p = expf((sc[n][e] + scs[n][e]) * opt.scale -
                               (e < 2 ? la : lb));
          float d = dp[n][e] + dps[n][e];
          if (opt.dropout)
            d = keep(hh, qi, ki, s, seed, opt.thresh) ? d * opt.inv : 0.0f;
          ds = p * (d - (e < 2 ? da : db)) * opt.scale;
        }
        sc[n][e] = ds;
      }

    // dQ += dS K, K's rows read in the accumulators' column order; the
    // tile's share is summed apart and added to dQ once
    FragA a[NK];
#pragma unroll
    for (int n = 0; n < NK; ++n) acc_to_a(a[n], sc[n]);
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int o = (n * 8 + 2 * t) * P + c * 8 + g;
        mma3(part, a[n], split_b(kt, o, o + P));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] += part[e];
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int c = 0; c < KD; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = e < 2 ? qa : qb;
      const int col = c * 8 + 2 * t + (e & 1);
      if (qi < s.tq && col < s.d)
        dq[(e < 2 ? rowa : rowb) * s.d + col] = acc[c][e];
    }
}

// dk, dv: one block per (b*Hkv + kvh, 64-row key tile); warp w owns key
// rows 16w..16w+15. Loops over the group's query heads and each one's
// visible 32-query tiles, in the transposed tile (keys as rows):
// S^T = K Q^T, dP^T = V dO^T; dV += P_d^T dO, dK += dS^T Q, where P_d is
// the dropped and rescaled p. Four products a tile read the looped Q and dO
// tiles as B operands, so the block splits each landed tile once into high
// and low planes (`split_tile`) for its four warps: two blocks an SM at
// d=64, faster on the H100 than splitting in registers at three.
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1)
attention_backward_dkv_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              Shape s, Strides sq, Strides sk, Strides sv,
                              Strides sdo, Options opt, int vec) {
  constexpr int P = pitch<D>();
  constexpr int KD = D / 8;
  constexpr int NQ = BN / 8;  // 8-query steps over a query tile
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BM][P]
  float* vs = ks + BM * P;                        // [BM][P]
  float* qs = vs + BM * P;                        // [2][BN][P], then hi
  float* dos = qs + 2 * BN * P;                   // [2][BN][P], then hi
  float* ql = dos + 2 * BN * P;                   // [BN][P] lo
  float* dol = ql + BN * P;                       // [BN][P] lo
  float* ls = dol + BN * P;                       // [2][BN]
  float* es = ls + 2 * BN;                        // [2][BN]

  const int bkv = blockIdx.x;
  const int b = bkv / s.hkv, kvh = bkv % s.hkv;
  const int group = s.h / s.hkv;
  const int k0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const unsigned hh = bkv;

  // the query tiles that see this key tile, for each of the group's heads
  const int nq = (s.tq + BN - 1) / BN;
  int i_lo = 0, i_hi = nq - 1;
  if (opt.causal) {
    i_lo = k0 / BN;
    if (opt.window) i_hi = min(i_hi, (k0 + BM - 1 + opt.window - 1) / BN);
  }
  const int per_head = max(0, i_hi - i_lo + 1);
  const int steps = group * per_head;

  // queues step u's query tile: q, dO, lse and delta rows into `stage`
  auto load_step = [&](int u, int stage) {
    const int gi = u / per_head, q0 = (i_lo + u % per_head) * BN;
    const int h = kvh * group + gi;
    load_rows<BN, D>(qs + stage * BN * P, q + b * sq.b + h * sq.h, sq.t, q0,
                     s.tq, s.d, vec & kVecQ);
    load_rows<BN, D>(dos + stage * BN * P, dout + b * sdo.b + h * sdo.h,
                     sdo.t, q0, s.tq, s.d, vec & kVecDO);
    const long long head_row = (static_cast<long long>(b) * s.h + h) * s.tq;
    const int i = threadIdx.x % BN;
    const bool ok = q0 + i < s.tq;
    if (threadIdx.x < BN)
      cp_async4(ls + stage * BN + i, ok ? lse + head_row + q0 + i : lse,
                ok ? 4 : 0);
    else if (threadIdx.x < 2 * BN)
      cp_async4(es + stage * BN + i, ok ? delta + head_row + q0 + i : delta,
                ok ? 4 : 0);
  };

  load_rows<BM, D>(ks, k + b * sk.b + kvh * sk.h, sk.t, k0, s.tk, s.d,
                   vec & kVecK);
  load_rows<BM, D>(vs, v + b * sv.b + kvh * sv.h, sv.t, k0, s.tk, s.d,
                   vec & kVecV);
  if (steps > 0) load_step(0, 0);
  cp_async_commit();

  const int ka = k0 + r0 + g, kb = ka + 8;
  float adk[KD][4], adv[KD][4];
#pragma unroll
  for (int c = 0; c < KD; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[c][e] = adv[c][e] = 0.0f;

  for (int u = 0; u < steps; ++u) {
    const int stage = u & 1;
    float* qt = qs + stage * BN * P;
    float* dot = dos + stage * BN * P;
    const float* lt = ls + stage * BN;
    const float* et = es + stage * BN;
    cp_async_wait_all();
    __syncthreads();  // step u landed; step u - 1's planes are free
    if (u + 1 < steps) load_step(u + 1, stage ^ 1);
    cp_async_commit();
    split_tile<D>(qt, ql);
    split_tile<D>(dot, dol);
    __syncthreads();  // the planes are split
    const int gi = u / per_head, q0 = (i_lo + u % per_head) * BN;
    const int vis = band(q0, q0 + BN - 1, k0 + r0, k0 + r0 + 15, s, opt);
    if (vis == 0) continue;  // none of these queries sees the warp's keys
    const unsigned seed = opt.seed + static_cast<unsigned>(gi) * GOLDEN;

    // S^T and dP^T, their small terms summed apart
    float st[NQ][4], dpt[NQ][4], sts[NQ][4], dpts[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = sts[n][e] =
          dpts[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      FragA ka_, va_;
      load_a<P>(ka_, ks, r0, kk * 8, g, t);
      load_a<P>(va_, vs, r0, kk * 8, g, t);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int o = (n * 8 + g) * P + kk * 8 + t;
        mma3s(st[n], sts[n], ka_, frag_b(qt, ql, o, o + 4));
        mma3s(dpt[n], dpts[n], va_, frag_b(dot, dol, o, o + 4));
      }
    }

    // P_d in place of S^T, dS in place of dP^T: element e of tile n is key
    // (e < 2 ? ka : kb), query q0 + 8n + 2t + (e & 1)
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ki = e < 2 ? ka : kb;
        const int col = n * 8 + 2 * t + (e & 1);
        const int qi = q0 + col;
        float pd = 0.0f, ds = 0.0f;
        if (vis == 2 || visible(qi, ki, s, opt)) {
          const float p =
              expf((st[n][e] + sts[n][e]) * opt.scale - lt[col]);
          float d = dpt[n][e] + dpts[n][e];
          pd = p;
          if (opt.dropout) {
            const bool kp = keep(hh, qi, ki, s, seed, opt.thresh);
            pd = kp ? p * opt.inv : 0.0f;
            d = kp ? d * opt.inv : 0.0f;
          }
          ds = p * (d - et[col]) * opt.scale;
        }
        st[n][e] = pd;
        dpt[n][e] = ds;
      }

    // dV += P_d^T dO and dK += dS^T Q, dO's and Q's rows read in the
    // accumulators' column order; the tile's shares are summed apart and
    // added once
    FragA ap[NQ], as[NQ];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      acc_to_a(ap[n], st[n]);
      acc_to_a(as[n], dpt[n]);
    }
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      float pv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float pk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int o = (n * 8 + 2 * t) * P + c * 8 + g;
        mma3(pv, ap[n], frag_b(dot, dol, o, o + P));
        mma3(pk, as[n], frag_b(qt, ql, o, o + P));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        adv[c][e] += pv[e];
        adk[c][e] += pk[e];
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int c = 0; c < KD; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ki = e < 2 ? ka : kb;
      const int col = c * 8 + 2 * t + (e & 1);
      if (ki < s.tk && col < s.d) {
        const long long row = static_cast<long long>(bkv) * s.tk + ki;
        dk[row * s.d + col] = adk[c][e];
        dv[row * s.d + col] = adv[c][e];
      }
    }
}

// The forward block: Q's [BM][P] rows and two stages of K and V tiles,
// 52,224 bytes at d=64 (three blocks an SM, as the registers allow).
template <int D>
constexpr size_t forward_smem() {
  return sizeof(float) * (BM + 4 * BN) * pitch<D>();
}
// The backward blocks: two resident [BM][P] operands and two stages of two
// looped [BN][P] ones; in dk/dv also the looped operands' low planes and
// two stages of lse and delta. 69,632 and 87,552 bytes at d=64: three dq
// blocks an SM, two dk/dv blocks.
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * BM + 4 * BN) * pitch<D>();
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((2 * BM + 6 * BN) * pitch<D>() + 4 * BN);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The operands whose every row starts 16 bytes aligned: an aligned base
// and batch, head and row strides that are multiples of 4 floats.
int vec_flags(const float* q, const float* k, const float* v,
              const float* dout, const Strides& sq, const Strides& sk,
              const Strides& sv, const Strides& sdo) {
  auto rows16 = [](const float* p, const Strides& st) {
    return aligned16(p) && st.b % 4 == 0 && st.h % 4 == 0 && st.t % 4 == 0;
  };
  return (rows16(q, sq) ? kVecQ : 0) | (rows16(k, sk) ? kVecK : 0) |
         (rows16(v, sv) ? kVecV : 0) | (rows16(dout, sdo) ? kVecDO : 0);
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
  const dim3 grid(s.b * s.h, (s.tq + BM - 1) / BM);
  attention_forward_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, k, v, o, lse, s, sq, sk, sv, opt,
      vec_flags(q, k, v, q, sq, sk, sv, sq));
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
  const dim3 grid(s.b * s.h, (s.tq + BM - 1) / BM);
  attention_backward_dq_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, k, v, dout, lse, delta, dq, s, sq, sk, sv, sdo, opt,
      vec_flags(q, k, v, dout, sq, sk, sv, sdo));
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
  const dim3 grid(s.b * s.hkv, (s.tk + BM - 1) / BM);
  attention_backward_dkv_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, s, sq, sk, sv, sdo, opt,
      vec_flags(q, k, v, dout, sq, sk, sv, sdo));
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
