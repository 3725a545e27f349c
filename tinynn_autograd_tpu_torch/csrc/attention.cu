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
//   bit-identical. Head dims: q and k share one, d_qk, and v has its own,
//   d_v (o, dO and dv have v's). Either d_qk == d_v <= 128 (templates for
//   32, 64 and, in the forward, 128; a smaller d is zero-padded in shared
//   memory), with dq and dk/dv at head dims 65-128 on
//   `attention_backward_dq_kernel_wgmma` and
//   `attention_backward_dkv_kernel_wgmma`, designs of their own for Hopper
//   (below the templates; `dq_design` and `dkv_design` in ops/attention.py
//   choose); or the split dims of multi-head latent attention, d_qk in
//   (128, 192] with d_v <= 128, on the forward and dq templates
//   instantiated at <192, 128> and on
//   `attention_backward_dkv_kernel_wgmma_split`: S and dP run over their
//   own widths (192 and 128), P V, dV and dO over 128, dQ and dK over 192,
//   so v is never padded to 192.
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
// forward splits each K and V value once in each of its four warps). At
// Mellum 2's shapes (32:4 GQA of head dim 128 over 4 x 8,192 tokens) the
// d = 128 dk/dv and dq templates ran at 16.7% and 20.4% of their 3xTF32
// bounds: one block of 4 warps an SM, `mma.sync` chains and every looped
// tile split between barriers with no product running. Their replacements
// there, the two wgmma kernels, are described where they are defined. A
// fused backward that computes S and dP once (without float atomics), and
// `wgmma` in the forward and at d <= 64, are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32.cuh"
#include "wgmma.cuh"

namespace {

using tinynn::fence_operand;
using tinynn::split_tf32;
using tinynn::wgmma_commit;
using tinynn::wgmma_fence;
using tinynn::wgmma_tf32;
using tinynn::wgmma_wait;

constexpr unsigned GOLDEN = 2654435761u;

struct Shape {
  int b, h, hkv, tq, tk, d, dv;  // d: q's and k's head dim; dv: v's
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
// words for D = 32, 64, 128 and 192, so that every fragment read below is free
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
// registers (three blocks an SM at d=64). D is the head dim of q and k,
// DV that of v and o (DV = D but at split dims, 192/128).
template <int D, int DV>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 3 : 1)
attention_forward_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, Shape s, Strides sq,
                         Strides sk, Strides sv, Options opt, int vec) {
  constexpr int P = pitch<D>(), PV = pitch<DV>();
  constexpr int KD = D / 8;    // 8-wide steps over q's and k's head dim
  constexpr int KDV = DV / 8;  // and over v's
  constexpr int NK = BN / 8;   // 8-key steps over a key tile
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BM][P]
  float* ks = qs + BM * P;                        // [2][BN][P]
  float* vs = ks + 2 * BN * P;                    // [2][BN][PV]

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
  load_rows<BN, DV>(vs, vh, sv.t, j_lo * BN, s.tk, s.dv, vec & kVecV);
  cp_async_commit();

  // this thread's two rows, g and g + 8 of the warp's 16: element e of an
  // accumulator is row e >> 1
  const int qa = q0 + r0 + g;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[KDV][4];
#pragma unroll
  for (int c = 0; c < KDV; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int stage = (j - j_lo) & 1;
    const float* kt = ks + stage * BN * P;
    const float* vt = vs + stage * BN * PV;
    cp_async_wait_all();
    __syncthreads();  // tile j landed; tile j - 1's stage is free
    if (j < j_hi) {
      load_rows<BN, D>(ks + (stage ^ 1) * BN * P, kh, sk.t, (j + 1) * BN,
                       s.tk, s.d, vec & kVecK);
      load_rows<BN, DV>(vs + (stage ^ 1) * BN * PV, vh, sv.t, (j + 1) * BN,
                        s.tk, s.dv, vec & kVecV);
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
    float part[KDV][4];
#pragma unroll
    for (int c = 0; c < KDV; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[c][e] = 0.0f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      FragA a;
      acc_to_a(a, sc[n]);
#pragma unroll
      for (int c = 0; c < KDV; ++c) {
        const int at = (n * 8 + 2 * t) * PV + c * 8 + g;
        mma3(part[c], a, split_b(vt, at, at + PV));
      }
    }
#pragma unroll
    for (int c = 0; c < KDV; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[c][e] = acc[c][e] * alpha[e >> 1] + part[c][e];
  }
  cp_async_wait_all();

  const long long rowa = static_cast<long long>(bh) * s.tq + qa;
#pragma unroll
  for (int c = 0; c < KDV; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c * 8 + 2 * t + (e & 1);
      if (qa + (e & 2) * 4 < s.tq && col < s.dv)
        o[(rowa + (e & 2) * 4) * s.dv + col] = acc[c][e] / l[e >> 1];
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
// than the dk/dv kernel's shared split planes at two blocks. D is the head
// dim of q, k and dq, DV that of v and dO (DV = D but at split dims).
template <int D, int DV>
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
  constexpr int P = pitch<D>(), PV = pitch<DV>();
  constexpr int KD = D / 8;    // 8-wide steps over q's and k's head dim
  constexpr int KDV = DV / 8;  // and over v's and dO's
  constexpr int NK = BN / 8;   // 8-key steps over a key tile
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BM][P]
  float* dos = qs + BM * P;                       // [BM][PV]
  float* ks = dos + BM * PV;                      // [2][BN][P]
  float* vs = ks + 2 * BN * P;                    // [2][BN][PV]

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
  load_rows<BM, DV>(dos, dout + b * sdo.b + h * sdo.h, sdo.t, q0, s.tq,
                    s.dv, vec & kVecDO);
  load_rows<BN, D>(ks, kh, sk.t, j_lo * BN, s.tk, s.d, vec & kVecK);
  load_rows<BN, DV>(vs, vh, sv.t, j_lo * BN, s.tk, s.dv, vec & kVecV);
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
    const float* vt = vs + stage * BN * PV;
    cp_async_wait_all();
    __syncthreads();  // tile j landed; tile j - 1's stage is free
    if (j < j_hi) {
      load_rows<BN, D>(ks + (stage ^ 1) * BN * P, kh, sk.t, (j + 1) * BN,
                       s.tk, s.d, vec & kVecK);
      load_rows<BN, DV>(vs + (stage ^ 1) * BN * PV, vh, sv.t, (j + 1) * BN,
                        s.tk, s.dv, vec & kVecV);
    }
    cp_async_commit();
    const int k0 = j * BN;
    const int vis = band(q0 + r0, q0 + r0 + 15, k0, k0 + BN - 1, s, opt);
    if (vis == 0) continue;  // the warp's rows see none of these keys

    // S and dP, their small terms summed apart (S over D, dP over DV: one
    // loop over the wider)
    float sc[NK][4], dp[NK][4], scs[NK][4], dps[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = scs[n][e] =
          dps[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < (KD > KDV ? KD : KDV); ++kk) {
      FragA qa_, oa_;
      if (kk < KD) load_a<P>(qa_, qs, r0, kk * 8, g, t);
      if (kk < KDV) load_a<PV>(oa_, dos, r0, kk * 8, g, t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int o = (n * 8 + g) * P + kk * 8 + t;
        const int ov = (n * 8 + g) * PV + kk * 8 + t;
        if (kk < KD) mma3s(sc[n], scs[n], qa_, split_b(kt, o, o + 4));
        if (kk < KDV) mma3s(dp[n], dps[n], oa_, split_b(vt, ov, ov + 4));
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

// ---------------------------------------------------------------------------
// dk, dv at head dims 65-128 on wgmma: two consumer warpgroups and a
// producer warpgroup under mbarriers
// ---------------------------------------------------------------------------
//
// One block per (b*Hkv + kvh, 64-key tile), 384 threads, one block an SM,
// in grid order (key tile 0, the heaviest under a causal mask, first). It
// walks the same 32-query steps as the template above (the group's heads in
// order, each one's visible query tiles), in the transposed tile. Each
// consumer owns the 64 keys, 16 a warp as in `mma.sync`, and runs two of
// the four products as `wgmma` in 3xTF32 (m64nNk8 TF32, A in registers):
// - consumer 0: S^T = K Q^T (m64n32k8, 16 steps over d), P, P_d, and
//   dV += P_d^T dO (m64n128k8, 4 steps over the queries);
// - consumer 1: dP^T = V dO^T, dS (P handed over by consumer 0 through
//   shared memory), and dK += dS^T Q.
// K's and V's A fragments are read from raw f32 copies in fragment order
// (one 16-byte load) and split in registers a step ahead of their wgmmas; B
// is the step's Q or dO in K-major [query][d] TF32 planes; the small terms
// are summed apart. For dV and dK, A is P_d or dS straight from the score
// accumulators (columns 2t and 2t + 1 as slots t and t + 4, as in the
// template); B is dO or Q in K-major [d][query] planes whose queries are
// stored in that slot order; each step's share is summed apart and added
// once to the f32 accumulator (64 registers a thread), which is written to
// dk or dv once, at the end.
// The producer reads each step's Q and dO rows (16-byte loads where the
// rows are 16-byte aligned, else 4-byte; zero past T and d), lse and delta
// into registers, splits them (tf32.cuh) and writes the [query][d] planes,
// then, after a transpose of 4 x 4 blocks across each quad's lanes, the
// [d][query] planes, every warp's 16-byte stores free of bank conflicts.
// It reloads each operand for the next step as soon as its last planes are
// written. `setmaxnreg` moves 16 registers a thread from the producer (152)
// to each consumer (176), from the 168 each has at launch.
// Shared memory: the four [query][d] planes of a step (64 KB), the four
// [d][query] planes (64 KB), K and V in fragment order (64 KB), P (8 KB),
// lse, delta and ten mbarriers: 205,136 bytes. Each consumer has a full and
// an empty barrier for its [query][d] planes and for its [d][query] ones,
// so the producer writes step u + 1's planes while the consumers still run
// step u, and neither consumer waits for the other but for P.
// The budget decides the shape: K and V as split planes (128 KB) leave no
// room for a step's eight planes, and 64-query steps (n64 score products)
// or 128-key blocks would need another 64-128 KB. PERF.md gives the
// designs measured on the way (one consumer warpgroup; barriers shared by
// the consumers; other register splits and wgmma shapes).
namespace dkvw {
constexpr int D = 128;         // head dims 65-128, zero-padded
constexpr int BK = 64;         // keys a block: each consumer's 64 rows
constexpr int BQ = 32;         // queries a step
constexpr int RING = 2;        // K's or V's fragments in flight
constexpr int PLANE = BQ * D;  // floats in one plane of a step
constexpr int NTHREADS = 384;  // two consumer warpgroups, one producer
// registers a thread: 168 at launch (384 threads an SM), then the producer
// gives up what the consumers take (`setmaxnreg`)
constexpr int ENTRY_REGS = 168, CONSUMER_REGS = 176, PRODUCER_REGS = 152;
static_assert(2 * (CONSUMER_REGS - ENTRY_REGS) <= ENTRY_REGS - PRODUCER_REGS,
              "the consumers take only what the producer gives up");
// float offsets in shared memory: the [query][d] planes Q hi, Q lo, dO hi,
// dO lo, then the [d][query] planes in the same order, K, V, P, lse, delta
constexpr int NAT = 0, TRN = 4 * PLANE, KS = 8 * PLANE, VS = KS + BK * D,
              PS = VS + BK * D, LS = PS + BK * BQ, ES = LS + BQ,
              BARS = ES + BQ;
// barriers, a pair of each for consumer c (0: S^T and dV, 1: dP^T and dK):
// its [query][d] planes (Q's or dO's, with lse or delta) full and empty, its
// [d][query] planes (dO's or Q's) full and empty; then P's hand-over from
// consumer 0 to consumer 1. Each counts one arrival a warp of a warpgroup.
enum {
  kNatFull = 0, kNatEmpty = 2, kTrnFull = 4, kTrnEmpty = 6, kPFull = 8,
  kPEmpty = 9, kBars = 10
};
constexpr size_t SMEM = sizeof(float) * BARS + kBars * sizeof(uint64_t);
// bytes between 8-row groups of core matrices: [query][d] and [d][query]
constexpr unsigned NAT_STRIDE = (D / 4) * 128, TRN_STRIDE = (BQ / 4) * 128;
}  // namespace dkvw

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// Waits for the completion of the barrier's phase of parity `parity`. A
// wait that never ends is a fault of the protocol: it traps after 2^22
// tries (seconds), so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  for (unsigned tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 22)) __trap();
  }
}
// K and V in shared memory in the order of the consumers' A fragments: the
// four values of thread `lane` of warp w at step kk of d (rows 16w + g and
// + 8, columns 8kk + t and + 4, as `load_a` reads them) are 16 bytes at
// float ((kk * 4 + w) * 32 + lane) * 4. Returns the float of (row, col).
__device__ __forceinline__ int frag_at(int row, int col) {
  const int lane = (row % 8) * 4 + col % 4;
  const int e = (row % 16) / 8 + 2 * ((col % 8) / 4);
  return (((col / 8) * 4 + row / 16) * 32 + lane) * 4 + e;
}
// Thread `tid`'s A fragment of step kk of d from such an operand, split.
__device__ __forceinline__ void load_frag(FragA& a, const float* x, int kk,
                                          int tid) {
  const float4 v = *reinterpret_cast<const float4*>(x + (kk * 128 + tid) * 4);
  a.set(v.x, v.y, v.z, v.w);
}

// One warp's arrival: its lanes' prior writes ordered before lane 0's.
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// Columns 4c..4c+3 of a [*, d] row (`ok`: the row exists), zero past d: one
// 16-byte load where the row is 16-byte aligned (`vec`) and holds all four.
__device__ __forceinline__ float4 row4(const float* row, int c, int d,
                                       bool ok, bool vec) {
  const int col = 4 * c;
  if (!ok || col >= d) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec && col + 4 <= d)
    return __ldg(reinterpret_cast<const float4*>(row + col));
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = col + e < d ? __ldg(row + col + e) : 0.0f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// The high and low TF32 parts of four values, as 16-byte words.
__device__ __forceinline__ void split4(const float4& x, uint4& hi,
                                       uint4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// Across the four lanes of a quad, lane s holding row s of a 4 x 4 block
// (x = M[s][0..3]) ends holding column s (x = M[0..3][s]): the 2 x 2
// blocks transposed in place between lanes s and s ^ 1, then the blocks off
// the diagonal swapped between lanes s and s ^ 2.
__device__ __forceinline__ void quad_transpose(float4& x) {
  const int s = threadIdx.x & 3;
  const bool odd = s & 1, high = s & 2;
  float r0 = __shfl_xor_sync(0xffffffffu, odd ? x.x : x.y, 1);
  float r1 = __shfl_xor_sync(0xffffffffu, odd ? x.z : x.w, 1);
  if (odd) {
    x.x = r0;
    x.z = r1;
  } else {
    x.y = r0;
    x.w = r1;
  }
  r0 = __shfl_xor_sync(0xffffffffu, high ? x.x : x.z, 2);
  r1 = __shfl_xor_sync(0xffffffffu, high ? x.y : x.w, 2);
  if (high) {
    x.x = r0;
    x.y = r1;
  } else {
    x.z = r0;
    x.w = r1;
  }
}

__global__ void __launch_bounds__(dkvw::NTHREADS, 1)
attention_backward_dkv_kernel_wgmma(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    const float* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    float* __restrict__ dk,
                                    float* __restrict__ dv, Shape s,
                                    Strides sq, Strides sk, Strides sv,
                                    Strides sdo, Options opt, int vec) {
  using namespace dkvw;
  extern __shared__ __align__(128) float smem[];
  float* const ks = smem + KS;
  float* const vs = smem + VS;
  float* const ps = smem + PS;
  float* const ls = smem + LS;
  float* const es = smem + ES;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + BARS);

  const int bkv = blockIdx.x;
  const int b = bkv / s.hkv, kvh = bkv % s.hkv;
  const int group = s.h / s.hkv;
  const int k0 = blockIdx.y * BK;

  // the query tiles that see this key tile, for each of the group's heads
  const int nq = (s.tq + BQ - 1) / BQ;
  int i_lo = 0, i_hi = nq - 1;
  if (opt.causal) {
    i_lo = k0 / BQ;
    if (opt.window) i_hi = min(i_hi, (k0 + BK - 1 + opt.window - 1) / BQ);
  }
  const int per_head = max(0, i_hi - i_lo + 1);
  const int steps = group * per_head;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kBars; ++i) mbar_init(bars + i, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // K's and V's rows, raw f32, by all threads, in the order of the
  // consumers' A fragments (`frag_at`)
  {
    const float* kh = k + b * sk.b + kvh * sk.h;
    const float* vh = v + b * sv.b + kvh * sv.h;
    for (int idx = threadIdx.x; idx < BK * (D / 4); idx += NTHREADS) {
      const int r = idx / (D / 4), c = idx % (D / 4);
      const bool ok = k0 + r < s.tk;
      const float4 xk =
          row4(kh + (ok ? (k0 + r) * sk.t : 0), c, s.d, ok, vec & kVecK);
      const float4 xv =
          row4(vh + (ok ? (k0 + r) * sv.t : 0), c, s.d, ok, vec & kVecV);
      const int at = frag_at(r, 4 * c);
      ks[at] = xk.x; ks[at + 4] = xk.y; ks[at + 8] = xk.z; ks[at + 12] = xk.w;
      vs[at] = xv.x; vs[at + 4] = xv.y; vs[at + 8] = xv.z; vs[at + 12] = xv.w;
    }
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- the producer: Q, dO, lse and delta of each step into the planes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    const int p = threadIdx.x - 256, pw = p / 32, lane = p % 32;
    // lane = 4a + si: the quad a holds rows 8j + 2si + odd of float4 column
    // c0 + cc; each quarter warp's 16-byte stores fill whole bank rows
    const int si = lane & 3, a = lane >> 2;
    const int odd = (a & 1) ^ ((a >> 1) & 1), cc = 2 * (a >> 2) + (a & 1);
    float4 xq[8], xo[8];
    float lv = 0.0f;
    // step u's rows of Q (or dO: `x`, its view and its alignment flag)
    auto load = [&](float4 (&x)[8], const float* src, const Strides& st,
                    bool aligned, int u) {
      const int gi = u / per_head, q0 = (i_lo + u % per_head) * BQ;
      const float* xh = src + b * st.b + (kvh * group + gi) * st.h;
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        const int wt = pw * 8 + it, j = wt >> 3, c = (wt & 7) * 4 + cc;
        const int row = q0 + 8 * j + 2 * si + odd;
        const bool ok = row < s.tq;
        x[it] = row4(xh + (ok ? row * st.t : 0), c, s.d, ok, aligned);
      }
    };
    // step u's lse (producer threads 0-31) or delta (32-63)
    auto load_stats = [&](int u) {
      const int gi = u / per_head, q0 = (i_lo + u % per_head) * BQ;
      const long long head_row =
          (static_cast<long long>(b) * s.h + kvh * group + gi) * s.tq;
      const int i = p % BQ;
      lv = 0.0f;
      if (p < 2 * BQ && q0 + i < s.tq)
        lv = p < BQ ? lse[head_row + q0 + i] : delta[head_row + q0 + i];
    };
    if (steps > 0) {
      load(xq, q, sq, vec & kVecQ, 0);
      load(xo, dout, sdo, vec & kVecDO, 0);
      load_stats(0);
    }
    // the operands' planes: x's [query][d] planes at `hi` (row q at word
    // ((q / 8) * 32 + c) * 32 + (q % 8) * 4), then its [d][query] ones
    // (column dd of slot 4 odd + i of 8-query step j at word ((dd / 8) * 8 +
    // 2 j + odd) * 32 + (dd % 8) * 4 + i, after `quad_transpose`)
    auto store_nat = [&](const float4 (&x)[8], float* hi) {
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        const int wt = pw * 8 + it, j = wt >> 3, c = (wt & 7) * 4 + cc;
        const int at = (j * (D / 4) + c) * 32 + (2 * si + odd) * 4;
        uint4 h, l;
        split4(x[it], h, l);
        *reinterpret_cast<uint4*>(hi + at) = h;
        *reinterpret_cast<uint4*>(hi + PLANE + at) = l;
      }
    };
    auto store_trn = [&](const float4 (&x)[8], float* hi) {
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        const int wt = pw * 8 + it, j = wt >> 3, c = (wt & 7) * 4 + cc;
        const int dd = 4 * c + si;
        const int at =
            ((dd >> 3) * (BQ / 4) + 2 * j + odd) * 32 + (dd & 7) * 4;
        uint4 h, l;
        split4(x[it], h, l);
        *reinterpret_cast<uint4*>(hi + at) = h;
        *reinterpret_cast<uint4*>(hi + PLANE + at) = l;
      }
    };
    // step u's planes go where step u - 1's were, once emptied
    auto emptied = [&](int bar, int u) {
      if (u > 0) mbar_wait(bars + bar, (u - 1) & 1);
    };
    for (int u = 0; u < steps; ++u) {
      emptied(kNatEmpty, u);  // Q for S^T, with lse
      store_nat(xq, smem + NAT);
      if (p < BQ) ls[p] = lv;
      tinynn::fence_async_shared();
      warp_arrive(bars + kNatFull);
      emptied(kNatEmpty + 1, u);  // dO for dP^T, with delta
      store_nat(xo, smem + NAT + 2 * PLANE);
      if (p >= BQ && p < 2 * BQ) es[p - BQ] = lv;
      tinynn::fence_async_shared();
      warp_arrive(bars + kNatFull + 1);
      // each operand's [d][query] planes, then its rows of step u + 1:
      // Q's first, so that its reload, which the next step needs first,
      // is in flight the longest
#pragma unroll
      for (int it = 0; it < 8; ++it) quad_transpose(xq[it]);
      emptied(kTrnEmpty + 1, u);  // Q for dK
      store_trn(xq, smem + TRN);
      tinynn::fence_async_shared();
      warp_arrive(bars + kTrnFull + 1);
      if (u + 1 < steps) {
        load(xq, q, sq, vec & kVecQ, u + 1);
        load_stats(u + 1);
      }
#pragma unroll
      for (int it = 0; it < 8; ++it) quad_transpose(xo[it]);
      emptied(kTrnEmpty, u);  // dO for dV
      store_trn(xo, smem + TRN + 2 * PLANE);
      tinynn::fence_async_shared();
      warp_arrive(bars + kTrnFull);
      if (u + 1 < steps) load(xo, dout, sdo, vec & kVecDO, u + 1);
    }
  } else {
    // ---- the consumers: warpgroup 0 S^T, P and dV += P_d^T dO; warpgroup
    // 1 dP^T, dS (with P from warpgroup 0) and dK += dS^T Q
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    const bool dkw = threadIdx.x >= 128;  // the dP^T and dK warpgroup
    const int lt = threadIdx.x % 128, w = lt / 32, lane = lt % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = 16 * w;
    const unsigned hh = bkv;
    const uint64_t nat_d = tinynn::kmajor_desc(smem + NAT, NAT_STRIDE);
    const uint64_t trn_d = tinynn::kmajor_desc(smem + TRN, TRN_STRIDE);
    constexpr uint64_t kPlane = PLANE * 4 >> 4;      // descriptor units
    constexpr uint64_t kStep = 256 >> 4;             // 8 of K: two cores
    // S^T reads Q's [query][d] planes, dP^T dO's; dV dO's [d][query]
    // planes, dK Q's
    const float* x = dkw ? vs : ks;
    const uint64_t y_hi = nat_d + (dkw ? 2 : 0) * kPlane;
    const uint64_t z_hi = trn_d + (dkw ? 0 : 2) * kPlane;

    float acc[64];  // dV or dK: acc[4n + e]
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;

    // sc = x y^T over d (16 steps of 8) in 3xTF32 for the warpgroup's 64
    // rows of x (K or V) against a step's 32 rows of y (Q or dO, planes at
    // y_hi and y_hi + kPlane), the small terms summed apart in `sm`; x's
    // fragments are read (one 16-byte load) and split a step ahead, in a
    // ring of RING so that RING steps' wgmmas can be in flight
    auto scores = [&](float (&sc)[16], float (&sm)[16]) {
      FragA f[RING];
      load_frag(f[0], x, 0, lt);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        fence_operand(sc[e]);
        fence_operand(sm[e]);
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int cur = kk % RING, next = (kk + 1) % RING;
        const uint64_t hi = y_hi + kk * kStep;
        wgmma_fence();
        wgmma_tf32(sm, f[cur].lo, hi, kk > 0);
        wgmma_tf32(sm, f[cur].hi, hi + kPlane, 1);
        wgmma_tf32(sc, f[cur].hi, hi, kk > 0);
        wgmma_commit();
        if (kk + 1 < D / 8) {
          wgmma_wait<RING - 1>();  // step kk + 1 - RING is done with f[next]
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            fence_operand(f[next].hi[e]);
            fence_operand(f[next].lo[e]);
          }
          load_frag(f[next], x, kk + 1, lt);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        fence_operand(sc[e]);
        fence_operand(sm[e]);
      }
#pragma unroll
      for (int c = 0; c < RING; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(f[c].hi[e]);
          fence_operand(f[c].lo[e]);
        }
    };

    // acc += the step's share of o^T z over all of d (m64n128k8): o (P_d or
    // dS) from a score accumulator, z's [d][query] planes at z_hi and
    // z_hi + kPlane; the share summed apart and added once
    auto outputs = [&](const float (&o)[16]) {
      FragA f[BQ / 8];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
        f[j].set(o[4 * j], o[4 * j + 2], o[4 * j + 1], o[4 * j + 3]);
      float part[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) fence_operand(part[e]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const uint64_t hi = z_hi + j * kStep;
        wgmma_tf32(part, f[j].lo, hi, j > 0);
        wgmma_tf32(part, f[j].hi, hi + kPlane, 1);
        wgmma_tf32(part, f[j].hi, hi, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        fence_operand(part[e]);
        acc[e] += part[e];
      }
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(f[j].hi[e]);
          fence_operand(f[j].lo[e]);
        }
    };

    int handed = 0;  // P's hand-overs so far
    for (int u = 0; u < steps; ++u) {
      const unsigned parity = u & 1;
      const int gi = u / per_head, q0 = (i_lo + u % per_head) * BQ;
      const int vis = band(q0, q0 + BQ - 1, k0, k0 + BK - 1, s, opt);
      const unsigned seed = opt.seed + static_cast<unsigned>(gi) * GOLDEN;
      // element i = 4j + e of a score accumulator: key k0 + r0 + g +
      // 8 (e / 2), query q0 + 8j + 2t + (e & 1)
      float o[16];
      mbar_wait(bars + kNatFull + dkw, parity);
      if (vis) {
        float sm[16];
        scores(o, sm);
        if (!dkw) {
          // P in place of S^T (masked pairs 0), handed to warpgroup 1; then
          // P_d, the dropped and rescaled P
          // (a tile the masks leave whole takes a loop without a branch an
          // element, so that its exponentials interleave)
          if (vis == 2) {
#pragma unroll
            for (int i = 0; i < 16; ++i)
              o[i] = expf((o[i] + sm[i]) * opt.scale -
                          ls[8 * (i >> 2) + 2 * t + (i & 1)]);
          } else {
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const int ki = k0 + r0 + g + 8 * ((i & 2) >> 1);
              const int col = 8 * (i >> 2) + 2 * t + (i & 1);
              float pv = 0.0f;
              if (visible(q0 + col, ki, s, opt))
                pv = expf((o[i] + sm[i]) * opt.scale - ls[col]);
              o[i] = pv;
            }
          }
          if (handed > 0) mbar_wait(bars + kPEmpty, (handed - 1) & 1);
#pragma unroll
          for (int i = 0; i < 16; ++i) ps[i * 128 + lt] = o[i];
          warp_arrive(bars + kPFull);
          if (opt.dropout) {
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const int ki = k0 + r0 + g + 8 * ((i & 2) >> 1);
              const int qi = q0 + 8 * (i >> 2) + 2 * t + (i & 1);
              if (o[i] != 0.0f)
                o[i] = keep(hh, qi, ki, s, seed, opt.thresh) ? o[i] * opt.inv
                                                             : 0.0f;
            }
          }
        } else {
          // dS in place of dP^T
          mbar_wait(bars + kPFull, handed & 1);
          if (vis == 2 && !opt.dropout) {
#pragma unroll
            for (int i = 0; i < 16; ++i)
              o[i] = ps[i * 128 + lt] *
                     (o[i] + sm[i] - es[8 * (i >> 2) + 2 * t + (i & 1)]) *
                     opt.scale;
          } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int ki = k0 + r0 + g + 8 * ((i & 2) >> 1);
            const int col = 8 * (i >> 2) + 2 * t + (i & 1);
            const int qi = q0 + col;
            float ds = 0.0f;
            if (vis == 2 || visible(qi, ki, s, opt)) {
              const float pv = ps[i * 128 + lt];
              float d = o[i] + sm[i];
              if (opt.dropout)
                d = keep(hh, qi, ki, s, seed, opt.thresh) ? d * opt.inv
                                                          : 0.0f;
              ds = pv * (d - es[col]) * opt.scale;
            }
            o[i] = ds;
          }
          }
          warp_arrive(bars + kPEmpty);
        }
        ++handed;
      }
      warp_arrive(bars + kNatEmpty + dkw);
      mbar_wait(bars + kTrnFull + dkw, parity);
      if (vis) outputs(o);
      warp_arrive(bars + kTrnEmpty + dkw);
    }

    // acc[4n + e]: key k0 + r0 + g + 8 (e / 2), column 8n + 2t + (e & 1)
    float* const out = dkw ? dk : dv;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int ki = k0 + r0 + g + 8 * ((i & 2) >> 1);
      const int col = 8 * (i >> 2) + 2 * t + (i & 1);
      if (ki < s.tk && col < s.d)
        out[(static_cast<long long>(bkv) * s.tk + ki) * s.d + col] = acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// dk, dv at the split head dims of multi-head latent attention on wgmma:
// two consumer warpgroups and a producer warpgroup under mbarriers
// ---------------------------------------------------------------------------
//
// Replaces the TPU's `_dkv_kernel` (tinynn_autograd_tpu/ops/attention.py
// :690) at d_qk in (128, 192] with d_v <= 128, zero-padded to 192 and 128
// (Moonlight's 192/128). Its bound at Moonlight's step (2 x 16 heads, 8,192
// causal tokens): 1,375 GFLOP in four products, 8.336 ms at 3xTF32.
// The kernel above does not scale to these dims. At 32-query steps its
// layout needs 254,208 bytes of shared memory (the [query][d] planes
// 81,920, the [d][query] planes 81,920, K and V in fragment order 49,152 +
// 32,768, P 8,192), above the 232,448 a block can use; and its consumer 1
// would hold dK at 64 x 192, 96 accumulator registers a thread and 96 more
// for a step's share. So dK is computed transposed, dK^T += Q^T dS, with
// A = Q^T read from Q's [query][d] planes, which drops Q's [d][query] ones:
// - consumer 0, as above: S^T = K Q^T (m64n32k8, 24 steps over d_qk), P,
//   P_d, and dV += P_d^T dO (m64n64k8 on each half of d_v, dO's [d][query]
//   planes);
// - consumer 1: dP^T = V dO^T (m64n32k8, 16 steps over d_v), dS (P handed
//   over by consumer 0), written split into K-major [key][query] planes,
//   then dK^T += Q^T dS on three 64-row tiles of d_qk (m64n64k8, 4 steps
//   over the queries). Q^T's A fragments are two 8-byte loads a plane from
//   Q's split [query][d] planes: row 16w + g (+ 8) of a tile is column
//   16w + 2g (+ 1) of its 64. Each tile's share (32 registers) is summed
//   apart and added once to dK^T's accumulator (96).
// The work splits evenly: each consumer runs 655,360 MACs a step (x3).
// Q's planes serve S^T and dK^T, so their empty barrier counts both
// consumers' warps; the producer writes a step's dO planes before its Q
// planes, since consumer 1 starts a step with dP^T while Q's planes still
// serve its dK^T of the step before. Shared memory: Q's planes (48 KB),
// dO's [query][d] and [d][query] planes (64 KB), K and V in fragment order
// (80 KB), P (8 KB), dS's planes (16 KB), lse, delta and eight mbarriers:
// 221,504 bytes. Registers: ptxas fits every role in the launch's 168 a
// thread (it does not widen a region for `setmaxnreg`), with no spill
// because dV's share is taken a half of d_v at a time (32 registers, not
// 64) and Q^T's low part is held once, not in a ring of two: its wgmma is
// committed apart, so it is done before the next step's load. The d = 128
// kernel keeps its own code: a producer shared by the two kernels measured
// 10% slower. PERF.md gives the designs reckoned and measured.
namespace dkvs {
constexpr int DQK = 192;           // q's and k's head dims 129-192, padded
constexpr int DV = 128;            // v's up to 128, padded
constexpr int BK = 64;             // keys a block: each consumer's 64 rows
constexpr int BQ = 32;             // queries a step
constexpr int RING = 2;            // K's or V's fragments in flight
constexpr int QPLANE = BQ * DQK;   // floats in one of a step's Q planes
constexpr int OPLANE = BQ * DV;    // in one of its dO planes
constexpr int SPLANE = BK * BQ;    // in one of its dS planes
constexpr int NTHREADS = 384;      // two consumer warpgroups, one producer
// registers a thread at launch and after `setmaxnreg`, as the kernel above
constexpr int ENTRY_REGS = 168, CONSUMER_REGS = 176, PRODUCER_REGS = 152;
static_assert(2 * (CONSUMER_REGS - ENTRY_REGS) <= ENTRY_REGS - PRODUCER_REGS,
              "the consumers take only what the producer gives up");
// float offsets in shared memory: Q's [query][d] planes (hi, lo), dO's
// [query][d] planes, dO's [d][query] planes, K and V in fragment order, P,
// dS's [key][query] planes, lse, delta
constexpr int QNAT = 0, ONAT = 2 * QPLANE, OTRN = ONAT + 2 * OPLANE,
              KS = OTRN + 2 * OPLANE, VS = KS + BK * DQK, PS = VS + BK * DV,
              SS = PS + BK * BQ, LS = SS + 2 * SPLANE, ES = LS + BQ,
              BARS = ES + BQ;
// barriers: Q's planes (with lse) full and empty (the empty one counts
// both consumers' 8 warps), dO's [query][d] planes (with delta), dO's
// [d][query] planes, P's hand-over; the others count 4 warps
enum {
  kQFull = 0, kQEmpty = 1, kOFull = 2, kOEmpty = 3, kTrnFull = 4,
  kTrnEmpty = 5, kPFull = 6, kPEmpty = 7, kBars = 8
};
constexpr size_t SMEM = sizeof(float) * BARS + kBars * sizeof(uint64_t);
static_assert(SMEM <= 232448, "fits an H100 block's shared memory");
// bytes between 8-row groups of core matrices: Q's and dO's [query][d]
// planes, dO's [d][query] planes and dS's [key][query] planes
constexpr unsigned QNAT_STRIDE = (DQK / 4) * 128, ONAT_STRIDE = (DV / 4) * 128,
                   STEP_STRIDE = (BQ / 4) * 128;

// The producer's share of a step's rows of Q or dO (N float4 columns, a
// head dim of 16 N): row `row` (`ok`: it exists) of the head slice at `xh`,
// columns 4 it + cc, zero past `width`.
template <int N>
__device__ __forceinline__ void load_step_rows(float4 (&x)[N],
                                               const float* xh, long long st,
                                               int row, bool ok, int width,
                                               int cc, bool aligned) {
  const float* r = xh + (ok ? row * st : 0);
#pragma unroll
  for (int it = 0; it < N; ++it)
    x[it] = row4(r, 4 * it + cc, width, ok, aligned);
}
// Those rows split into the [query][d] planes at `hi` and hi + plane: row
// 2 si + odd of the core matrix (8-query group j, float4 column c) at word
// (j * 4N + c) * 32 + (2 si + odd) * 4.
template <int N>
__device__ __forceinline__ void store_step_nat(const float4 (&x)[N],
                                               float* hi, int plane, int j,
                                               int si, int odd, int cc) {
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int at = (j * 4 * N + 4 * it + cc) * 32 + (2 * si + odd) * 4;
    uint4 h, l;
    split4(x[it], h, l);
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(hi + plane + at) = l;
  }
}

// sc = x y^T over STEPS steps of 8 in 3xTF32 for a consumer's 64 rows of x
// (K or V in fragment order) against a step's 32 rows of y (Q or dO, split
// [query][d] planes at y_hi and y_hi + plane), the small terms summed apart
// in `sm`; x's fragments read (one 16-byte load) and split a step ahead, in
// a ring of RING
template <int STEPS>
__device__ __forceinline__ void scores(float (&sc)[16], float (&sm)[16],
                                       const float* x, uint64_t y_hi,
                                       uint64_t plane, int lt) {
  constexpr uint64_t kStep = 256 >> 4;  // 8 of K: two cores
  FragA f[RING];
  load_frag(f[0], x, 0, lt);
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    fence_operand(sc[e]);
    fence_operand(sm[e]);
  }
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    const int cur = kk % RING, next = (kk + 1) % RING;
    const uint64_t hi = y_hi + kk * kStep;
    wgmma_fence();
    wgmma_tf32(sm, f[cur].lo, hi, kk > 0);
    wgmma_tf32(sm, f[cur].hi, hi + plane, 1);
    wgmma_tf32(sc, f[cur].hi, hi, kk > 0);
    wgmma_commit();
    if (kk + 1 < STEPS) {
      wgmma_wait<RING - 1>();  // step kk + 1 - RING is done with f[next]
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fence_operand(f[next].hi[e]);
        fence_operand(f[next].lo[e]);
      }
      load_frag(f[next], x, kk + 1, lt);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    fence_operand(sc[e]);
    fence_operand(sm[e]);
  }
#pragma unroll
  for (int c = 0; c < RING; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      fence_operand(f[c].hi[e]);
      fence_operand(f[c].lo[e]);
    }
}

// Thread (w, g, t)'s A fragment of Q^T at query step kk for rows
// [64 m, 64 m + 64) of d_qk, from Q's split [query][d] planes at `hi`: row
// 16w + g (+ 8) of the tile is column 64m + 16w + 2g (+ 1) of Q, so each of
// a0/a1 and a2/a3 is one 8-byte load a plane.
__device__ __forceinline__ void load_qt(unsigned (&ah)[4], unsigned (&al)[4],
                                        const float* hi, int m, int kk, int w,
                                        int g, int t) {
  const int dd = 64 * m + 16 * w + 2 * g;
  const int at = (kk * (DQK / 4) + dd / 4) * 32 + t * 4 + dd % 4;
  const float2 h0 = *reinterpret_cast<const float2*>(hi + at);
  const float2 h1 = *reinterpret_cast<const float2*>(hi + at + 16);
  const float2 l0 = *reinterpret_cast<const float2*>(hi + QPLANE + at);
  const float2 l1 = *reinterpret_cast<const float2*>(hi + QPLANE + at + 16);
  ah[0] = __float_as_uint(h0.x);
  ah[1] = __float_as_uint(h0.y);
  ah[2] = __float_as_uint(h1.x);
  ah[3] = __float_as_uint(h1.y);
  al[0] = __float_as_uint(l0.x);
  al[1] = __float_as_uint(l0.y);
  al[2] = __float_as_uint(l1.x);
  al[3] = __float_as_uint(l1.y);
}

// Consumer 1's 128 threads only (named barrier 1).
__device__ __forceinline__ void sync_consumer1() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}
}  // namespace dkvs

__global__ void __launch_bounds__(dkvs::NTHREADS, 1)
attention_backward_dkv_kernel_wgmma_split(const float* __restrict__ q,
                                          const float* __restrict__ k,
                                          const float* __restrict__ v,
                                          const float* __restrict__ dout,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          float* __restrict__ dk,
                                          float* __restrict__ dv, Shape s,
                                          Strides sq, Strides sk, Strides sv,
                                          Strides sdo, Options opt, int vec) {
  using namespace dkvs;
  extern __shared__ __align__(128) float smem[];
  float* const ks = smem + KS;
  float* const vs = smem + VS;
  float* const ps = smem + PS;
  float* const ls = smem + LS;
  float* const es = smem + ES;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + BARS);

  const int bkv = blockIdx.x;
  const int b = bkv / s.hkv, kvh = bkv % s.hkv;
  const int group = s.h / s.hkv;
  const int k0 = blockIdx.y * BK;

  // the query tiles that see this key tile, for each of the group's heads
  const int nq = (s.tq + BQ - 1) / BQ;
  int i_lo = 0, i_hi = nq - 1;
  if (opt.causal) {
    i_lo = k0 / BQ;
    if (opt.window) i_hi = min(i_hi, (k0 + BK - 1 + opt.window - 1) / BQ);
  }
  const int per_head = max(0, i_hi - i_lo + 1);
  const int steps = group * per_head;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kBars; ++i) mbar_init(bars + i, i == kQEmpty ? 8 : 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // K's and V's rows, raw f32, by all threads, in the order of the
  // consumers' A fragments (`frag_at`)
  {
    const float* kh = k + b * sk.b + kvh * sk.h;
    const float* vh = v + b * sv.b + kvh * sv.h;
    for (int idx = threadIdx.x; idx < BK * (DQK / 4); idx += NTHREADS) {
      const int r = idx / (DQK / 4), c = idx % (DQK / 4);
      const bool ok = k0 + r < s.tk;
      const float4 x =
          row4(kh + (ok ? (k0 + r) * sk.t : 0), c, s.d, ok, vec & kVecK);
      const int at = frag_at(r, 4 * c);
      ks[at] = x.x; ks[at + 4] = x.y; ks[at + 8] = x.z; ks[at + 12] = x.w;
    }
    for (int idx = threadIdx.x; idx < BK * (DV / 4); idx += NTHREADS) {
      const int r = idx / (DV / 4), c = idx % (DV / 4);
      const bool ok = k0 + r < s.tk;
      const float4 x =
          row4(vh + (ok ? (k0 + r) * sv.t : 0), c, s.dv, ok, vec & kVecV);
      const int at = frag_at(r, 4 * c);
      vs[at] = x.x; vs[at + 4] = x.y; vs[at + 8] = x.z; vs[at + 12] = x.w;
    }
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- the producer: dO, Q, delta and lse of each step into the planes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    const int p = threadIdx.x - 256, pw = p / 32, lane = p % 32;
    // lane = 4a + si: the quad a holds rows 8 pw + 2si + odd of float4
    // columns 4 it + cc; each quarter warp's 16-byte stores fill whole bank
    // rows
    const int si = lane & 3, a = lane >> 2;
    const int odd = (a & 1) ^ ((a >> 1) & 1), cc = 2 * (a >> 2) + (a & 1);
    float4 xq[DQK / 16], xo[DV / 16];
    float lv = 0.0f;
    // step u's rows of Q (or dO: `x`, its view, its width and alignment)
    auto load = [&](auto& x, const float* src, const Strides& st, int width,
                    bool aligned, int u) {
      const int gi = u / per_head, q0 = (i_lo + u % per_head) * BQ;
      const int row = q0 + 8 * pw + 2 * si + odd;
      load_step_rows(x, src + b * st.b + (kvh * group + gi) * st.h, st.t,
                     row, row < s.tq, width, cc, aligned);
    };
    // step u's lse (producer threads 0-31) or delta (32-63)
    auto load_stats = [&](int u) {
      const int gi = u / per_head, q0 = (i_lo + u % per_head) * BQ;
      const long long head_row =
          (static_cast<long long>(b) * s.h + kvh * group + gi) * s.tq;
      const int i = p % BQ;
      lv = 0.0f;
      if (p < 2 * BQ && q0 + i < s.tq)
        lv = p < BQ ? lse[head_row + q0 + i] : delta[head_row + q0 + i];
    };
    if (steps > 0) {
      load(xo, dout, sdo, s.dv, vec & kVecDO, 0);
      load(xq, q, sq, s.d, vec & kVecQ, 0);
      load_stats(0);
    }
    // step u's planes go where step u - 1's were, once emptied
    auto emptied = [&](int bar, int u) {
      if (u > 0) mbar_wait(bars + bar, (u - 1) & 1);
    };
    for (int u = 0; u < steps; ++u) {
      emptied(kOEmpty, u);  // dO for dP^T, with delta
      store_step_nat(xo, smem + ONAT, OPLANE, pw, si, odd, cc);
      if (p >= BQ && p < 2 * BQ) es[p - BQ] = lv;
      tinynn::fence_async_shared();
      warp_arrive(bars + kOFull);
      emptied(kQEmpty, u);  // Q for S^T and dK^T, with lse
      store_step_nat(xq, smem + QNAT, QPLANE, pw, si, odd, cc);
      if (p < BQ) ls[p] = lv;
      tinynn::fence_async_shared();
      warp_arrive(bars + kQFull);
      if (u + 1 < steps) {
        load(xq, q, sq, s.d, vec & kVecQ, u + 1);
        load_stats(u + 1);
      }
      // dO's [d][query] planes (column dd of slot 4 odd + i of 8-query
      // group pw at word ((dd / 8) * 8 + 2 pw + odd) * 32 + (dd % 8) * 4 +
      // i, after `quad_transpose`), then its rows of step u + 1
#pragma unroll
      for (int it = 0; it < DV / 16; ++it) quad_transpose(xo[it]);
      emptied(kTrnEmpty, u);  // dO for dV
#pragma unroll
      for (int it = 0; it < DV / 16; ++it) {
        const int dd = 4 * (4 * it + cc) + si;
        const int at =
            ((dd >> 3) * (BQ / 4) + 2 * pw + odd) * 32 + (dd & 7) * 4;
        uint4 h, l;
        split4(xo[it], h, l);
        *reinterpret_cast<uint4*>(smem + OTRN + at) = h;
        *reinterpret_cast<uint4*>(smem + OTRN + OPLANE + at) = l;
      }
      tinynn::fence_async_shared();
      warp_arrive(bars + kTrnFull);
      if (u + 1 < steps) load(xo, dout, sdo, s.dv, vec & kVecDO, u + 1);
    }
  } else if (threadIdx.x < 128) {
    // ---- consumer 0: S^T, P (handed to consumer 1), P_d and dV += P_d^T dO
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    const int lt = threadIdx.x, w = lt / 32, lane = lt % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = 16 * w;
    const unsigned hh = bkv;
    const uint64_t q_d = tinynn::kmajor_desc(smem + QNAT, QNAT_STRIDE);
    const uint64_t z_hi = tinynn::kmajor_desc(smem + OTRN, STEP_STRIDE);
    constexpr uint64_t kQPlane = QPLANE * 4 >> 4;  // descriptor units
    constexpr uint64_t kOPlane = OPLANE * 4 >> 4;
    constexpr uint64_t kStep = 256 >> 4;           // 8 of K: two cores
    constexpr uint64_t kHalf = 8 * STEP_STRIDE >> 4;  // 64 of d_v

    float acc[64];  // dV: acc[4n + e]
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;

    // acc += the step's share of P_d^T dO (m64n64k8 on each half of d_v, 32
    // registers of share at a time): P_d from the score accumulator, dO's
    // [d][query] planes; each share summed apart and added once
    auto outputs = [&](const float (&o)[16]) {
      FragA f[BQ / 8];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
        f[j].set(o[4 * j], o[4 * j + 2], o[4 * j + 1], o[4 * j + 3]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float part[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) fence_operand(part[e]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const uint64_t hi = z_hi + half * kHalf + j * kStep;
          wgmma_tf32(part, f[j].lo, hi, j > 0);
          wgmma_tf32(part, f[j].hi, hi + kOPlane, 1);
          wgmma_tf32(part, f[j].hi, hi, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          fence_operand(part[e]);
          acc[32 * half + e] += part[e];
        }
      }
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(f[j].hi[e]);
          fence_operand(f[j].lo[e]);
        }
    };

    int handed = 0;  // P's hand-overs so far
    for (int u = 0; u < steps; ++u) {
      const unsigned parity = u & 1;
      const int gi = u / per_head, q0 = (i_lo + u % per_head) * BQ;
      const int vis = band(q0, q0 + BQ - 1, k0, k0 + BK - 1, s, opt);
      const unsigned seed = opt.seed + static_cast<unsigned>(gi) * GOLDEN;
      // element i = 4j + e of the score accumulator: key k0 + r0 + g +
      // 8 (e / 2), query q0 + 8j + 2t + (e & 1)
      float o[16];
      mbar_wait(bars + kQFull, parity);
      if (vis) {
        float sm[16];
        scores<DQK / 8>(o, sm, ks, q_d, kQPlane, lt);
        // P in place of S^T (masked pairs 0), handed to consumer 1; then
        // P_d (a tile the masks leave whole takes a loop without a branch
        // an element, so that its exponentials interleave)
        if (vis == 2) {
#pragma unroll
          for (int i = 0; i < 16; ++i)
            o[i] = expf((o[i] + sm[i]) * opt.scale -
                        ls[8 * (i >> 2) + 2 * t + (i & 1)]);
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int ki = k0 + r0 + g + 8 * ((i & 2) >> 1);
            const int col = 8 * (i >> 2) + 2 * t + (i & 1);
            float pv = 0.0f;
            if (visible(q0 + col, ki, s, opt))
              pv = expf((o[i] + sm[i]) * opt.scale - ls[col]);
            o[i] = pv;
          }
        }
        if (handed > 0) mbar_wait(bars + kPEmpty, (handed - 1) & 1);
#pragma unroll
        for (int i = 0; i < 16; ++i) ps[i * 128 + lt] = o[i];
        warp_arrive(bars + kPFull);
        if (opt.dropout) {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int ki = k0 + r0 + g + 8 * ((i & 2) >> 1);
            const int qi = q0 + 8 * (i >> 2) + 2 * t + (i & 1);
            if (o[i] != 0.0f)
              o[i] = keep(hh, qi, ki, s, seed, opt.thresh) ? o[i] * opt.inv
                                                           : 0.0f;
          }
        }
      }
      warp_arrive(bars + kQEmpty);
      mbar_wait(bars + kTrnFull, parity);
      if (vis) {
        outputs(o);
        ++handed;
      }
      warp_arrive(bars + kTrnEmpty);
    }

    // acc[4n + e]: key k0 + r0 + g + 8 (e / 2), column 8n + 2t + (e & 1)
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int ki = k0 + r0 + g + 8 * ((i & 2) >> 1);
      const int col = 8 * (i >> 2) + 2 * t + (i & 1);
      if (ki < s.tk && col < s.dv)
        dv[(static_cast<long long>(bkv) * s.tk + ki) * s.dv + col] = acc[i];
    }
  } else {
    // ---- consumer 1: dP^T, dS (with P from consumer 0) into dS's planes,
    // and dK^T += Q^T dS
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    const int lt = threadIdx.x - 128, w = lt / 32, lane = lt % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = 16 * w;
    const unsigned hh = bkv;
    const uint64_t o_d = tinynn::kmajor_desc(smem + ONAT, ONAT_STRIDE);
    const uint64_t ds_d = tinynn::kmajor_desc(smem + SS, STEP_STRIDE);
    constexpr uint64_t kOPlane = OPLANE * 4 >> 4;  // descriptor units
    constexpr uint64_t kSPlane = SPLANE * 4 >> 4;
    constexpr uint64_t kStep = 256 >> 4;           // 8 of K: two cores
    const float* const qnat = smem + QNAT;
    float* const ss = smem + SS;

    float acc[96];  // dK^T: tile m's acc[32m + 4n + e]
#pragma unroll
    for (int e = 0; e < 96; ++e) acc[e] = 0.0f;

    // acc += the step's share of Q^T dS, tile by tile of 64 rows of d_qk
    // (m64n64k8, 4 steps over the queries): Q^T's fragments from Q's planes
    // a step ahead, dS's [key][query] planes; each tile's share summed apart
    // and added once
    auto dk_tiles = [&]() {
#pragma unroll
      for (int m = 0; m < DQK / 64; ++m) {
        float part[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) fence_operand(part[e]);
        // Q^T's fragments: the high parts in a ring of two, the low part
        // alone, its wgmma committed apart so that it is done first
        unsigned fh[2][4], fl[4];
        load_qt(fh[0], fl, qnat, m, 0, w, g, t);
#pragma unroll
        for (int kk = 0; kk < BQ / 8; ++kk) {
          const int cur = kk & 1;
          const uint64_t hi = ds_d + kk * kStep;
          wgmma_fence();
          wgmma_tf32(part, fl, hi, kk > 0);
          wgmma_commit();
          wgmma_tf32(part, fh[cur], hi + kSPlane, 1);
          wgmma_tf32(part, fh[cur], hi, 1);
          wgmma_commit();
          if (kk + 1 < BQ / 8) {
            wgmma_wait<1>();  // fl's wgmma and step kk - 1's are done
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              fence_operand(fh[cur ^ 1][e]);
              fence_operand(fl[e]);
            }
            load_qt(fh[cur ^ 1], fl, qnat, m, kk + 1, w, g, t);
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          fence_operand(part[e]);
          acc[32 * m + e] += part[e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(fh[0][e]);
          fence_operand(fh[1][e]);
          fence_operand(fl[e]);
        }
      }
    };

    int handed = 0;  // P's hand-overs so far
    for (int u = 0; u < steps; ++u) {
      const unsigned parity = u & 1;
      const int gi = u / per_head, q0 = (i_lo + u % per_head) * BQ;
      const int vis = band(q0, q0 + BQ - 1, k0, k0 + BK - 1, s, opt);
      const unsigned seed = opt.seed + static_cast<unsigned>(gi) * GOLDEN;
      // element i = 4j + e of the score accumulator: key k0 + r0 + g +
      // 8 (e / 2), query q0 + 8j + 2t + (e & 1)
      float o[16];
      mbar_wait(bars + kOFull, parity);
      if (vis) {
        float sm[16];
        scores<DV / 8>(o, sm, vs, o_d, kOPlane, lt);
        // dS in place of dP^T
        mbar_wait(bars + kPFull, handed & 1);
        if (vis == 2 && !opt.dropout) {
#pragma unroll
          for (int i = 0; i < 16; ++i)
            o[i] = ps[i * 128 + lt] *
                   (o[i] + sm[i] - es[8 * (i >> 2) + 2 * t + (i & 1)]) *
                   opt.scale;
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int ki = k0 + r0 + g + 8 * ((i & 2) >> 1);
            const int col = 8 * (i >> 2) + 2 * t + (i & 1);
            const int qi = q0 + col;
            float ds = 0.0f;
            if (vis == 2 || visible(qi, ki, s, opt)) {
              const float pv = ps[i * 128 + lt];
              float d = o[i] + sm[i];
              if (opt.dropout)
                d = keep(hh, qi, ki, s, seed, opt.thresh) ? d * opt.inv
                                                          : 0.0f;
              ds = pv * (d - es[col]) * opt.scale;
            }
            o[i] = ds;
          }
        }
        warp_arrive(bars + kPEmpty);
      }
      warp_arrive(bars + kOEmpty);
      if (vis) {
        // dS split into its [key][query] planes: key 16w + g (+ 8), queries
        // 8j + 2t and + 1 at word ((key / 8) * 8 + q / 4) * 32 + (key % 8) *
        // 4 + q % 4, once the warpgroup's last dK^T no longer reads them
        sync_consumer1();
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          const int key = r0 + g + 8 * ((i & 2) >> 1);
          const int qq = 8 * (i >> 2) + 2 * t;
          const int at = ((key >> 3) * (BQ / 4) + (qq >> 2)) * 32 +
                         (key & 7) * 4 + (qq & 3);
          uint2 h, l;
          split_tf32(o[i], h.x, l.x);
          split_tf32(o[i + 1], h.y, l.y);
          *reinterpret_cast<uint2*>(ss + at) = h;
          *reinterpret_cast<uint2*>(ss + SPLANE + at) = l;
        }
        tinynn::fence_async_shared();
        sync_consumer1();
      }
      mbar_wait(bars + kQFull, parity);
      if (vis) {
        dk_tiles();
        ++handed;
      }
      warp_arrive(bars + kQEmpty);
    }

    // acc[32m + 4n + e]: column 64m + 16w + 2g + e / 2 of dk, key k0 + 8n +
    // 2t + (e & 1)
#pragma unroll
    for (int i = 0; i < 96; ++i) {
      const int col = 64 * (i >> 5) + 16 * w + 2 * g + ((i & 2) >> 1);
      const int ki = k0 + 8 * ((i & 31) >> 2) + 2 * t + (i & 1);
      if (ki < s.tk && col < s.d)
        dk[(static_cast<long long>(bkv) * s.tk + ki) * s.d + col] = acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// dq at head dims 65-128 on wgmma: two consumer warpgroups and two
// producer warpgroups under mbarriers
// ---------------------------------------------------------------------------
//
// The dk/dv kernel above with the operands' roles swapped. One block per
// (b*H + h, 128-query tile), 512 threads, one block an SM, the heaviest
// causal tiles first (as the template). It walks the 32-key steps that the
// block's queries can see. Each consumer warpgroup owns 64 of the queries,
// 16 a warp as in `mma.sync`, with their lse and delta in registers, and
// runs all three products on them as `wgmma` in 3xTF32 (m64nNk8 TF32, A in
// registers): S = Q K^T and dP = dO V^T in one loop (m64n32k8, 16 steps
// over d), P in place of S and dS in place of dP; dQ += dS K (m64n64k8 on
// each half of d, 4 steps over the keys).
// Q's and dO's A fragments are read from raw f32 copies in fragment order
// (one 16-byte load) and split in registers a step ahead of their wgmmas; B
// is the step's K or V in K-major [key][d] TF32 planes; the small terms are
// summed apart. For dQ, A is dS straight from the score accumulators
// (columns 2t and 2t + 1 as slots t and t + 4); B is K in K-major [d][key]
// planes whose keys are stored in that slot order (TF32 wgmma takes only
// K-major operands, hence the second copy); each step's share of a half
// (32 registers a thread) is summed apart and added once to the f32
// accumulator (64), which is written to dq once, at the end.
// The producers read each step's K and V rows (16-byte loads where the rows
// are 16-byte aligned, else 4-byte; zero past T and d), split them and
// write K's and V's [key][d] planes, then, after `quad_transpose`, K's
// [d][key] planes; each producer warpgroup takes 16 of the 32 keys. Both
// consumers read the same planes, so each split serves 128 queries.
// Shared memory: Q and dO in fragment order (128 KB), the six planes of a
// step (96 KB) and four mbarriers: 229,408 bytes, no room for a second
// stage. Refills are staggered by plane set instead: the [key][d] planes
// are free once both consumers have S and dP, K's [d][key] ones once they
// have dQ; each set has a full and an empty barrier, so the producer writes
// step u + 1's [key][d] planes while the consumers still run step u's dQ.
// Registers: 184 a consumer thread, 72 a producer thread, from the 128 of
// 512 threads; a second producer warpgroup halves what a producer thread
// holds (8 float4 of K and V), which is what lets the consumers have 184.
// PERF.md gives the designs measured on the way (S and dP in separate
// loops; one m64n128k8 dQ share; one producer warpgroup at 176/152 and
// 184/136; consumer 0 on S and P with consumer 1 on dP, dS and dQ in
// 64-query blocks).
namespace dqw {
constexpr int D = 128;         // head dims 65-128, zero-padded
constexpr int BQ = 128;        // queries a block: 64 a consumer
constexpr int BK = 32;         // keys a step
constexpr int RING = 2;        // Q's or dO's fragments in flight
constexpr int PLANE = BK * D;  // floats in one plane of a step
constexpr int NTHREADS = 512;  // two consumer warpgroups, two producers
// registers a thread: 128 at launch (512 threads an SM), then the producers
// give up what the consumers take (`setmaxnreg`)
constexpr int ENTRY_REGS = 128, CONSUMER_REGS = 184, PRODUCER_REGS = 72;
static_assert(CONSUMER_REGS - ENTRY_REGS <= ENTRY_REGS - PRODUCER_REGS,
              "the consumers take only what the producers give up");
// float offsets in shared memory: the [key][d] planes K hi, K lo, V hi,
// V lo, the [d][key] planes K hi, K lo, then Q and dO, consumer c's 64 rows
// of each at + 64 c D
constexpr int NAT = 0, TRN = 4 * PLANE, QS = 6 * PLANE, DOS = QS + BQ * D,
              BARS = DOS + BQ * D;
// barriers: full (the producers' 8 warps arrive) and empty (the consumers'
// 8 warps arrive) for K's and V's [key][d] planes, and for K's [d][key]
// planes
enum { kNatFull = 0, kTrnFull = 1, kNatEmpty = 2, kTrnEmpty = 3, kBars = 4 };
constexpr size_t SMEM = sizeof(float) * BARS + kBars * sizeof(uint64_t);
// bytes between 8-row groups of core matrices: [key][d] and [d][key]
constexpr unsigned NAT_STRIDE = (D / 4) * 128, TRN_STRIDE = (BK / 4) * 128;
}  // namespace dqw

__global__ void __launch_bounds__(dqw::NTHREADS, 1)
attention_backward_dq_kernel_wgmma(const float* __restrict__ q,
                                   const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   const float* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   float* __restrict__ dq, Shape s,
                                   Strides sq, Strides sk, Strides sv,
                                   Strides sdo, Options opt, int vec) {
  using namespace dqw;
  extern __shared__ __align__(128) float smem[];
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + BARS);

  const int bh = blockIdx.x;
  const int b = bh / s.h, h = bh % s.h;
  const int group = s.h / s.hkv, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  int j_lo, j_hi;
  key_range<BQ, BK>(q0, s, opt, &j_lo, &j_hi);
  const int steps = j_hi - j_lo + 1;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kBars; ++i) mbar_init(bars + i, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q's and dO's rows, raw f32, by all threads, in the order of the
  // consumers' A fragments (`frag_at`)
  {
    const float* qh = q + b * sq.b + h * sq.h;
    const float* oh = dout + b * sdo.b + h * sdo.h;
    for (int idx = threadIdx.x; idx < BQ * (D / 4); idx += NTHREADS) {
      const int r = idx / (D / 4), c = idx % (D / 4);
      const bool ok = q0 + r < s.tq;
      const float4 xq =
          row4(qh + (ok ? (q0 + r) * sq.t : 0), c, s.d, ok, vec & kVecQ);
      const float4 xo =
          row4(oh + (ok ? (q0 + r) * sdo.t : 0), c, s.d, ok, vec & kVecDO);
      const int at = (r / 64) * 64 * D + frag_at(r % 64, 4 * c);
      float* const qs = smem + QS + at;
      float* const os = smem + DOS + at;
      qs[0] = xq.x; qs[4] = xq.y; qs[8] = xq.z; qs[12] = xq.w;
      os[0] = xo.x; os[4] = xo.y; os[8] = xo.z; os[12] = xo.w;
    }
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- the producers: K and V of each step into the planes, each warp
    // half the columns of one 8-key group
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    const int p = threadIdx.x - 256, pw = p / 32, lane = p % 32;
    // lane = 4a + si: the quad a holds rows 8j + 2si + odd of float4 column
    // c0 + cc; each quarter warp's 16-byte stores fill whole bank rows
    const int si = lane & 3, a = lane >> 2;
    const int odd = (a & 1) ^ ((a >> 1) & 1), cc = 2 * (a >> 2) + (a & 1);
    const float* kh = k + b * sk.b + kvh * sk.h;
    const float* vh = v + b * sv.b + kvh * sv.h;
    float4 xk[4], xv[4];
    // step u's rows of K (or V: `x`, its head, row stride and alignment)
    auto load = [&](float4 (&x)[4], const float* xh, long long st,
                    bool aligned, int u) {
      const int k0 = (j_lo + u) * BK;
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int wt = pw * 4 + it, j = wt >> 3, c = (wt & 7) * 4 + cc;
        const int row = k0 + 8 * j + 2 * si + odd;
        const bool ok = row < s.tk;
        x[it] = row4(xh + (ok ? row * st : 0), c, s.d, ok, aligned);
      }
    };
    load(xk, kh, sk.t, vec & kVecK, 0);
    load(xv, vh, sv.t, vec & kVecV, 0);
    // x's [key][d] planes at `hi` (row r at word ((r / 8) * 32 + c) * 32 +
    // (r % 8) * 4), then its [d][key] ones (column dd of slot 4 odd + i of
    // 8-key step j at word ((dd / 8) * 8 + 2 j + odd) * 32 + (dd % 8) * 4 +
    // i, after `quad_transpose`)
    auto store_nat = [&](const float4 (&x)[4], float* hi) {
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int wt = pw * 4 + it, j = wt >> 3, c = (wt & 7) * 4 + cc;
        const int at = (j * (D / 4) + c) * 32 + (2 * si + odd) * 4;
        uint4 h, l;
        split4(x[it], h, l);
        *reinterpret_cast<uint4*>(hi + at) = h;
        *reinterpret_cast<uint4*>(hi + PLANE + at) = l;
      }
    };
    auto store_trn = [&](const float4 (&x)[4], float* hi) {
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int wt = pw * 4 + it, j = wt >> 3, c = (wt & 7) * 4 + cc;
        const int dd = 4 * c + si;
        const int at =
            ((dd >> 3) * (BK / 4) + 2 * j + odd) * 32 + (dd & 7) * 4;
        uint4 h, l;
        split4(x[it], h, l);
        *reinterpret_cast<uint4*>(hi + at) = h;
        *reinterpret_cast<uint4*>(hi + PLANE + at) = l;
      }
    };
    // step u's planes go where step u - 1's were, once emptied
    auto emptied = [&](int bar, int u) {
      if (u > 0) mbar_wait(bars + bar, (u - 1) & 1);
    };
    for (int u = 0; u < steps; ++u) {
      emptied(kNatEmpty, u);  // K and V for S and dP
      store_nat(xk, smem + NAT);
      store_nat(xv, smem + NAT + 2 * PLANE);
      tinynn::fence_async_shared();
      warp_arrive(bars + kNatFull);
      if (u + 1 < steps) load(xv, vh, sv.t, vec & kVecV, u + 1);
#pragma unroll
      for (int it = 0; it < 4; ++it) quad_transpose(xk[it]);
      emptied(kTrnEmpty, u);  // K for dQ
      store_trn(xk, smem + TRN);
      tinynn::fence_async_shared();
      warp_arrive(bars + kTrnFull);
      if (u + 1 < steps) load(xk, kh, sk.t, vec & kVecK, u + 1);
    }
  } else {
    // ---- the consumers: warpgroup c owns queries q0 + 64c .. q0 + 64c + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    const int c = threadIdx.x / 128;
    const int lt = threadIdx.x % 128, w = lt / 32, lane = lt % 32;
    const int g = lane / 4, t = lane % 4;
    const int qc = q0 + 64 * c;
    // this thread's two rows, g and g + 8 of its warp's 16
    const int qa = qc + 16 * w + g, qb = qa + 8;
    const long long rowa = static_cast<long long>(bh) * s.tq + qa;
    const long long rowb = rowa + 8;
    const float la = qa < s.tq ? lse[rowa] : 0.0f;
    const float lb = qb < s.tq ? lse[rowb] : 0.0f;
    const float da = qa < s.tq ? delta[rowa] : 0.0f;
    const float db = qb < s.tq ? delta[rowb] : 0.0f;
    const unsigned hh = b * s.hkv + kvh;
    const unsigned seed = opt.seed + static_cast<unsigned>(h % group) * GOLDEN;
    const float* const xq = smem + QS + c * 64 * D;
    const float* const xo = smem + DOS + c * 64 * D;
    const uint64_t nat_d = tinynn::kmajor_desc(smem + NAT, NAT_STRIDE);
    const uint64_t trn_d = tinynn::kmajor_desc(smem + TRN, TRN_STRIDE);
    constexpr uint64_t kPlane = PLANE * 4 >> 4;      // descriptor units
    constexpr uint64_t kStep = 256 >> 4;             // 8 of K: two cores
    constexpr uint64_t kHalf = 8 * TRN_STRIDE >> 4;  // 64 of d

    float acc[64];  // dQ: acc[4n + e]
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;

    // S = Q K^T and dP = dO V^T over d (16 steps of 8) in 3xTF32, in one
    // loop so that both products' wgmmas are in flight together, for the
    // warpgroup's 64 queries against a step's 32 keys (K's planes at nat_d
    // and nat_d + kPlane, V's two planes on), the small terms summed apart
    // in `sm` and `dm`; Q's and dO's fragments are read (one 16-byte load
    // each) and split a step ahead, in rings of RING so that RING steps'
    // wgmmas can be in flight
    auto scores = [&](float (&sc)[16], float (&sm)[16], float (&dp)[16],
                      float (&dm)[16]) {
      FragA fq[RING], fo[RING];
      load_frag(fq[0], xq, 0, lt);
      load_frag(fo[0], xo, 0, lt);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        fence_operand(sc[e]);
        fence_operand(sm[e]);
        fence_operand(dp[e]);
        fence_operand(dm[e]);
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int cur = kk % RING, next = (kk + 1) % RING;
        const uint64_t kd = nat_d + kk * kStep, vd = kd + 2 * kPlane;
        wgmma_fence();
        wgmma_tf32(sm, fq[cur].lo, kd, kk > 0);
        wgmma_tf32(sm, fq[cur].hi, kd + kPlane, 1);
        wgmma_tf32(sc, fq[cur].hi, kd, kk > 0);
        wgmma_tf32(dm, fo[cur].lo, vd, kk > 0);
        wgmma_tf32(dm, fo[cur].hi, vd + kPlane, 1);
        wgmma_tf32(dp, fo[cur].hi, vd, kk > 0);
        wgmma_commit();
        if (kk + 1 < D / 8) {
          wgmma_wait<RING - 1>();  // step kk + 1 - RING is done with `next`
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            fence_operand(fq[next].hi[e]);
            fence_operand(fq[next].lo[e]);
            fence_operand(fo[next].hi[e]);
            fence_operand(fo[next].lo[e]);
          }
          load_frag(fq[next], xq, kk + 1, lt);
          load_frag(fo[next], xo, kk + 1, lt);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        fence_operand(sc[e]);
        fence_operand(sm[e]);
        fence_operand(dp[e]);
        fence_operand(dm[e]);
      }
#pragma unroll
      for (int r = 0; r < RING; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(fq[r].hi[e]);
          fence_operand(fq[r].lo[e]);
          fence_operand(fo[r].hi[e]);
          fence_operand(fo[r].lo[e]);
        }
    };

    // acc += the step's share of ds K (m64n64k8 over each half of d, 32
    // registers of share at a time): ds from a score accumulator, K's
    // [d][key] planes; each share summed apart and added once
    auto outputs = [&](const float (&ds)[16]) {
      FragA f[BK / 8];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        f[j].set(ds[4 * j], ds[4 * j + 2], ds[4 * j + 1], ds[4 * j + 3]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float part[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) fence_operand(part[e]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const uint64_t hi = trn_d + half * kHalf + j * kStep;
          wgmma_tf32(part, f[j].lo, hi, j > 0);
          wgmma_tf32(part, f[j].hi, hi + kPlane, 1);
          wgmma_tf32(part, f[j].hi, hi, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          fence_operand(part[e]);
          acc[32 * half + e] += part[e];
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(f[j].hi[e]);
          fence_operand(f[j].lo[e]);
        }
    };

    for (int u = 0; u < steps; ++u) {
      const unsigned parity = u & 1;
      const int k0 = (j_lo + u) * BK;
      const int vis = band(qc, qc + 63, k0, k0 + BK - 1, s, opt);
      // element i = 4j + e of a score accumulator: query (e < 2 ? qa : qb),
      // key k0 + 8j + 2t + (e & 1)
      float sc[16], dp[16];
      {
        float sm[16], dm[16];
        mbar_wait(bars + kNatFull, parity);
        if (vis) scores(sc, sm, dp, dm);
        warp_arrive(bars + kNatEmpty);
        // P in place of S, masked pairs 0 (a tile the masks leave whole
        // takes a loop without a branch an element, so that its
        // exponentials interleave)
        if (vis == 2) {
#pragma unroll
          for (int i = 0; i < 16; ++i)
            sc[i] = expf((sc[i] + sm[i]) * opt.scale - ((i & 2) ? lb : la));
        } else if (vis) {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int qi = (i & 2) ? qb : qa;
            const int ki = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            float pv = 0.0f;
            if (visible(qi, ki, s, opt))
              pv = expf((sc[i] + sm[i]) * opt.scale - ((i & 2) ? lb : la));
            sc[i] = pv;
          }
        }
        // dS in place of dP
        if (vis == 2 && !opt.dropout) {
#pragma unroll
          for (int i = 0; i < 16; ++i)
            dp[i] = sc[i] * (dp[i] + dm[i] - ((i & 2) ? db : da)) * opt.scale;
        } else if (vis) {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int qi = (i & 2) ? qb : qa;
            const int ki = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            float ds = 0.0f;
            if (vis == 2 || visible(qi, ki, s, opt)) {
              float d = dp[i] + dm[i];
              if (opt.dropout)
                d = keep(hh, qi, ki, s, seed, opt.thresh) ? d * opt.inv
                                                          : 0.0f;
              ds = sc[i] * (d - ((i & 2) ? db : da)) * opt.scale;
            }
            dp[i] = ds;
          }
        }
      }
      mbar_wait(bars + kTrnFull, parity);
      if (vis) outputs(dp);
      warp_arrive(bars + kTrnEmpty);
    }

    // acc[4n + e]: query (e < 2 ? qa : qb), column 8n + 2t + (e & 1)
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int qi = (i & 2) ? qb : qa;
      const int col = 8 * (i >> 2) + 2 * t + (i & 1);
      if (qi < s.tq && col < s.d)
        dq[((i & 2) ? rowb : rowa) * s.d + col] = acc[i];
    }
  }
}

// The forward block: Q's [BM][P] rows and two stages of K and V tiles,
// 52,224 bytes at d=64 (three blocks an SM, as the registers allow);
// 134,144 at 192/128.
template <int D, int DV>
constexpr size_t forward_smem() {
  return sizeof(float) * ((BM + 2 * BN) * pitch<D>() + 2 * BN * pitch<DV>());
}
// The backward blocks: two resident [BM][P] operands and two stages of two
// looped [BN][P] ones; in dk/dv also the looped operands' low planes and
// two stages of lse and delta. 69,632 and 87,552 bytes at d=64: three dq
// blocks an SM, two dk/dv blocks; dq 167,936 at 192/128.
template <int D, int DV>
constexpr size_t dq_smem() {
  return sizeof(float) * (BM + 2 * BN) * (pitch<D>() + pitch<DV>());
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((2 * BM + 6 * BN) * pitch<D>() + 4 * BN);
}
static_assert(forward_smem<192, 128>() <= 232448 &&
                  dq_smem<192, 128>() <= 232448,
              "the split kernels fit an H100 block's shared memory");

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

template <int D, int DV = D>
cudaError_t launch_forward(const float* q, const float* k, const float* v,
                           float* o, float* lse, const Shape& s,
                           const Strides& sq, const Strides& sk,
                           const Strides& sv, const Options& opt,
                           cudaStream_t stream) {
  static bool done = false;
  const size_t bytes = forward_smem<D, DV>();
  cudaError_t err = allow_smem(attention_forward_kernel<D, DV>, bytes, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.h, (s.tq + BM - 1) / BM);
  attention_forward_kernel<D, DV><<<grid, THREADS, bytes, stream>>>(
      q, k, v, o, lse, s, sq, sk, sv, opt,
      vec_flags(q, k, v, q, sq, sk, sv, sq));
  return cudaGetLastError();
}

template <int D, int DV = D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* delta,
                      float* dq, const Shape& s, const Strides& sq,
                      const Strides& sk, const Strides& sv,
                      const Strides& sdo, const Options& opt,
                      cudaStream_t stream) {
  static bool done = false;
  const size_t bytes = dq_smem<D, DV>();
  cudaError_t err =
      allow_smem(attention_backward_dq_kernel<D, DV>, bytes, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.h, (s.tq + BM - 1) / BM);
  attention_backward_dq_kernel<D, DV><<<grid, THREADS, bytes, stream>>>(
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
  cudaError_t err = allow_smem(attention_backward_dkv_kernel<D>, bytes, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.hkv, (s.tk + BM - 1) / BM);
  attention_backward_dkv_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, s, sq, sk, sv, sdo, opt,
      vec_flags(q, k, v, dout, sq, sk, sv, sdo));
  return cudaGetLastError();
}

cudaError_t launch_dq_wgmma(const float* q, const float* k, const float* v,
                            const float* dout, const float* lse,
                            const float* delta, float* dq, const Shape& s,
                            const Strides& sq, const Strides& sk,
                            const Strides& sv, const Strides& sdo,
                            const Options& opt, cudaStream_t stream) {
  static bool done = false;
  cudaError_t err =
      allow_smem(attention_backward_dq_kernel_wgmma, dqw::SMEM, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.h, (s.tq + dqw::BQ - 1) / dqw::BQ);
  attention_backward_dq_kernel_wgmma<<<grid, dqw::NTHREADS, dqw::SMEM,
                                       stream>>>(
      q, k, v, dout, lse, delta, dq, s, sq, sk, sv, sdo, opt,
      vec_flags(q, k, v, dout, sq, sk, sv, sdo));
  return cudaGetLastError();
}

cudaError_t launch_dkv_wgmma(const float* q, const float* k, const float* v,
                             const float* dout, const float* lse,
                             const float* delta, float* dk, float* dv,
                             const Shape& s, const Strides& sq,
                             const Strides& sk, const Strides& sv,
                             const Strides& sdo, const Options& opt,
                             cudaStream_t stream) {
  static bool done = false;
  cudaError_t err =
      allow_smem(attention_backward_dkv_kernel_wgmma, dkvw::SMEM, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.hkv, (s.tk + dkvw::BK - 1) / dkvw::BK);
  attention_backward_dkv_kernel_wgmma<<<grid, dkvw::NTHREADS, dkvw::SMEM,
                                        stream>>>(
      q, k, v, dout, lse, delta, dk, dv, s, sq, sk, sv, sdo, opt,
      vec_flags(q, k, v, dout, sq, sk, sv, sdo));
  return cudaGetLastError();
}

cudaError_t launch_dkv_wgmma_split(const float* q, const float* k,
                                   const float* v, const float* dout,
                                   const float* lse, const float* delta,
                                   float* dk, float* dv, const Shape& s,
                                   const Strides& sq, const Strides& sk,
                                   const Strides& sv, const Strides& sdo,
                                   const Options& opt, cudaStream_t stream) {
  static bool done = false;
  cudaError_t err = allow_smem(attention_backward_dkv_kernel_wgmma_split,
                               dkvs::SMEM, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * s.hkv, (s.tk + dkvs::BK - 1) / dkvs::BK);
  attention_backward_dkv_kernel_wgmma_split<<<grid, dkvs::NTHREADS,
                                              dkvs::SMEM, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, s, sq, sk, sv, sdo, opt,
      vec_flags(q, k, v, dout, sq, sk, sv, sdo));
  return cudaGetLastError();
}

// The split head dims: q and k wider than 128 and at most 192, v at most
// 128 (each zero-padded in shared memory to 192 and 128).
bool split_dims(int d, int dv) {
  return d > 128 && d <= 192 && dv >= 1 && dv <= 128;
}

}  // namespace

// Each entry point launches on `stream` and does not synchronise. q is
// [b, h, tq, d], k [b, hkv, tk, d], v [b, hkv, tk, dv], dout like o, each
// given by its (batch, head, row) element strides with a unit-stride head
// dim; o [b, h, tq, dv], dq [b, h, tq, d], dk [b, hkv, tk, d], dv
// [b, hkv, tk, dv], lse and delta [b, h, tq] are contiguous. window 0 means
// none; dropout 0 means none. The head dims: d == dv <= 128, or the split
// dims d in (128, 192] with dv <= 128 (the forward's and dq's <192, 128>
// templates, the split dk/dv wgmma kernel); any other pair is
// cudaErrorInvalidValue. Returns the CUDA error of the launch (0
// when it was accepted). The dq and dk/dv entries take their design from
// the caller (`dq_design` and `dkv_design` in ops/attention.py): wgmma 1
// launches the wgmma kernel (dq: d == dv up to 128, zero-padded; dk/dv:
// d == dv up to 128, or the split dims), 0 the template of d <= 32, d <= 64
// or, in dq, the split dims (another pair is cudaErrorInvalidValue).

extern "C" int tinynn_attention_forward(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int h, int hkv, int tq, int tk, int d, int dv, long long sqb,
    long long sqh, long long sqt, long long skb, long long skh, long long skt,
    long long svb, long long svh, long long svt, float scale, int causal,
    int window, int dropout, unsigned thresh, float inv, unsigned seed,
    void* stream) {
  const Shape s{b, h, hkv, tq, tk, d, dv};
  const Strides sq{sqb, sqh, sqt}, sk{skb, skh, skt}, sv{svb, svh, svt};
  const Options opt{scale, causal, window, dropout, thresh, inv, seed};
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dv != d)
    err = split_dims(d, dv) ? launch_forward<192, 128>(qf, kf, vf, of, lf, s,
                                                       sq, sk, sv, opt, st)
                            : cudaErrorInvalidValue;
  else if (d <= 32)
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
    int tq, int tk, int d, int dv, long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt, long long svb,
    long long svh, long long svt, long long sdb, long long sdh,
    long long sdt, float scale, int causal, int window, int dropout,
    unsigned thresh, float inv, unsigned seed, int wgmma, void* stream) {
  const Shape s{b, h, hkv, tq, tk, d, dv};
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
  if (dv != d)
    err = !wgmma && split_dims(d, dv)
              ? launch_dq<192, 128>(qf, kf, vf, df, lf, ef, gf, s, sq, sk, sv,
                                    sdo, opt, st)
              : cudaErrorInvalidValue;
  else if (d > 128)
    err = cudaErrorInvalidValue;
  else if (wgmma)
    err = launch_dq_wgmma(qf, kf, vf, df, lf, ef, gf, s, sq, sk, sv, sdo, opt,
                          st);
  else if (d <= 32)
    err = launch_dq<32>(qf, kf, vf, df, lf, ef, gf, s, sq, sk, sv, sdo, opt,
                        st);
  else if (d <= 64)
    err = launch_dq<64>(qf, kf, vf, df, lf, ef, gf, s, sq, sk, sv, sdo, opt,
                        st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int tinynn_attention_backward_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dvo, int b, int h,
    int hkv, int tq, int tk, int d, int dv, long long sqb, long long sqh,
    long long sqt, long long skb, long long skh, long long skt,
    long long svb, long long svh, long long svt, long long sdb,
    long long sdh, long long sdt, float scale, int causal, int window,
    int dropout, unsigned thresh, float inv, unsigned seed, int wgmma,
    void* stream) {
  const Shape s{b, h, hkv, tq, tk, d, dv};
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
  auto* vg = static_cast<float*>(dvo);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dv != d)
    err = wgmma && split_dims(d, dv)
              ? launch_dkv_wgmma_split(qf, kf, vf, df, lf, ef, kg, vg, s, sq,
                                       sk, sv, sdo, opt, st)
              : cudaErrorInvalidValue;
  else if (d > 128)
    err = cudaErrorInvalidValue;
  else if (wgmma)
    err = launch_dkv_wgmma(qf, kf, vf, df, lf, ef, kg, vg, s, sq, sk, sv, sdo,
                           opt, st);
  else if (d <= 32)
    err = launch_dkv<32>(qf, kf, vf, df, lf, ef, kg, vg, s, sq, sk, sv, sdo,
                         opt, st);
  else if (d <= 64)
    err = launch_dkv<64>(qf, kf, vf, df, lf, ef, kg, vg, s, sq, sk, sv, sdo,
                         opt, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
