// The in-kernel gradient exchange for ranks that share one card: the device
// code of P3 (csrc/ring_allreduce.cu, the all-reduce alone) and of K6, the
// exchange phase of the ranked whole-epoch kernel (csrc/fused_epoch.cu).
//
// Replaces `grad_ring_all_reduce` (tinynn_autograd_tpu/ops/fused_epoch.py:
// 114) and the ring kernel of tests/test_dp_megakernel.py:36. There each
// TPU device of a mesh axis runs the kernel on its own batch shard and
// sums its gradients with its neighbours' round a ring of remote DMAs over
// ICI: n - 1 hops, each a neighbour barrier, a copy of the whole buffer to
// the right and an add of what arrived from the left. The hops were forced
// on the TPU, where a chip reaches only its neighbours. Here a rank is a
// group of blocks of ONE cooperative launch, and every rank can read every
// other rank's buffer directly (one L2 and one HBM; across cards, NVLink
// peer loads). So the hops are replaced by one exchange:
// 1. each rank publishes its buffer once: the buffer it wrote stays where
//    it is (K6: its row of the gradients; P3: its input), no copy;
// 2. one all-rank arrival: each block, once its writes are done, adds 1 to
//    its rank's `kPublished` count (for P3, whose inputs are written before
//    the launch, the rank's first block alone) and waits until every
//    rank's count shows that rank's signals (a volatile poll of each, then
//    one fence; a wait over kSpinLimitNs traps);
// 3. one pass: rank r's threads read the n buffers in the ring's order,
//    r, r - 1, r - 2, ... (indices mod n), add them in that order rounding
//    after every add, multiply by `scale` once after the last add, and
//    write the result once, to a buffer no other rank reads.
// The sums and their order are exactly the ring's (ring_all_reduce_
// reference in ops/ring_allreduce.py, the JAX kernel's hop order), so
// every result is the naive ring's to the bit: rank r's
// ((x_r + x_{r-1}) + x_{r-2}) + ...; ranks still differ in the last bit.
//
// Ranks meet only through counts in device memory and buffers they read,
// both of which could be peer-mapped across cards: no grid barrier.
// Counts only grow (no ABA) and are compared modulo 2^32 against targets
// offset by their value at launch: K6 zeroes them before each launch, P3
// keeps them across calls and passes each rank's count in.
//
// Reuse across steps (K6 runs every step of an epoch in one launch) is the
// caller's: a rank must not overwrite a buffer that a slower rank may still
// be reading. K6 double-buffers the gradients by step parity (fused_
// epoch.cu), so step s + 1's arrival, which every rank makes after its
// pass of step s, also covers step s's reads.
//
// Memory: values written inside the launch are read through L2 with a
// volatile `ld.global.cg` (ld_cg, ld_cg4); a count is added to after a
// fence and read with volatile loads, then a fence.
//
// What bounds it: the function reads each input once and writes each
// output once, 8 n len bytes. The pass reads each input n times (once a
// rank), n^2 len floats, mostly from L2 once a rank has touched them; at
// the flagship's 4 ranks of 186,610 gradient floats that is 12 MB of L2
// reads, under 2 us at the L2's rate. The arrival (every block polls n
// counts) and, for P3, the launch are the rest.

#pragma once

#include <cstdint>

namespace tinynn {

// A rank's counts, kSyncWords apart in the `sync` array.
constexpr int kSyncWords = 2;
enum SyncWord { kArrive = 0, kPublished = 1 };

// A load of data written inside the launch: through L2 (never a stale L1
// line), and volatile with a memory clobber, so that the compiler neither
// merges it with an earlier load nor moves it across a barrier (__ldcg is
// a plain asm statement that it may hoist or merge).
__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

// ld_cg of four floats; p is 16-byte aligned.
__device__ __forceinline__ float4 ld_cg4(const float* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

// A count as another block last wrote it: a volatile load, through L2.
// The waits fence after it.
__device__ __forceinline__ unsigned ld_count(const unsigned* p) {
  unsigned v;
  asm volatile("ld.volatile.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Adds 1 to a count once this thread's earlier writes (and, after a
// __syncthreads, its block's) are visible to the whole card.
__device__ __forceinline__ void signal(unsigned* p) {
  __threadfence();
  atomicAdd(p, 1u);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait this long is a deadlock (a fault in the counts): the launch traps,
// and fails with an error instead of holding the card.
constexpr unsigned long long kSpinLimitNs = 10000000000ull;  // 10 s

// Spin until *p reaches `target` (modulo 2^32). The clock is read once
// every 1024 polls: each read slows the poll.
__device__ __forceinline__ void wait_for(const unsigned* p, unsigned target) {
  unsigned long long start = 0;
  for (unsigned polls = 0; static_cast<int>(ld_count(p) - target) < 0;
       ++polls) {
    if ((polls & 1023u) == 0) {
      const unsigned long long now = global_ns();
      if (polls == 0) start = now;
      else if (now - start > kSpinLimitNs) __trap();
    }
  }
}

// wait_for, then fence: what the blocks that counted wrote before their
// signal is visible after it.
__device__ __forceinline__ void spin_until(const unsigned* p,
                                           unsigned target) {
  wait_for(p, target);
  __threadfence();
}

// Where a block sits: its rank, the blocks a rank has and the block's
// index among them, and how far it has come (the targets of the counts).
struct Group {
  unsigned* sync;      // [n_ranks][kSyncWords], zero at launch but for the
                       // `published` counts exchange_arrive is told of
  int rank, n_ranks, blocks, block;
  unsigned barriers;   // rank barriers passed
  unsigned exchanges;  // all-rank arrivals made
};

// Rank r is blocks [r * blocks, (r + 1) * blocks) of the launch.
__device__ __forceinline__ Group group_of(unsigned* sync, int n_ranks,
                                          int blocks) {
  const int b = static_cast<int>(blockIdx.x);
  return {sync, b / blocks, n_ranks, blocks, b % blocks, 0u, 0u};
}

__device__ __forceinline__ unsigned* count_of(const Group& g, int rank,
                                              SyncWord w) {
  return g.sync + rank * kSyncWords + w;
}

// A barrier over the blocks of this block's rank only: the grid barrier
// of one rank. Every thread of the block calls it.
__device__ __forceinline__ void rank_barrier(Group& g) {
  __syncthreads();
  ++g.barriers;
  if (threadIdx.x == 0) {
    unsigned* arrive = count_of(g, g.rank, kArrive);
    signal(arrive);
    spin_until(arrive, g.barriers * static_cast<unsigned>(g.blocks));
  }
  __syncthreads();
}

// A debug hold (-1: none): `rank`'s blocks spin `ns` before each arrival, a
// check that the result does not depend on the ranks running in step.
struct Skew {
  int rank;
  long long ns;
};

// The exchange's one all-rank arrival: once it is made, every rank's
// published buffer is complete and visible. Every thread of the block calls
// it, after its last write of the rank's buffer. With `every_block` each
// block of a rank signals (a rank whose blocks wrote its buffer), and the
// arrival also orders what comes after it behind everything every block
// did before it, as a barrier over all the launch's blocks would; without,
// only the rank's first block does (a buffer written before the launch).
// `published` (null: all zero) is each rank's `kPublished` count at launch.
__device__ __forceinline__ void exchange_arrive(
    Group& g, const Skew& skew, const unsigned* published = nullptr,
    bool every_block = true) {
  __syncthreads();
  ++g.exchanges;
  if (threadIdx.x == 0) {
    if (g.rank == skew.rank) {
      const unsigned long long until = global_ns() + skew.ns;
      while (global_ns() < until) {
      }
    }
    if (every_block || g.block == 0) signal(count_of(g, g.rank, kPublished));
    const unsigned made =
        g.exchanges * static_cast<unsigned>(every_block ? g.blocks : 1);
    for (int q = 0; q < g.n_ranks; ++q)
      wait_for(count_of(g, q, kPublished),
               (published != nullptr ? published[q] : 0u) + made);
    __threadfence();  // one fence after all n counts, not one after each
  }
  __syncthreads();
}

// The rank whose buffer is the k-th that rank `r` of `n` adds.
__device__ __forceinline__ int ring_rank(int r, int k, int n) {
  return (r - k + n) % n;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 mul4(float4 a, float s) {
  return make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s),
                     __fmul_rn(a.z, s), __fmul_rn(a.w, s));
}

// The pass's loads in flight a thread: kUnroll float4s of up to kBatch
// ranks are issued before any of them is added.
constexpr int kUnroll = 2;
constexpr int kBatch = 4;

// out[i] := the sum of src(q)[i] over the ranks q in the ring's order from
// this block's rank, times `scale` where `scaled` (one f32 multiply after
// the last add), for i < len. `src(q)` is rank q's published buffer. With
// `vec` every src(q) and `out` are 16-byte aligned and the pass loads four
// floats at a time. Thread t of the rank's blocks takes the rank's float4s
// t, t + stride, ... (then the tail floats the same way). Every thread of
// every block calls it after exchange_arrive.
template <class Src>
__device__ __forceinline__ void exchange_pass(const Group& g, Src src,
                                              float* out, long long len,
                                              bool vec, bool scaled,
                                              float scale) {
  const int n = g.n_ranks;
  const long long first =
      static_cast<long long>(g.block) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(g.blocks) * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long len4 = len / 4;
    for (long long base = first; base < len4; base += kUnroll * stride) {
      float4 acc[kUnroll] = {};
      for (int k0 = 0; k0 < n; k0 += kBatch) {
        float4 v[kBatch][kUnroll];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (k0 + j >= n) break;
          const float* p = src(ring_rank(g.rank, k0 + j, n));
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const long long i = base + u * stride;
            v[j][u] = i < len4 ? ld_cg4(p + 4 * i)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (k0 + j >= n) break;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            acc[u] = k0 + j == 0 ? v[j][u] : add4(acc[u], v[j][u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * stride;
        if (i < len4)
          reinterpret_cast<float4*>(out)[i] =
              scaled ? mul4(acc[u], scale) : acc[u];
      }
    }
    done = len4 * 4;
  }
  for (long long i = done + first; i < len; i += stride) {
    float acc = ld_cg(src(g.rank) + i);
    for (int k = 1; k < n; ++k)
      acc = __fadd_rn(acc, ld_cg(src(ring_rank(g.rank, k, n)) + i));
    out[i] = scaled ? __fmul_rn(acc, scale) : acc;
  }
}

}  // namespace tinynn
