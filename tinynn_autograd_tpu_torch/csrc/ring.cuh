// The in-kernel gradient ring for ranks that share one card: the device
// code of P3 (csrc/ring_allreduce.cu, the ring alone) and of K6, the ring
// phase of the ranked whole-epoch kernel (csrc/fused_epoch.cu).
//
// Replaces `grad_ring_all_reduce` (tinynn_autograd_tpu/ops/fused_epoch.py:
// 114) and the ring kernel of tests/test_dp_megakernel.py:36. There each
// TPU device of a mesh axis runs the kernel on its own batch shard and
// sums its gradients with its neighbours' by remote DMA over ICI. Here a
// rank is a group of blocks of ONE cooperative launch, with its own
// replica, its own shard and its own comm slots in device memory; ranks
// talk to their neighbours only through the counters below, so a rank's
// code would be the same if the ranks sat on different cards.
//
// The algorithm and its flow control are the TPU kernel's, hop for hop:
// - each rank has two comm slots; slot 0 starts as its own values. Hop k
//   (k = 0 .. n-2) pushes the WHOLE of slot k % 2 into the right
//   neighbour's slot (k + 1) % 2 and adds what arrived in its own slot
//   (k + 1) % 2. So rank r ends with ((x_r + x_{r-1}) + x_{r-2}) + ...,
//   rounded after every add, and ranks differ in the order of their sums.
// - the remote copy: the rank's blocks store their grid-stride share into
//   the right rank's slot. The receive semaphore: each block then fences
//   and adds 1 to the right rank's `recv` count; a rank reads
//   its slot once its count reaches (its left's blocks) x (hops so far).
// - the neighbour barrier (the TPU kernel's `semaphore_signal` to left and
//   right, then `semaphore_wait(bar, 2)`, once a hop): once all of a
//   rank's blocks are done with the hop before, it adds 1 to its left's
//   `from_right` and to its right's `from_left` count, and waits until
//   both of its own reach the hops begun. So nobody writes a slot that its
//   neighbour has yet to forward. The TPU kernel counts both neighbours'
//   signals on one semaphore; two counts keep a neighbour that runs a hop
//   ahead from standing in for one that is a hop behind.
// - counts only grow within a launch (so no ABA), are compared modulo
//   2^32, and are zeroed by the wrapper before each launch.
//
// Memory: values written inside the launch are read through L2 with a
// volatile `ld.global.cg` (ld_cg); a count is added to after a fence and
// read with volatile loads, then a fence (the grid barrier's pattern).
//
// What bounds it: a hop moves the rank's whole buffer, so n ranks of len
// floats read and write 2 x 4 x len x (n - 1) bytes each in the hops, plus
// the first copy and the adds: a naive ring, against the 2 (n - 1) / n
// share of a reduce-scatter/all-gather ring. It keeps the JAX package's
// order of sums; the bandwidth-optimal ring is later work (ROADMAP).

#pragma once

#include <cstdint>

namespace tinynn {

// A rank's counts, kSyncWords apart in the `sync` array.
constexpr int kSyncWords = 4;
enum SyncWord { kArrive = 0, kFromLeft = 1, kFromRight = 2, kRecv = 3 };

// A load of data written inside the launch: through L2 (never a stale L1
// line), and volatile with a memory clobber, so that the compiler neither
// merges it with an earlier load nor moves it across a barrier (__ldcg is
// a plain asm statement that it may hoist or merge).
__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
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

// Spin until *p reaches `target` (modulo 2^32), then fence: what the
// blocks that counted wrote before their signal is visible after it. The
// clock is read once every 1024 polls: each read slows the poll.
__device__ __forceinline__ void spin_until(const unsigned* p,
                                           unsigned target) {
  unsigned long long start = 0;
  for (unsigned polls = 0; static_cast<int>(ld_count(p) - target) < 0;
       ++polls) {
    if ((polls & 1023u) == 0) {
      const unsigned long long now = global_ns();
      if (polls == 0) start = now;
      else if (now - start > kSpinLimitNs) __trap();
    }
  }
  __threadfence();
}

// Where a block sits: its rank, the blocks a rank has and the block's
// index among them, and how far it has come (the targets of the counts).
struct Group {
  unsigned* sync;      // [n_ranks][kSyncWords], zero at launch
  int rank, n_ranks, blocks, block;
  unsigned barriers;   // rank barriers passed
  unsigned hops;       // ring hops made
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

// The neighbour barrier before hop g.hops: every block of the rank is done
// with what came before; then the rank signals both neighbours once and
// waits for both of theirs.
__device__ __forceinline__ void neighbour_barrier(Group& g, int left,
                                                  int right) {
  rank_barrier(g);
  const unsigned begun = g.hops + 1;
  if (threadIdx.x == 0) {
    if (g.block == 0) {
      signal(count_of(g, left, kFromRight));
      signal(count_of(g, right, kFromLeft));
    }
    spin_until(count_of(g, g.rank, kFromLeft), begun);
    spin_until(count_of(g, g.rank, kFromRight), begun);
  }
  __syncthreads();
}

struct Ring {
  float* comm;         // [n_ranks][2][len]: each rank's two comm slots
  long long len;       // floats each rank sums
  int skew_rank;       // a debug hold (-1: none): this rank's blocks
  long long skew_ns;   // spin skew_ns before each ring's first hop
};

// The passes over a rank's floats: thread t of the rank's blocks takes
// elements first, first + stride, ... in every pass, kUnroll at a time with
// all their loads issued before any store (the loads are volatile asm,
// which the compiler keeps in order).
constexpr int kUnroll = 4;

// dst[i] = src[i] over the thread's elements.
__device__ __forceinline__ void copy_pass(float* dst, const float* src,
                                          long long first, long long stride,
                                          long long len) {
  for (long long base = first; base < len; base += kUnroll * stride) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      v[u] = i < len ? ld_cg(src + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < len) dst[i] = v[u];
    }
  }
}

// acc[i] = (acc[i] + in[i]), times `scale` after the add where `scaled`.
__device__ __forceinline__ void add_pass(float* acc, const float* in,
                                         long long first, long long stride,
                                         long long len, bool scaled,
                                         float scale) {
  for (long long base = first; base < len; base += kUnroll * stride) {
    float a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      a[u] = i < len ? ld_cg(acc + i) : 0.0f;
      b[u] = i < len ? ld_cg(in + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      const float v = __fadd_rn(a[u], b[u]);
      if (i < len) acc[i] = scaled ? __fmul_rn(v, scale) : v;
    }
  }
}

// acc (this rank's len floats, in place) := the sum round the ring of
// every rank's acc, times `scale` (one f32 multiply after the last add;
// 1.0f leaves the sum). Every block of every rank calls it.
__device__ __forceinline__ void ring_all_reduce(const Ring& R, Group& g,
                                                float* acc, float scale) {
  const int n = g.n_ranks;
  const int right = (g.rank + 1) % n;
  const int left = (g.rank + n - 1) % n;
  const long long len = R.len;
  float* mine = R.comm + static_cast<long long>(g.rank) * 2 * len;
  float* next = R.comm + static_cast<long long>(right) * 2 * len;
  const long long first =
      static_cast<long long>(g.block) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(g.blocks) * blockDim.x;
  copy_pass(mine, acc, first, stride, len);
  for (int k = 0; k < n - 1; ++k) {
    const long long src = (k & 1) * len, dst = ((k + 1) & 1) * len;
    if (k == 0 && g.rank == R.skew_rank && threadIdx.x == 0) {
      const unsigned long long until = global_ns() + R.skew_ns;
      while (global_ns() < until) {
      }
    }
    neighbour_barrier(g, left, right);
    copy_pass(next + dst, mine + src, first, stride, len);
    __syncthreads();
    ++g.hops;
    if (threadIdx.x == 0) {
      signal(count_of(g, right, kRecv));
      spin_until(count_of(g, g.rank, kRecv),
                 g.hops * static_cast<unsigned>(g.blocks));
    }
    __syncthreads();
    add_pass(acc, mine + dst, first, stride, len, k == n - 2, scale);
  }
}

}  // namespace tinynn
