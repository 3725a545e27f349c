// The optimizer-only megakernel probe for Hopper (sm_90a), P2: K2's structure
// with nothing but the optimizer's update in it, to measure the optimizer's
// share of a K2 step.
//
// Replaces the TPU kernel `kernel` inside `build_probe` (bench_mega_probe.py:
// 36). There a sequential grid of n_steps keeps the flagship's 10 leaves and
// the optimizer's slots in VMEM scratch and applies only the per-leaf update
// each step, with a fake gradient g = 1e-3 p. Here, as in K2: one persistent
// cooperative launch runs all n_steps; each step every block takes its
// grid-stride share of the leaves, reads the parameter and its slots through
// L2 (ld.global.cg, as K2 reads state written inside the launch), applies
// the shared rule (csrc/optim_rules.cuh) with the step's scalars, writes
// them back, and the step ends with one grid barrier, as K2's optimizer
// phase does.
//
// What bounds it: each step reads and writes every parameter and each of
// the rule's slots once: 8 bytes a float each, 1.49 MB a step for SGD and
// 4.48 MB for Adam on the flagship's 186,610 parameters, 0.45 and 1.34 us at
// 3.35 TB/s (less where the 50 MB L2 serves them, as it does here). What
// holds it back: the grid barrier a step, and the few hundred floats each
// block updates between two barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "optim_rules.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEAVES = 32;

struct Args {
  int n_leaves, n_steps;
  tinynn::Rule rule;       // the scalars s0, s1 are set each step
  const float* scalars;    // [n_steps, 2]
  long long size[MAX_LEAVES];
  float* p[MAX_LEAVES];    // updated in place
  float* s0[MAX_LEAVES];   // the rule's slots (null when it has fewer)
  float* s1[MAX_LEAVES];
};

// A load of data written inside the launch (see csrc/fused_epoch.cu).
__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

__global__ void __launch_bounds__(THREADS)
mega_probe_kernel(const __grid_constant__ Args a) {
  cg::grid_group grid = cg::this_grid();
  const int n_slots = tinynn::rule_slots(a.rule.opt);
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int s = 0; s < a.n_steps; ++s) {
    tinynn::Rule r = a.rule;
    r.s0 = __ldg(a.scalars + 2 * s);
    r.s1 = __ldg(a.scalars + 2 * s + 1);
    for (int j = 0; j < a.n_leaves; ++j) {
      float* p = a.p[j];
      for (long long i = first; i < a.size[j]; i += stride) {
        const float pi = ld_cg(p + i);
        const float g = __fmul_rn(pi, 1e-3f);  // the fake gradient
        float v0 = n_slots > 0 ? ld_cg(a.s0[j] + i) : 0.0f;
        float v1 = n_slots > 1 ? ld_cg(a.s1[j] + i) : 0.0f;
        p[i] = tinynn::apply_rule(r, pi, g, v0, v1);
        if (n_slots > 0) a.s0[j][i] = v0;
        if (n_slots > 1) a.s1[j][i] = v1;
      }
    }
    grid.sync();
  }
}

}  // namespace

// `n_steps` probe steps over `n_leaves` leaves of `sizes` floats: `params`
// and the rule's slots `slot0`/`slot1` (arrays of device pointers, null
// where the rule has no such slot) updated in place. `opt`, `c0`-`c3` and
// `wd` are the rule (csrc/optim_rules.cuh), `scalars` [n_steps, 2] each
// step's scalars. Launches on `stream` and does not synchronise. Returns the
// CUDA error of the launch (0 when it was accepted).
extern "C" int tinynn_mega_probe(int n_leaves, const long long* sizes,
                                 void* const* params, void* const* slot0,
                                 void* const* slot1, const float* scalars,
                                 int n_steps, int opt, float c0, float c1,
                                 float c2, float c3, float wd, void* stream) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || n_steps < 1 ||
      opt < tinynn::kSGD || opt > tinynn::kAdadelta)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mega_probe_kernel, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);

  Args a = {};
  a.n_leaves = n_leaves;
  a.n_steps = n_steps;
  a.rule = {opt, 0.0f, 0.0f, c0, c1, c2, c3, wd};
  a.scalars = scalars;
  for (int j = 0; j < n_leaves; ++j) {
    a.size[j] = sizes[j];
    a.p[j] = static_cast<float*>(params[j]);
    a.s0[j] = static_cast<float*>(slot0[j]);
    a.s1[j] = static_cast<float*>(slot1[j]);
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(mega_probe_kernel), dim3(per_sm * sms),
      dim3(THREADS), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
