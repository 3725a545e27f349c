// The optimizer rules of nn/optimizer.py for one parameter element, the
// single definition that the whole-epoch kernel (fused_epoch.cu, K2), the
// weight-streaming backward (streaming_epoch.cu, K3b) and the optimizer probe
// (mega_probe.cu, P2) include, so that their updates cannot drift apart.
//
// p += rule(g) - wd * p, with the rule's slots updated in place. The caller
// loads the slots the rule reads (rule_slots(opt) of them, in the order of
// the optimizer's slot_names) and stores them back: K3b with plain loads, K2
// and P2 through L2, since other blocks wrote them inside the launch. The
// constants, as ops/optim_rules.py's optimizer_constants packs them:
//   SGD      -
//   Momentum c0 = momentum
//   Adam     c0 = 1 - beta1, c1 = 1 - beta2, c2 = eps (s0 = -lr/c1,
//            s1 = rsqrt(c2) of the bias corrections)
//   Lion     c0 = beta1, c1 = 1 - beta1, c2 = beta2, c3 = 1 - beta2
//   RMSProp  c0 = 1 - decay, c1 = momentum, c2 = eps (s0 = +lr)
//   Adagrad  c0 = eps
//   Adadelta c0 = 1 - decay, c1 = eps
// and s0 = -lr where not said otherwise: the step's scalars (s0, s1) come
// from BaseOptimizer.scalars on the host, so a schedule costs nothing here.
// The _rn intrinsics keep the compiler from contracting the rules into FMAs:
// they round where the plain PyTorch rules round. Lion's step at u = 0 is 0
// (the sign of 0), as torch.sign gives.

#pragma once

namespace tinynn {

enum Opt {
  kSGD = 0, kAdam = 1, kMomentum = 2, kLion = 3, kRMSProp = 4, kAdagrad = 5,
  kAdadelta = 6
};

struct Rule {
  int opt;
  float s0, s1;          // the step's scalars (BaseOptimizer.scalars)
  float c0, c1, c2, c3;  // the rule's constants (above)
  float wd;              // weight decay
};

// How many slots the rule reads and writes.
__host__ __device__ __forceinline__ int rule_slots(int opt) {
  switch (opt) {
    case kAdam:
    case kRMSProp:
    case kAdadelta:
      return 2;
    case kMomentum:
    case kLion:
    case kAdagrad:
      return 1;
    default:
      return 0;
  }
}

// The new value of parameter p after gradient g; slot0 and slot1 (the ones
// the rule has) are updated in place.
__device__ __forceinline__ float apply_rule(const Rule& r, float p, float g,
                                            float& slot0, float& slot1) {
  float step;
  switch (r.opt) {
    case kMomentum: {
      const float acc = __fadd_rn(__fmul_rn(slot0, r.c0), g);
      slot0 = acc;
      step = __fmul_rn(r.s0, acc);
      break;
    }
    case kAdam: {
      const float m = __fadd_rn(slot0, __fmul_rn(r.c0, __fsub_rn(g, slot0)));
      const float v = __fadd_rn(
          slot1, __fmul_rn(r.c1, __fsub_rn(__fmul_rn(g, g), slot1)));
      slot0 = m;
      slot1 = v;
      step = __fdiv_rn(__fmul_rn(r.s0, m),
                       __fadd_rn(__fmul_rn(__fsqrt_rn(v), r.s1), r.c2));
      break;
    }
    case kLion: {
      const float m = slot0;
      const float u = __fadd_rn(__fmul_rn(r.c0, m), __fmul_rn(r.c1, g));
      slot0 = __fadd_rn(__fmul_rn(m, r.c2), __fmul_rn(r.c3, g));
      const float sign = u > 0.0f ? 1.0f : (u < 0.0f ? -1.0f : u);
      step = __fmul_rn(r.s0, sign);
      break;
    }
    case kRMSProp: {
      const float ms = __fadd_rn(
          slot0, __fmul_rn(r.c0, __fsub_rn(__fmul_rn(g, g), slot0)));
      const float mom =
          __fadd_rn(__fmul_rn(slot1, r.c1),
                    __fmul_rn(__fmul_rn(r.s0, g), rsqrtf(__fadd_rn(ms, r.c2))));
      slot0 = ms;
      slot1 = mom;
      step = -mom;
      break;
    }
    case kAdagrad: {
      const float G = __fadd_rn(slot0, __fmul_rn(g, g));
      slot0 = G;
      step = __fmul_rn(__fmul_rn(r.s0, g), rsqrtf(__fadd_rn(G, r.c0)));
      break;
    }
    case kAdadelta: {
      const float Eg = __fadd_rn(
          slot0, __fmul_rn(r.c0, __fsub_rn(__fmul_rn(g, g), slot0)));
      const float d = slot1;
      const float delta =
          __fmul_rn(__fmul_rn(g, __fsqrt_rn(__fadd_rn(d, r.c1))),
                    rsqrtf(__fadd_rn(Eg, r.c1)));
      slot0 = Eg;
      slot1 = __fadd_rn(d, __fmul_rn(r.c0, __fsub_rn(__fmul_rn(delta, delta),
                                                     d)));
      step = __fmul_rn(r.s0, delta);
      break;
    }
    default:  // kSGD
      step = __fmul_rn(r.s0, g);
  }
  if (r.wd != 0.0f) step = __fsub_rn(step, __fmul_rn(r.wd, p));
  return __fadd_rn(p, step);
}

}  // namespace tinynn
