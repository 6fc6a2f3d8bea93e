// spgr_lanes.cuh: the SPGR / MRF-FISP TR step on the lane route
// (epg_lanes.cuh's layout: lane l of a group of G holds orders l + i·G of
// the 6 planes in slot i), shared by the forward with checkpoints
// (spgr_fwd_lanes.cu: K14 `spgr_fwd_chk`) and by phase 1 of the adjoint
// (spgr_bwd_lanes.cu: K15 `spgr_bwd`), which reruns the same steps from the
// checkpoints. Each order's arithmetic is spgr_common.cuh's and the
// spoiler's shift is shuffles that only move values, so a step matches the
// plain versions (kernels/epg.py `_step`) bit for bit.
#pragma once

#include "epg_lanes.cuh"

namespace mrphy {
namespace spgr {

using lanes::Group;

// TR t's scalars: the RF factors, the relaxation's factors and the
// diffusion step.
template <typename T>
struct StepS {
  Trig<T> tg;
  Factors<T> f;
  T dqt;
};

template <typename T>
__device__ __forceinline__ StepS<T> step_scalars(const T* __restrict__ coef,
                                                 int64_t nTR, int64_t t,
                                                 const T (&p)[4], T b1, T dq,
                                                 bool has_b1, bool vartr) {
  StepS<T> s;
  s.tg = trig(coef, nTR, t, b1, has_b1);
  s.f = factors(coef, nTR, t, p[0], p[1], p[2], p[3], vartr);
  s.dqt = vartr ? dq * coef[9 * nTR + t] : dq;
  return s;
}

// Step scalars held by lane `src` of the group, on every lane.
template <typename T>
__device__ __forceinline__ StepS<T> step_from(const StepS<T>& own, int src,
                                              int G) {
  StepS<T> s;
  s.tg.ca2 = lanes::shfl(own.tg.ca2, src, G);
  s.tg.sa2 = lanes::shfl(own.tg.sa2, src, G);
  s.tg.sa = lanes::shfl(own.tg.sa, src, G);
  s.tg.ca = lanes::shfl(own.tg.ca, src, G);
  s.tg.c1 = lanes::shfl(own.tg.c1, src, G);
  s.tg.s1 = lanes::shfl(own.tg.s1, src, G);
  s.tg.c2 = lanes::shfl(own.tg.c2, src, G);
  s.tg.s2 = lanes::shfl(own.tg.s2, src, G);
  s.f.E1 = lanes::shfl(own.f.E1, src, G);
  s.f.E2 = lanes::shfl(own.f.E2, src, G);
  s.f.E2te = lanes::shfl(own.f.E2te, src, G);
  s.f.rec = lanes::shfl(own.f.rec, src, G);
  s.dqt = lanes::shfl(own.dqt, src, G);
  return s;
}

// One TR on every order: the RF mix, relaxation with the diffusion
// attenuations att(i, dqt, A) of slot i (A ← 1 without diffusion), the
// spoiler's shift. f0 receives the lane's slot 0 after the mix: on lane 0,
// F+(0), which the echo reads.
template <typename T, int M, typename Att>
__device__ __forceinline__ void step_lanes(T (&x)[6][M], const StepS<T>& s,
                                           Att&& att, bool has_d, int kshift,
                                           const Group& g, T (&f0)[2]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (!g.valid(i)) continue;
    const T xi[6] = {x[0][i], x[1][i], x[2][i], x[3][i], x[4][i], x[5][i]};
    T n[6], A[3];
    mix(s.tg, xi, n);
    if (i == 0) {
      f0[0] = n[0];
      f0[1] = n[1];
    }
    att(i, s.dqt, A);
    relax(s.f, g.order(i), has_d, A, n);
#pragma unroll
    for (int p = 0; p < 6; ++p) x[p][i] = n[p];
  }
  lanes::shift_pool<0, false>(x, kshift, g);
}

}  // namespace spgr
}  // namespace mrphy
