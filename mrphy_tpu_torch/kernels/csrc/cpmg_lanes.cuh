// cpmg_lanes.cuh: the one-pool CPMG echo's steps on the lane route
// (epg_lanes.cuh's layout: lane l of a group of G holds orders l + i·G of
// the 6 planes in slot i), shared by the forward with checkpoints
// (cpmg_fwd_lanes.cu: K17 `cpmg_fwd_chk`) and by phase 1 of the adjoint
// (cpmg_bwd_lanes.cu: K18 `cpmg_bwd`), which reruns the same steps from the
// checkpoints. Each order's arithmetic is cpmg_common.cuh's and the unit
// shift is shuffles that only move values, so a step matches the plain
// versions (kernels/epg.py `_cpmg_echo`) bit for bit.
#pragma once

#include "cpmg_common.cuh"
#include "epg_lanes.cuh"

namespace mrphy {
namespace cpmg {

using lanes::Group;

// Echo t's scalars: the refocusing's trig, the half's factors and its
// diffusion step.
template <typename T>
struct EchoS {
  Trig<T> tg;
  Factors<T> f;
  T dqt;
};

template <typename T>
__device__ __forceinline__ EchoS<T> echo_scalars(
    const T* __restrict__ coef, int64_t nE, int64_t t, T p0, T p1, T p2,
    T b1, T dq, bool has_b1, bool varesp) {
  EchoS<T> e;
  e.tg = trig(coef, nE, t, b1, has_b1);
  e.f = factors(coef, nE, t, p0, p1, p2, varesp);
  e.dqt = varesp ? dq * (T(0.5) * coef[5 * nE + t]) : dq;
  return e;
}

// Echo scalars held by lane `src` of the group, on every lane.
template <typename T>
__device__ __forceinline__ EchoS<T> echo_from(const EchoS<T>& own, int src,
                                              int G) {
  EchoS<T> e;
  e.tg.ca2 = lanes::shfl(own.tg.ca2, src, G);
  e.tg.sa2 = lanes::shfl(own.tg.sa2, src, G);
  e.tg.sa = lanes::shfl(own.tg.sa, src, G);
  e.tg.ca = lanes::shfl(own.tg.ca, src, G);
  e.f.E1 = lanes::shfl(own.f.E1, src, G);
  e.f.E2 = lanes::shfl(own.f.E2, src, G);
  e.f.E2te = T(0);
  e.f.rec = lanes::shfl(own.f.rec, src, G);
  e.dqt = lanes::shfl(own.dqt, src, G);
  return e;
}

// Order k's attenuations over one half (1 without diffusion).
template <typename T>
__device__ __forceinline__ void att(const T* __restrict__ cdiff, int K, int k,
                                    T dqt, bool has_d, T (&A)[3]) {
  A[0] = A[1] = A[2] = T(1);
  if (has_d) spgr::attenuation(cdiff, K, k, dqt, A);
}

// One half echo on every order: relaxation (and the attenuation), then the
// crusher's unit shift.
template <typename T, int M>
__device__ __forceinline__ void half_lanes(T (&x)[6][M], const EchoS<T>& e,
                                           const T* __restrict__ cdiff,
                                           bool has_d, const Group& g) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (!g.valid(i)) continue;
    T n[6] = {x[0][i], x[1][i], x[2][i], x[3][i], x[4][i], x[5][i]};
    T A[3];
    att(cdiff, g.K, g.order(i), e.dqt, has_d, A);
    spgr::relax(e.f, g.order(i), has_d, A, n);
#pragma unroll
    for (int p = 0; p < 6; ++p) x[p][i] = n[p];
  }
  lanes::shift_pool<0, false>(x, 1, g);
}

template <typename T, int M>
__device__ __forceinline__ void mix_lanes(T (&x)[6][M], const Trig<T>& tg,
                                          const Group& g) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (!g.valid(i)) continue;
    const T s[6] = {x[0][i], x[1][i], x[2][i], x[3][i], x[4][i], x[5][i]};
    T o[6];
    mix0(tg, s, o);
#pragma unroll
    for (int p = 0; p < 6; ++p) x[p][i] = o[p];
  }
}

}  // namespace cpmg
}  // namespace mrphy
