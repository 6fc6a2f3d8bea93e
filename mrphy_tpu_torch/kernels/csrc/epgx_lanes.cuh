// epgx_lanes.cuh: the two-pool EPG-X forward steps on the lane route
// (epg_lanes.cuh's layout: lane l of a group of G holds orders l + i·G of
// both pools in slot i of each of the 12 planes), shared by the forwards
// with checkpoints (xspgr_fwd_lanes.cu: K20 `xspgr_fwd_chk`, K23
// `xspgr_v_fwd_chk`; xcpmg_fwd_lanes.cu: K26 `xcpmg_fwd_chk`, K29
// `xcpmg_v_fwd_chk`) and by phase 1 of the adjoints (xspgr_bwd_lanes.cu:
// K21, K24; xcpmg_bwd_lanes.cu: K27, K30), which reruns the same steps
// from the checkpoints. Each order's arithmetic is epgx_common.cuh's and
// the shifts are shuffles that only move values, so a step matches the
// plain versions (kernels/epgx.py `_xstep`, `_xhalf`, `_xmix`) bit for bit.
// The EPG-X(MT) step (pool a's 6 planes and the bound pool's Z pair, 8 in
// all) is here too, for phase 1 of its lane adjoint (xmt_bwd_lanes.cu: K33
// `xmt_bwd`, K36 `xmt_v_bwd`; kernels/epgx.py `_mt_mix`, `_mt_next`).
#pragma once

#include "cpmg_common.cuh"
#include "epg_lanes.cuh"
#include "epgx_common.cuh"
#include "xmt_common.cuh"

namespace mrphy {
namespace epgx {

using lanes::Group;

// One TR of the gradient-spoiled train on every order of both pools: the
// RF mix, the exchange–relaxation, the spoiler's shift. f0 takes each
// lane's slot-0 mixed total (Fa+ + Fb+ re, im): on lane 0 the echo's
// Fa+(0) + Fb+(0) before demodulation.
template <typename T, int M>
__device__ __forceinline__ void xstep_lanes(T (&x)[kPlanes][M],
                                            const spgr::Trig<T>& tg,
                                            const Prop<T>& e, int kshift,
                                            const Group& g, T (&f0)[2]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (!g.valid(i)) continue;
    const T xa[6] = {x[0][i], x[1][i], x[2][i], x[3][i], x[4][i], x[5][i]};
    const T xb[6] = {x[6][i], x[7][i], x[8][i], x[9][i], x[10][i], x[11][i]};
    T na[6], nb[6];
    spgr::mix(tg, xa, na);
    spgr::mix(tg, xb, nb);
    if (i == 0) {
      f0[0] = na[0] + nb[0];
      f0[1] = na[1] + nb[1];
    }
    xrelax(e, g.order(i), na, nb);
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      x[p][i] = na[p];
      x[6 + p][i] = nb[p];
    }
  }
  lanes::shift_pool<0, false>(x, kshift, g);
  lanes::shift_pool<6, false>(x, kshift, g);
}

// The RF trig held by lane `src` of the group, on every lane.
template <typename T>
__device__ __forceinline__ spgr::Trig<T> trig_from(const spgr::Trig<T>& own,
                                                   int src, int G) {
  return {lanes::shfl(own.ca2, src, G), lanes::shfl(own.sa2, src, G),
          lanes::shfl(own.sa, src, G),  lanes::shfl(own.ca, src, G),
          lanes::shfl(own.c1, src, G),  lanes::shfl(own.s1, src, G),
          lanes::shfl(own.c2, src, G),  lanes::shfl(own.s2, src, G)};
}

}  // namespace epgx

namespace xcpmg {

using epgx::kPlanes;
using epgx::Prop;
using lanes::Group;

// One half echo of both pools on every order: the exchange–relaxation,
// then the crusher's unit shift.
template <typename T, int M>
__device__ __forceinline__ void xhalf_lanes(T (&x)[kPlanes][M],
                                            const Prop<T>& e,
                                            const Group& g) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (!g.valid(i)) continue;
    T na[6] = {x[0][i], x[1][i], x[2][i], x[3][i], x[4][i], x[5][i]};
    T nb[6] = {x[6][i], x[7][i], x[8][i], x[9][i], x[10][i], x[11][i]};
    epgx::xrelax(e, g.order(i), na, nb);
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      x[p][i] = na[p];
      x[6 + p][i] = nb[p];
    }
  }
  lanes::shift_pool<0, false>(x, 1, g);
  lanes::shift_pool<6, false>(x, 1, g);
}

// The refocusing mix about +x on both pools, every order.
template <typename T, int M>
__device__ __forceinline__ void xmix_lanes(T (&x)[kPlanes][M],
                                           const cpmg::Trig<T>& tg,
                                           const Group& g) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (!g.valid(i)) continue;
#pragma unroll
    for (int b = 0; b < kPlanes; b += 6) {
      const T s[6] = {x[b][i],     x[b + 1][i], x[b + 2][i],
                      x[b + 3][i], x[b + 4][i], x[b + 5][i]};
      T o[6];
      cpmg::mix0(tg, s, o);
#pragma unroll
      for (int p = 0; p < 6; ++p) x[b + p][i] = o[p];
    }
  }
}

// The refocusing trig held by lane `src` of the group, on every lane.
template <typename T>
__device__ __forceinline__ cpmg::Trig<T> trig_from(const cpmg::Trig<T>& own,
                                                   int src, int G) {
  return {lanes::shfl(own.ca2, src, G), lanes::shfl(own.sa2, src, G),
          lanes::shfl(own.sa, src, G), lanes::shfl(own.ca, src, G)};
}

}  // namespace xcpmg

namespace xmt {

using lanes::Group;

// One TR of the EPG-X(MT) train on every order: pool a's RF mix and the
// bound pool's saturation, the exchange–relaxation, then the spoiler's
// shift of pool a's F states.
template <typename T, int M>
__device__ __forceinline__ void mt_step_lanes(T (&x)[kPlanes][M],
                                              const spgr::Trig<T>& tg, T sat,
                                              const Prop<T>& e, int kshift,
                                              const Group& g) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (!g.valid(i)) continue;
    const T s[8] = {x[0][i], x[1][i], x[2][i], x[3][i],
                    x[4][i], x[5][i], x[6][i], x[7][i]};
    T n[8];
    mt_mix(tg, sat, s, n);
    mt_relax(e, g.order(i), n);
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) x[p][i] = n[p];
  }
  lanes::shift_pool<0, false>(x, kshift, g);
}

}  // namespace xmt
}  // namespace mrphy
