// bssfp_common.cuh: the per-TR arithmetic shared by the balanced-SSFP
// kernels (bssfp_fwd.cu: K37 `bssfp_fwd` and K38 `bssfp_fwd_chk`;
// bssfp_bwd.cu: K39 `bssfp_bwd`).
//
// Every function repeats, operation for operation, the plain PyTorch
// versions of kernels/ssfp.py (`_rf`, `_relax`, `_step`): with the build's
// -fmad=false, a kernel and its plain version round alike.
//
// Layout. coef (nC, nTR) per-TR rows [cos α, sin α·sin φ, sin α·cos φ,
// (1 − cos α)·cos φ, (1 − cos α)·sin φ, cos φ, sin φ, α] (+ [te, tr − te]
// under a variable TR/TE, nC = 10); pk (nP, nA) per-atom rows, at a
// constant TR/TE [cos(ω·te), sin(ω·te), E2(te), 1 − E1(te), cos(ω·rem),
// sin(ω·rem), E2(rem), 1 − E1(rem), M0, b1] (nP = 10), under a variable
// TR/TE the rates [1/T1, 1/T2, ω, M0, b1] (nP = 5), ω = −2π·df. An atom's
// state is the isochromat (Mx, My, Mz), held in registers.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mrphy {
namespace bssfp {

enum : int { kB1 = 1, kVarTR = 2 };

// The per-atom rows of pk: how many, and where M0 lies (b1 is the last).
template <bool VARTR>
struct Rows {
  static constexpr int kP = VARTR ? 5 : 10;
  static constexpr int kC = VARTR ? 10 : 8;
  static constexpr int kM0 = VARTR ? 3 : 8;
};

// TR t's RF factors: the rotation about (cos φ, sin φ, 0) by −α is
// M' = ca·M − sa·(u×M) + (1 − ca)·u·(u·M), written with A = sa·sin φ,
// B = sa·cos φ, vc/vs = (1 − ca)·cos φ/sin φ.
template <typename T>
struct Rf {
  T ca, sa, A, B, vc, vs, cphi, sphi;
};

// TR t's relaxation and precession to TE, then over the remainder.
template <typename T>
struct Relax {
  T cte, ste, E2te, a1te, crem, srem, E2rem, a1rem;
};

// The rows, or under B1 per atom from α = flip·b1 (sa only then).
template <typename T, bool B1>
__device__ __forceinline__ Rf<T> rf(const T* __restrict__ coef, int64_t nTR,
                                    int64_t t, T b1) {
  Rf<T> g;
  g.cphi = __ldg(coef + 5 * nTR + t);
  g.sphi = __ldg(coef + 6 * nTR + t);
  if constexpr (B1) {
    const T al = __ldg(coef + 7 * nTR + t) * b1;
    g.ca = cos(al);
    g.sa = sin(al);
    g.A = g.sa * g.sphi;
    g.B = g.sa * g.cphi;
    const T oc = T(1) - g.ca;
    g.vc = oc * g.cphi;
    g.vs = oc * g.sphi;
  } else {
    g.ca = __ldg(coef + t);
    g.sa = T(0);
    g.A = __ldg(coef + nTR + t);
    g.B = __ldg(coef + 2 * nTR + t);
    g.vc = __ldg(coef + 3 * nTR + t);
    g.vs = __ldg(coef + 4 * nTR + t);
  }
  return g;
}

// One interval's (cos, sin, E2, 1 − E1) from the rates (p0 = 1/T1,
// p1 = 1/T2, p2 = ω) and its duration, the recovery through expm1.
template <typename T>
__device__ __forceinline__ void interval(T dur, const T* p, T& c, T& s,
                                         T& E2, T& a1) {
  const T ph = p[2] * dur;
  c = cos(ph);
  s = sin(ph);
  E2 = exp(-dur * p[1]);
  a1 = -expm1(-(dur * p[0]));
}

// The atom's rows, or under VARTR formed from the rates and the te/rem rows.
template <typename T, bool VARTR>
__device__ __forceinline__ Relax<T> relax(const T* __restrict__ coef,
                                          int64_t nTR, int64_t t,
                                          const T* p) {
  Relax<T> x;
  if constexpr (VARTR) {
    interval(__ldg(coef + 8 * nTR + t), p, x.cte, x.ste, x.E2te, x.a1te);
    interval(__ldg(coef + 9 * nTR + t), p, x.crem, x.srem, x.E2rem, x.a1rem);
  } else {
    x = {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
  }
  return x;
}

// One full TR from the pre-RF state (Mx, My, Mz), in place: the rotation,
// the TE interval, the echo (er, ei) demodulated by the transmit phase,
// the remainder.
template <typename T>
__device__ __forceinline__ void step(const Rf<T>& g, const Relax<T>& x, T M0,
                                     T& Mx, T& My, T& Mz, T& er, T& ei) {
  const T dot = g.cphi * Mx + g.sphi * My;
  const T Mx1 = g.ca * Mx - g.A * Mz + g.vc * dot;
  const T My1 = g.ca * My + g.B * Mz + g.vs * dot;
  const T Mz1 = g.ca * Mz + g.A * Mx - g.B * My;
  const T MxE = x.E2te * (x.cte * Mx1 - x.ste * My1);
  const T MyE = x.E2te * (x.ste * Mx1 + x.cte * My1);
  const T MzE = (T(1) - x.a1te) * Mz1 + x.a1te * M0;
  er = g.cphi * MxE + g.sphi * MyE;
  ei = g.cphi * MyE - g.sphi * MxE;
  Mx = x.E2rem * (x.crem * MxE - x.srem * MyE);
  My = x.E2rem * (x.srem * MxE + x.crem * MyE);
  Mz = (T(1) - x.a1rem) * MzE + x.a1rem * M0;
}

}  // namespace bssfp
}  // namespace mrphy
