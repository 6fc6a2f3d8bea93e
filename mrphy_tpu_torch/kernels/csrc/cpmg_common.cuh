// cpmg_common.cuh: the per-echo arithmetic shared by the CPMG echo-train
// kernels (cpmg_fwd.cu: K16 `cpmg_fwd` and K17 `cpmg_fwd_chk`; cpmg_bwd.cu:
// K18 `cpmg_bwd`), on top of the SPGR pieces of spgr_common.cuh (`relax`,
// `relax_T`, `attenuation`, the ring buffer and its unit shifts).
//
// Every function repeats, operation for operation, the plain PyTorch
// versions of kernels/epg.py (`_flip_trig`, `_cpmg_factors`, `_mix` and
// `_mix_T` about +x, `_mix0_terms`, `_cpmg_half`): with the build's
// -fmad=false, a kernel and its plain version round alike. The two-pool
// CPMG kernels (xcpmg_fwd.cu, xcpmg_bwd.cu) take the trig, the mix, its
// transpose and its coefficient terms from here too.
//
// Layout. coef (nC, nE) per-echo rows [cos²(α/2), sin²(α/2), sin α, cos α,
// α] (+ the esp row under a spacing train, nC = 6); par (7, nA) per-atom
// rows [E1h, E2h, rech, e_ss, e_sc, e_ca, b1] (under a spacing train the
// first three hold [R1, R2, M0]); dq (1, nA) the diffusion row (D·dk²·esp/2,
// or the rate D·dk² under a spacing train); cdiff (3, K) the b-factor
// coefficient of each order at one unit shift. K = nE + 1. An atom's state
// is 6 planes of K orders, rows [F+ re, F+ im, F− re, F− im, Z re, Z im].
#pragma once

#include "spgr_common.cuh"

namespace mrphy {
namespace cpmg {

using spgr::Factors;

enum : int { kB1 = 1, kVarEsp = 2, kDiff = 4 };

template <typename T>
struct Trig {
  T ca2, sa2, sa, ca;
};

// Echo t's refocusing factors; under b1 per atom from α = flip·b1 by the
// half-angle identities.
template <typename T>
__device__ __forceinline__ Trig<T> trig(const T* __restrict__ coef,
                                        int64_t nE, int64_t t, T b1,
                                        bool has_b1) {
  Trig<T> g;
  if (has_b1) {
    const T ah = (T(0.5) * coef[4 * nE + t]) * b1;
    const T ch = cos(ah), sh = sin(ah);
    g.ca2 = ch * ch;
    g.sa2 = sh * sh;
    g.sa = (T(2) * ch) * sh;
    g.ca = g.ca2 - g.sa2;
  } else {
    g.ca2 = coef[t];
    g.sa2 = coef[nE + t];
    g.sa = coef[2 * nE + t];
    g.ca = coef[3 * nE + t];
  }
  return g;
}

// Echo t's half-interval (E1h, E2h, rech) as spgr::Factors (E2te unused):
// the atom's rows, or under a spacing train formed from the rates (p0 = R1,
// p1 = R2) and M0 (p2), the recovery through expm1.
template <typename T>
__device__ __forceinline__ Factors<T> factors(const T* __restrict__ coef,
                                              int64_t nE, int64_t t, T p0,
                                              T p1, T p2, bool varesp) {
  if (!varesp) return {p0, p1, T(0), p2};
  const T hn = T(0.5) * coef[5 * nE + t];
  const T a1 = -expm1(-(hn * p0));
  return {T(1) - a1, exp(-(hn * p1)), T(0), p2 * a1};
}

// The refocusing mix about +x (the RF mix without its phase terms).
template <typename T>
__device__ __forceinline__ void mix0(const Trig<T>& g, const T (&s)[6],
                                     T (&o)[6]) {
  const T hc = T(0.5) * g.sa;
  o[0] = (g.ca2 * s[0] + g.sa2 * s[2]) + g.sa * s[5];
  o[1] = (g.ca2 * s[1] + g.sa2 * s[3]) - g.sa * s[4];
  o[2] = (g.sa2 * s[0] + g.ca2 * s[2]) - g.sa * s[5];
  o[3] = (g.sa2 * s[1] + g.ca2 * s[3]) + g.sa * s[4];
  o[4] = (hc * s[1] - hc * s[3]) + g.ca * s[4];
  o[5] = (hc * s[2] - hc * s[0]) + g.ca * s[5];
}

// The exact transpose of mix0.
template <typename T>
__device__ __forceinline__ void mix0_T(const Trig<T>& g, const T (&h)[6],
                                       T (&o)[6]) {
  const T hc = T(0.5) * g.sa;
  o[0] = (g.ca2 * h[0] + g.sa2 * h[2]) - hc * h[5];
  o[1] = (g.ca2 * h[1] + g.sa2 * h[3]) + hc * h[4];
  o[2] = (g.sa2 * h[0] + g.ca2 * h[2]) + hc * h[5];
  o[3] = (g.sa2 * h[1] + g.ca2 * h[3]) - hc * h[4];
  o[4] = (g.sa * h[3] - g.sa * h[1]) + g.ca * h[4];
  o[5] = (g.sa * h[0] - g.sa * h[2]) + g.ca * h[5];
}

// The per-order terms of the refocusing mix's coefficient gradients [∂ca2,
// ∂sa2, ∂sc, ∂hc, ∂ca] (∂sa = ∂sc + ∂hc/2): the cotangent h of the mixed
// state against its input x.
template <typename T>
__device__ __forceinline__ void mix0_terms(const T (&h)[6], const T (&x)[6],
                                           T (&o)[5]) {
  o[0] = ((h[0] * x[0] + h[1] * x[1]) + h[2] * x[2]) + h[3] * x[3];
  o[1] = ((h[0] * x[2] + h[1] * x[3]) + h[2] * x[0]) + h[3] * x[1];
  o[2] = (h[0] - h[2]) * x[5] - (h[1] - h[3]) * x[4];
  o[3] = h[4] * (x[1] - x[3]) + h[5] * (x[2] - x[0]);
  o[4] = h[4] * x[4] + h[5] * x[5];
}

// Order k of a logical state src (element (p, q) at [(p·K + q)·nA]) after
// one half echo: relaxed (and attenuated), then shifted one unit up, so
// F+(k) comes from F+(k − 1), F−(k) from F−(k + 1) (F−(K − 1) from beyond:
// 0), F+(0) = conj(the new F−(0)) and Z stays.
template <typename T>
__device__ __forceinline__ void half_at(const T* __restrict__ src,
                                        int64_t nA, int K, int k,
                                        const Factors<T>& f, bool has_d,
                                        const T* __restrict__ cdiff, T dqt,
                                        T (&n)[6]) {
  auto at = [&](int p, int q) -> T { return src[((int64_t)p * K + q) * nA]; };
  if (k >= 1) {
    n[0] = f.E2 * at(0, k - 1);
    n[1] = f.E2 * at(1, k - 1);
    if (has_d) {
      const T A = exp(-dqt * cdiff[k - 1]);
      n[0] = A * n[0];
      n[1] = A * n[1];
    }
  } else {
    T r = f.E2 * at(2, 1), i = f.E2 * at(3, 1);
    if (has_d) {
      const T A = exp(-dqt * cdiff[K + 1]);
      r = A * r;
      i = A * i;
    }
    n[0] = r;
    n[1] = -i;
  }
  if (k + 1 < K) {
    n[2] = f.E2 * at(2, k + 1);
    n[3] = f.E2 * at(3, k + 1);
    if (has_d) {
      const T A = exp(-dqt * cdiff[K + k + 1]);
      n[2] = A * n[2];
      n[3] = A * n[3];
    }
  } else {
    n[2] = T(0);
    n[3] = T(0);
  }
  n[4] = f.E1 * at(4, k);
  if (k == 0) n[4] = n[4] + f.rec;
  n[5] = f.E1 * at(5, k);
  if (has_d) {
    const T A = exp(-dqt * cdiff[2 * K + k]);
    n[4] = A * n[4];
    n[5] = A * n[5];
  }
}

inline bool valid_args(int64_t nA, int64_t nE, int64_t nC, int64_t flags,
                       int64_t tc, int64_t threads) {
  return nA > 0 && nE > 0 && tc > 0 && nE % tc == 0 &&
         nC == ((flags & kVarEsp) ? 6 : 5) &&
         spgr::valid_threads((int)threads);
}

}  // namespace cpmg
}  // namespace mrphy
