// spgr_common.cuh: the per-TR arithmetic shared by the SPGR / MRF-FISP
// EPG kernels (spgr_fwd.cu: K13 `spgr_fwd` and K14 `spgr_fwd_chk`;
// spgr_bwd.cu and spgr_bwd_lanes.cu: K15 `spgr_bwd`).
//
// Every function repeats, operation for operation, the plain PyTorch
// versions of kernels/epg.py (`_trig`, `_factors`, `_mix`, `_mix_T`,
// `_relax`, `_relax_T`, `_shift`): with the build's -fmad=false, a kernel
// and its plain version round alike.
//
// Layout. coef (nC, nTR) per-TR rows [cos²(α/2), sin²(α/2), sin α, cos α,
// cos φ, sin φ, cos 2φ, sin 2φ, α] (+ [tr, te] under variable TR/TE);
// par (7, nA) per-atom rows [E1, E2, E2te, rec, z0, b1, dq] (under variable
// TR/TE the first four hold [R1, R2, M0, 0]); cdiff (3, K) the b-factor
// coefficient of each order. An atom's state is 6 planes of K orders, rows
// [F+ re, F+ im, F− re, F− im, Z re, Z im].
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace mrphy {
namespace spgr {

enum : int { kB1 = 1, kVarTR = 2, kDiff = 4 };

template <typename T>
struct Trig {
  T ca2, sa2, sa, ca, c1, s1, c2, s2;
};

// TR t's RF factors; under b1 the first four per atom from α = flip·b1 by
// the half-angle identities.
template <typename T>
__device__ __forceinline__ Trig<T> trig(const T* __restrict__ coef,
                                        int64_t nTR, int64_t t, T b1,
                                        bool has_b1) {
  Trig<T> g;
  if (has_b1) {
    const T ah = (T(0.5) * coef[8 * nTR + t]) * b1;
    const T ch = cos(ah), sh = sin(ah);
    g.ca2 = ch * ch;
    g.sa2 = sh * sh;
    g.sa = (T(2) * ch) * sh;
    g.ca = g.ca2 - g.sa2;
  } else {
    g.ca2 = coef[t];
    g.sa2 = coef[nTR + t];
    g.sa = coef[2 * nTR + t];
    g.ca = coef[3 * nTR + t];
  }
  g.c1 = coef[4 * nTR + t];
  g.s1 = coef[5 * nTR + t];
  g.c2 = coef[6 * nTR + t];
  g.s2 = coef[7 * nTR + t];
  return g;
}

template <typename T>
struct Factors {
  T E1, E2, E2te, rec;
};

// TR t's (E1, E2, E2te, rec): the atom's rows, or under variable TR/TE
// formed from the rates (p0 = R1, p1 = R2) and M0 (p2), the recovery
// through expm1 (1 − exp(−tr·R1) cancels at millisecond TRs).
template <typename T>
__device__ __forceinline__ Factors<T> factors(const T* __restrict__ coef,
                                              int64_t nTR, int64_t t, T p0,
                                              T p1, T p2, T p3, bool vartr) {
  if (!vartr) return {p0, p1, p2, p3};
  const T trn = coef[9 * nTR + t], ten = coef[10 * nTR + t];
  const T a1 = -expm1(-(trn * p0));
  return {T(1) - a1, exp(-(trn * p1)), exp(-(ten * p1)), p2 * a1};
}

// The RF mix (epg_rf's rows in real-pair arithmetic).
template <typename T>
__device__ __forceinline__ void mix(const Trig<T>& g, const T (&s)[6],
                                    T (&o)[6]) {
  const T sc2 = g.sa2 * g.c2, ss2 = g.sa2 * g.s2;
  const T ss = g.sa * g.s1, sc = g.sa * g.c1;
  const T hs = T(0.5) * ss, hc = T(0.5) * sc;
  o[0] = (g.ca2 * s[0] + (sc2 * s[2] - ss2 * s[3])) + (ss * s[4] + sc * s[5]);
  o[1] = (g.ca2 * s[1] + (sc2 * s[3] + ss2 * s[2])) + (ss * s[5] - sc * s[4]);
  o[2] = ((sc2 * s[0] + ss2 * s[1]) + g.ca2 * s[2]) + (ss * s[4] - sc * s[5]);
  o[3] = ((sc2 * s[1] - ss2 * s[0]) + g.ca2 * s[3]) + (ss * s[5] + sc * s[4]);
  o[4] = ((-hs * s[0] + hc * s[1]) + (-hs * s[2] - hc * s[3])) + g.ca * s[4];
  o[5] = ((-hs * s[1] - hc * s[0]) + (-hs * s[3] + hc * s[2])) + g.ca * s[5];
}

// The exact transpose of mix.
template <typename T>
__device__ __forceinline__ void mix_T(const Trig<T>& g, const T (&h)[6],
                                      T (&o)[6]) {
  const T sc2 = g.sa2 * g.c2, ss2 = g.sa2 * g.s2;
  const T ss = g.sa * g.s1, sc = g.sa * g.c1;
  const T hs = T(0.5) * ss, hc = T(0.5) * sc;
  o[0] = (((g.ca2 * h[0] + sc2 * h[2]) - ss2 * h[3]) - hs * h[4]) - hc * h[5];
  o[1] = (((g.ca2 * h[1] + ss2 * h[2]) + sc2 * h[3]) + hc * h[4]) - hs * h[5];
  o[2] = (((sc2 * h[0] + ss2 * h[1]) + g.ca2 * h[2]) - hs * h[4]) + hc * h[5];
  o[3] = (((-ss2 * h[0] + sc2 * h[1]) + g.ca2 * h[3]) - hc * h[4]) - hs * h[5];
  o[4] = (((ss * h[0] - sc * h[1]) + ss * h[2]) + sc * h[3]) + g.ca * h[4];
  o[5] = (((sc * h[0] + ss * h[1]) - sc * h[2]) + ss * h[3]) + g.ca * h[5];
}

// Order k's diffusion attenuations exp(−dq_t·c(k)) of F+, F−, Z.
template <typename T>
__device__ __forceinline__ void attenuation(const T* __restrict__ cdiff,
                                            int K, int k, T dqt, T (&A)[3]) {
  A[0] = exp(-dqt * cdiff[k]);
  A[1] = exp(-dqt * cdiff[K + k]);
  A[2] = exp(-dqt * cdiff[2 * K + k]);
}

// Relaxation over TR with recovery into Z(0), then the diffusion
// attenuation (before the spoiler's shift), on order k of a mixed state.
template <typename T>
__device__ __forceinline__ void relax(const Factors<T>& f, int k, bool has_d,
                                      const T (&A)[3], T (&n)[6]) {
  n[0] = f.E2 * n[0];
  n[1] = f.E2 * n[1];
  n[2] = f.E2 * n[2];
  n[3] = f.E2 * n[3];
  n[4] = f.E1 * n[4];
  if (k == 0) n[4] = n[4] + f.rec;
  n[5] = f.E1 * n[5];
  if (has_d) {
    n[0] = A[0] * n[0];
    n[1] = A[0] * n[1];
    n[2] = A[1] * n[2];
    n[3] = A[1] * n[3];
    n[4] = A[2] * n[4];
    n[5] = A[2] * n[5];
  }
}

// The transpose of relax on order k at its input x, given the
// cotangent hv of its output (after the shift's transpose), the order's
// b-factor coefficients c (cdiff's column k) and attenuations A
// (`attenuation`): under diffusion hv ← A·hv, adding c·A·(hv·s2) to kcontr
// (s2: x relaxed; −Σ is ∂dq); the sums ∂E2 and ∂E1 over the orders one
// order at a time, ∂rec at order 0; then hv ← E·hv.
template <typename T>
__device__ __forceinline__ void relax_T_c(const Factors<T>& f, int k,
                                          bool has_d, const T (&c)[3],
                                          const T (&A)[3], const T (&x)[6],
                                          T (&hv)[6], T& kcontr, T& kE2,
                                          T& kE1, T& d_rec) {
  if (has_d) {
    T s2Zr = f.E1 * x[4];
    if (k == 0) s2Zr = s2Zr + f.rec;
    kcontr += ((c[0] * A[0]) *
                   (hv[0] * (f.E2 * x[0]) + hv[1] * (f.E2 * x[1])) +
               (c[1] * A[1]) *
                   (hv[2] * (f.E2 * x[2]) + hv[3] * (f.E2 * x[3]))) +
              (c[2] * A[2]) * (hv[4] * s2Zr + hv[5] * (f.E1 * x[5]));
    hv[0] = A[0] * hv[0];
    hv[1] = A[0] * hv[1];
    hv[2] = A[1] * hv[2];
    hv[3] = A[1] * hv[3];
    hv[4] = A[2] * hv[4];
    hv[5] = A[2] * hv[5];
  }
  kE2 += ((hv[0] * x[0] + hv[1] * x[1]) + hv[2] * x[2]) + hv[3] * x[3];
  kE1 += hv[4] * x[4] + hv[5] * x[5];
  if (k == 0) d_rec = hv[4];
  hv[0] = f.E2 * hv[0];
  hv[1] = f.E2 * hv[1];
  hv[2] = f.E2 * hv[2];
  hv[3] = f.E2 * hv[3];
  hv[4] = f.E1 * hv[4];
  hv[5] = f.E1 * hv[5];
}

// relax_T_c with order k's coefficients read from cdiff (3, K).
template <typename T>
__device__ __forceinline__ void relax_T_att(const Factors<T>& f, int K, int k,
                                            bool has_d,
                                            const T* __restrict__ cdiff,
                                            const T (&A)[3], const T (&x)[6],
                                            T (&hv)[6], T& kcontr, T& kE2,
                                            T& kE1, T& d_rec) {
  T c[3] = {T(0), T(0), T(0)};
  if (has_d) {
    c[0] = cdiff[k];
    c[1] = cdiff[K + k];
    c[2] = cdiff[2 * K + k];
  }
  relax_T_c(f, k, has_d, c, A, x, hv, kcontr, kE2, kE1, d_rec);
}

// relax_T with the order's attenuations formed here (under diffusion).
template <typename T>
__device__ __forceinline__ void relax_T(const Factors<T>& f, int K, int k,
                                        bool has_d,
                                        const T* __restrict__ cdiff, T dqt,
                                        const T (&x)[6], T (&hv)[6],
                                        T& kcontr, T& kE2, T& kE1,
                                        T& d_rec) {
  T A[3] = {T(1), T(1), T(1)};
  if (has_d) attenuation(cdiff, K, k, dqt, A);
  relax_T_att(f, K, k, has_d, cdiff, A, x, hv, kcontr, kE2, kE1, d_rec);
}

// One atom's 6·K state values, strided: in shared memory (stride = the
// block's threads) or in device memory (stride = nA). Element (p, i) of
// plane p, slot i.
template <typename T>
struct Planes {
  T* base;
  int64_t stride;
  int K;
  __device__ __forceinline__ T& operator()(int p, int i) const {
    return base[((int64_t)p * K + i) * stride];
  }
};

// A ring buffer of the orders: logical order k of F± sits in slot
// (k + off±) mod K, so a unit spoiler shift moves the two offsets and
// writes two slots. Z does not shift.
__device__ __forceinline__ int wrap_inc(int i, int K) {
  return i + 1 == K ? 0 : i + 1;
}
__device__ __forceinline__ int wrap_dec(int i, int K) {
  return i == 0 ? K - 1 : i - 1;
}

// One unit shift of a ring state: for up (kshift > 0) F+ moves up and F−
// down, the new F+(0) = conj(new F−(0)) and the new F−(K−1) = 0; the
// mirror otherwise.
template <typename T>
__device__ __forceinline__ void ring_shift(const Planes<T>& st, int& op,
                                           int& om, bool up) {
  const int K = st.K;
  if (up) {
    om = wrap_inc(om, K);
    const int last = wrap_dec(om, K);
    st(2, last) = T(0);
    st(3, last) = T(0);
    op = wrap_dec(op, K);
    st(0, op) = st(2, om);
    st(1, op) = -st(3, om);
  } else {
    op = wrap_inc(op, K);
    const int last = wrap_dec(op, K);
    st(0, last) = T(0);
    st(1, last) = T(0);
    om = wrap_dec(om, K);
    st(2, om) = st(0, op);
    st(3, om) = -st(1, op);
  }
}

// One unit of the shift's transpose on a ring adjoint: for up, F+(k) ←
// F+(k + 1) with F+(K−1) ← 0, F−(k) ← F−(k − 1) with F−(0) ← 0, and
// conj(the old F+(0)) added to F−(1), which fed the new F+(0); the mirror
// otherwise.
template <typename T>
__device__ __forceinline__ void ring_shift_T(const Planes<T>& h, int& op,
                                             int& om, bool up) {
  const int K = h.K;
  if (up) {
    const T p0r = h(0, op), p0i = h(1, op);
    h(0, op) = T(0);  // the old F+(0) slot becomes the new F+(K − 1)
    h(1, op) = T(0);
    op = wrap_inc(op, K);
    om = wrap_dec(om, K);  // the old F−(K − 1) slot becomes the new F−(0)
    h(2, om) = T(0);
    h(3, om) = T(0);
    if (K > 1) {
      const int one = wrap_inc(om, K);
      h(2, one) = h(2, one) + p0r;
      h(3, one) = h(3, one) - p0i;
    }
  } else {
    const T m0r = h(2, om), m0i = h(3, om);
    h(2, om) = T(0);
    h(3, om) = T(0);
    om = wrap_inc(om, K);
    op = wrap_dec(op, K);
    h(0, op) = T(0);
    h(1, op) = T(0);
    if (K > 1) {
      const int one = wrap_inc(op, K);
      h(0, one) = h(0, one) + m0r;
      h(1, one) = h(1, one) - m0i;
    }
  }
}

// Threads per block: 32, 64 or 128, as the wrapper chose (kernels/epg.py
// `launch_cfg`).
inline bool valid_threads(int threads) {
  return threads == 32 || threads == 64 || threads == 128;
}

}  // namespace spgr
}  // namespace mrphy
