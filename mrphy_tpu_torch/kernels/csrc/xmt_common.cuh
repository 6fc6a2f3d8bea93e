// xmt_common.cuh: the per-order arithmetic of the EPG-X(MT) kernels
// (xmt_fwd.cu: K31 `xmt_fwd`, K32 `xmt_fwd_chk` and their variable-TR
// instances K34 `xmt_v_fwd`, K35 `xmt_v_fwd_chk`; xmt_bwd.cu: K33 `xmt_bwd`
// and K36 `xmt_v_bwd`): the bound pool's saturation, pool a's transverse
// decay with the exchange of the Z pair and its transpose with the 7 row
// contractions.
// Pool a's RF mix and shift are the single-pool ones of spgr_common.cuh.
//
// Every function repeats, operation for operation, the plain PyTorch
// versions of kernels/epgx.py (`_mt_mix`, `_mt_relax`, `_mt_bwd`):
// with the build's -fmad=false, a kernel and its plain version round alike.
//
// Layout. coef (10, nTR) per-TR rows [cos²(α/2), sin²(α/2), sin α, cos α,
// cos φ, sin φ, cos 2φ, sin 2φ, α, wt]; pk (11, nA) per-atom rows [Z00,
// Z01, Z10, Z11, ra, rb, E2a, M0a, M0b, b1, wscale]: the longitudinal
// exchange-relaxation propagator over TR with its recovery into Za(0) and
// Zb(0), pool a's transverse decay, the initial Z(0) of each pool, the
// transmit scale and the saturation scale. Over a variable-TR train the
// first 7 rows are per TR, pkt (nTR, 7, nA), and pk keeps the last 4
// (4, nA). An atom's state is 8 planes of K orders: pool a's [F+ re, F+
// im, F− re, F− im, Z re, Z im], then pool b's [Z re, Z im] (the bound pool
// has no F states).
#pragma once

#include "epgx_common.cuh"

namespace mrphy {
namespace xmt {

using spgr::Planes;
using spgr::Trig;

constexpr int kPlanes = 8;

// The 7 per-atom entries of one interval.
template <typename T>
struct Prop {
  T Z00, Z01, Z10, Z11, ra, rb, E2a;
};

// Atom a's 7 entries from 7 rows of stride nA (pk, or one TR's plane).
template <typename T>
__device__ __forceinline__ Prop<T> load_prop(const T* __restrict__ pk,
                                             int64_t nA, int64_t a) {
  return {pk[a],          pk[nA + a],     pk[2 * nA + a], pk[3 * nA + a],
          pk[4 * nA + a], pk[5 * nA + a], pk[6 * nA + a]};
}

// TR t's saturation of the bound pool, exp(−wt_t·wscale), with the
// precise exp (as torch's on the card).
template <typename T>
__device__ __forceinline__ T saturation(const T* __restrict__ coef,
                                        int64_t nTR, int64_t t, T wsc) {
  return exp(-coef[9 * nTR + t] * wsc);
}

// TR t's RF event on order k of a pre-RF state x (8 values): pool a mixed,
// Zb saturated, into n.
template <typename T>
__device__ __forceinline__ void mt_mix(const Trig<T>& g, T sat,
                                       const T (&x)[8], T (&n)[8]) {
  const T xa[6] = {x[0], x[1], x[2], x[3], x[4], x[5]};
  T na[6];
  spgr::mix(g, xa, na);
  for (int p = 0; p < 6; ++p) n[p] = na[p];
  n[6] = sat * x[6];
  n[7] = sat * x[7];
}

// The exchange-relaxation over TR of order k of a mixed state, in place:
// E2a on pool a's F, the real 2×2 on the Z pair with the recovery added at
// order 0.
template <typename T>
__device__ __forceinline__ void mt_relax(const Prop<T>& e, int k,
                                         T (&n)[8]) {
  const T Zr = n[4], Zi = n[5], Zbr = n[6], Zbi = n[7];
  n[0] = e.E2a * n[0];
  n[1] = e.E2a * n[1];
  n[2] = e.E2a * n[2];
  n[3] = e.E2a * n[3];
  n[4] = e.Z00 * Zr + e.Z01 * Zbr;
  if (k == 0) n[4] = n[4] + e.ra;
  n[5] = e.Z00 * Zi + e.Z01 * Zbi;
  n[6] = e.Z10 * Zr + e.Z11 * Zbr;
  if (k == 0) n[6] = n[6] + e.rb;
  n[7] = e.Z10 * Zi + e.Z11 * Zbi;
}

// The transpose of mt_relax on order k at its input x (the mixed state),
// given the cotangent h of its output: adds the order's terms to kE (the
// sums over the orders are the gradients of [Z00, Z01, Z10, Z11, E2a]),
// takes ∂ra and ∂rb at order 0, and replaces h by the cotangent of x.
template <typename T>
__device__ __forceinline__ void mt_relax_T(const Prop<T>& e, int k,
                                           const T (&x)[8], T (&h)[8],
                                           T (&kE)[5], T& d_ra, T& d_rb) {
  const T hZr = h[4], hZi = h[5], hZbr = h[6], hZbi = h[7];
  kE[0] += hZr * x[4] + hZi * x[5];
  kE[1] += hZr * x[6] + hZi * x[7];
  kE[2] += hZbr * x[4] + hZbi * x[5];
  kE[3] += hZbr * x[6] + hZbi * x[7];
  kE[4] += ((h[0] * x[0] + h[1] * x[1]) + h[2] * x[2]) + h[3] * x[3];
  if (k == 0) {
    d_ra = hZr;
    d_rb = hZbr;
  }
  h[0] = e.E2a * h[0];
  h[1] = e.E2a * h[1];
  h[2] = e.E2a * h[2];
  h[3] = e.E2a * h[3];
  h[4] = e.Z00 * hZr + e.Z10 * hZbr;
  h[5] = e.Z00 * hZi + e.Z10 * hZbi;
  h[6] = e.Z01 * hZr + e.Z11 * hZbr;
  h[7] = e.Z01 * hZi + e.Z11 * hZbi;
}

}  // namespace xmt
}  // namespace mrphy
