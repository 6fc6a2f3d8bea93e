// epgx_common.cuh: the per-order arithmetic of the two-pool EPG-X kernels
// (xspgr_fwd.cu: K19 `xspgr_fwd` and K20 `xspgr_fwd_chk`; xspgr_bwd.cu:
// K21 `xspgr_bwd`): the exact exchange-relaxation of one configuration
// order and its transpose with the 14 propagator-entry contractions, the
// RF mix's coefficient terms of one pool, and the two pools' ring shift.
// The EPG-X trains at variable TR and the two-pool CPMG reuse them, and the
// adjoints' phase 1 the shifted store of one pool's order (xspgr_bwd.cu,
// xmt_bwd.cu); the two-pool CPMG adjoints the half echo of one order
// (`xhalf_at`). Each pool's RF mix and shift are the single-pool ones of
// spgr_common.cuh.
//
// Every function repeats, operation for operation, the plain PyTorch
// versions of kernels/epgx.py (`_xrelax`, `_xrelax_T`, `_mix_terms`): with
// the build's -fmad=false, a kernel and its plain version round alike.
//
// Layout. par (17, nA) per-atom rows [E00r, E00i, E01r, E01i, E10r, E10i,
// E11r, E11i, Z00, Z01, Z10, Z11, ra, rb, M0a, M0b, b1]: the transverse
// exchange-relaxation propagator over one interval (complex, re/im
// pairs), the longitudinal one (real), the affine recovery into Za(0) and
// Zb(0), the initial Z(0) of each pool and the transmit scale. An atom's
// state is 12 planes of K orders: pool a's [F+ re, F+ im, F− re, F− im,
// Z re, Z im], then pool b's.
#pragma once

#include "spgr_common.cuh"

namespace mrphy {
namespace epgx {

using spgr::Planes;

constexpr int kPlanes = 12;

// The 14 propagator entries of one atom.
template <typename T>
struct Prop {
  T E00r, E00i, E01r, E01i, E10r, E10i, E11r, E11i, Z00, Z01, Z10, Z11, ra,
      rb;
};

template <typename T>
__device__ __forceinline__ Prop<T> load_prop(const T* __restrict__ par,
                                             int64_t nA, int64_t a) {
  Prop<T> e;
  e.E00r = par[a];
  e.E00i = par[nA + a];
  e.E01r = par[2 * nA + a];
  e.E01i = par[3 * nA + a];
  e.E10r = par[4 * nA + a];
  e.E10i = par[5 * nA + a];
  e.E11r = par[6 * nA + a];
  e.E11i = par[7 * nA + a];
  e.Z00 = par[8 * nA + a];
  e.Z01 = par[9 * nA + a];
  e.Z10 = par[10 * nA + a];
  e.Z11 = par[11 * nA + a];
  e.ra = par[12 * nA + a];
  e.rb = par[13 * nA + a];
  return e;
}

// Pool b's planes of a state (pool a's are the first six).
template <typename T>
__device__ __forceinline__ Planes<T> pool_b(const Planes<T>& st) {
  return Planes<T>{st.base + (int64_t)6 * st.K * st.stride, st.stride, st.K};
}

// The exchange-relaxation over one interval of order k of a mixed state
// (pool a's six values in na, pool b's in nb), in place: the complex
// propagator E on F+, its conjugate on F− (F− holds conj(F̃(−k))), the
// real Z on Z with the recovery added at order 0.
template <typename T>
__device__ __forceinline__ void xrelax(const Prop<T>& e, int k, T (&na)[6],
                                       T (&nb)[6]) {
  const T Par = na[0], Pai = na[1], Mar = na[2], Mai = na[3], Zar = na[4],
          Zai = na[5];
  const T Pbr = nb[0], Pbi = nb[1], Mbr = nb[2], Mbi = nb[3], Zbr = nb[4],
          Zbi = nb[5];
  na[0] = (e.E00r * Par - e.E00i * Pai) + (e.E01r * Pbr - e.E01i * Pbi);
  na[1] = (e.E00r * Pai + e.E00i * Par) + (e.E01r * Pbi + e.E01i * Pbr);
  na[2] = (e.E00r * Mar + e.E00i * Mai) + (e.E01r * Mbr + e.E01i * Mbi);
  na[3] = (e.E00r * Mai - e.E00i * Mar) + (e.E01r * Mbi - e.E01i * Mbr);
  na[4] = e.Z00 * Zar + e.Z01 * Zbr;
  if (k == 0) na[4] = na[4] + e.ra;
  na[5] = e.Z00 * Zai + e.Z01 * Zbi;
  nb[0] = (e.E10r * Par - e.E10i * Pai) + (e.E11r * Pbr - e.E11i * Pbi);
  nb[1] = (e.E10r * Pai + e.E10i * Par) + (e.E11r * Pbi + e.E11i * Pbr);
  nb[2] = (e.E10r * Mar + e.E10i * Mai) + (e.E11r * Mbr + e.E11i * Mbi);
  nb[3] = (e.E10r * Mai - e.E10i * Mar) + (e.E11r * Mbi - e.E11i * Mbr);
  nb[4] = e.Z10 * Zar + e.Z11 * Zbr;
  if (k == 0) nb[4] = nb[4] + e.rb;
  nb[5] = e.Z10 * Zai + e.Z11 * Zbi;
}

// The transpose of xrelax on order k at its input (xa, xb), given the
// cotangent (ha, hb) of its output: adds the order's 12 terms to kE (the
// sums over the orders are the gradients of [E00r, E00i, E01r, E01i, E10r,
// E10i, E11r, E11i, Z00, Z01, Z10, Z11]), takes ∂ra and ∂rb at order 0,
// and replaces (ha, hb) by the cotangent of the input: conj(E)ᵀ on F+, Eᵀ
// on F−, Zᵀ on Z.
template <typename T>
__device__ __forceinline__ void xrelax_T(const Prop<T>& e, int k,
                                         const T (&xa)[6], const T (&xb)[6],
                                         T (&ha)[6], T (&hb)[6], T (&kE)[12],
                                         T& d_ra, T& d_rb) {
  const T hPar = ha[0], hPai = ha[1], hMar = ha[2], hMai = ha[3],
          hZar = ha[4], hZai = ha[5];
  const T hPbr = hb[0], hPbi = hb[1], hMbr = hb[2], hMbi = hb[3],
          hZbr = hb[4], hZbi = hb[5];
  const T Par = xa[0], Pai = xa[1], Mar = xa[2], Mai = xa[3], Zar = xa[4],
          Zai = xa[5];
  const T Pbr = xb[0], Pbi = xb[1], Mbr = xb[2], Mbi = xb[3], Zbr = xb[4],
          Zbi = xb[5];
  kE[0] += ((hPar * Par + hPai * Pai) + hMar * Mar) + hMai * Mai;
  kE[1] += ((-hPar * Pai + hPai * Par) + hMar * Mai) - hMai * Mar;
  kE[2] += ((hPar * Pbr + hPai * Pbi) + hMar * Mbr) + hMai * Mbi;
  kE[3] += ((-hPar * Pbi + hPai * Pbr) + hMar * Mbi) - hMai * Mbr;
  kE[4] += ((hPbr * Par + hPbi * Pai) + hMbr * Mar) + hMbi * Mai;
  kE[5] += ((-hPbr * Pai + hPbi * Par) + hMbr * Mai) - hMbi * Mar;
  kE[6] += ((hPbr * Pbr + hPbi * Pbi) + hMbr * Mbr) + hMbi * Mbi;
  kE[7] += ((-hPbr * Pbi + hPbi * Pbr) + hMbr * Mbi) - hMbi * Mbr;
  kE[8] += hZar * Zar + hZai * Zai;
  kE[9] += hZar * Zbr + hZai * Zbi;
  kE[10] += hZbr * Zar + hZbi * Zai;
  kE[11] += hZbr * Zbr + hZbi * Zbi;
  if (k == 0) {
    d_ra = hZar;
    d_rb = hZbr;
  }
  ha[0] = ((e.E00r * hPar + e.E00i * hPai) + e.E10r * hPbr) + e.E10i * hPbi;
  ha[1] = ((-e.E00i * hPar + e.E00r * hPai) - e.E10i * hPbr) + e.E10r * hPbi;
  ha[2] = ((e.E00r * hMar - e.E00i * hMai) + e.E10r * hMbr) - e.E10i * hMbi;
  ha[3] = ((e.E00i * hMar + e.E00r * hMai) + e.E10i * hMbr) + e.E10r * hMbi;
  ha[4] = e.Z00 * hZar + e.Z10 * hZbr;
  ha[5] = e.Z00 * hZai + e.Z10 * hZbi;
  hb[0] = ((e.E01r * hPar + e.E01i * hPai) + e.E11r * hPbr) + e.E11i * hPbi;
  hb[1] = ((-e.E01i * hPar + e.E01r * hPai) - e.E11i * hPbr) + e.E11r * hPbi;
  hb[2] = ((e.E01r * hMar - e.E01i * hMai) + e.E11r * hMbr) - e.E11i * hMbi;
  hb[3] = ((e.E01i * hMar + e.E01r * hMai) + e.E11i * hMbr) + e.E11r * hMbi;
  hb[4] = e.Z01 * hZar + e.Z11 * hZbr;
  hb[5] = e.Z01 * hZai + e.Z11 * hZbi;
}

// One pool's per-order terms of the RF mix's coefficient gradients [∂ca2,
// ∂sc2, ∂ss2, ∂ss, ∂sc, ∂hs, ∂hc, ∂ca]: the cotangent h of the mixed
// state against the pre-RF state x.
template <typename T>
__device__ __forceinline__ void mix_terms(const T (&h)[6], const T (&x)[6],
                                          T (&o)[8]) {
  o[0] = ((h[0] * x[0] + h[1] * x[1]) + h[2] * x[2]) + h[3] * x[3];
  o[1] = ((h[0] * x[2] + h[1] * x[3]) + h[2] * x[0]) + h[3] * x[1];
  o[2] = ((-h[0] * x[3] + h[1] * x[2]) + h[2] * x[1]) - h[3] * x[0];
  o[3] = (h[0] + h[2]) * x[4] + (h[1] + h[3]) * x[5];
  o[4] = (h[0] - h[2]) * x[5] - (h[1] - h[3]) * x[4];
  o[5] = -h[4] * (x[0] + x[2]) - h[5] * (x[1] + x[3]);
  o[6] = h[4] * (x[1] - x[3]) + h[5] * (x[2] - x[0]);
  o[7] = h[4] * x[4] + h[5] * x[5];
}

// One pool's relaxed order k (n) written into dst shifted by s orders: up
// (P = F+, M = F−) F+(k) → F+(k + s), F−(k) → F−(k − s), and for 1 ≤ k ≤ s
// F−(k) → conj into F+(s − k); the mirror otherwise.
template <typename T>
__device__ __forceinline__ void store_shifted(T* __restrict__ dst,
                                              int64_t nA, int K, int s,
                                              int P, int M, const T (&n)[6],
                                              int k) {
  auto at = [&](int p, int kk) -> int64_t {
    return ((int64_t)p * K + kk) * nA;
  };
  dst[at(4, k)] = n[4];
  dst[at(5, k)] = n[5];
  if (k + s < K) {
    dst[at(P, k + s)] = n[P];
    dst[at(P + 1, k + s)] = n[P + 1];
  }
  if (k >= s) {
    dst[at(M, k - s)] = n[M];
    dst[at(M + 1, k - s)] = n[M + 1];
  }
  if (k >= 1 && k <= s && s - k < K) {  // crossing k = 0: conjugated
    dst[at(P, s - k)] = n[M];
    dst[at(P + 1, s - k)] = -n[M + 1];
  }
}

// The orders of one pool that the shift brings in from beyond K − 1.
template <typename T>
__device__ __forceinline__ void zero_shifted_in(T* __restrict__ dst,
                                                int64_t nA, int K, int s,
                                                int P, int M) {
  auto at = [&](int p, int kk) -> int64_t {
    return ((int64_t)p * K + kk) * nA;
  };
  for (int k = K - s > 0 ? K - s : 0; k < K; ++k) {
    dst[at(M, k)] = T(0);
    dst[at(M + 1, k)] = T(0);
  }
  for (int k = 0; k < s - K + 1 && k < K; ++k) {
    dst[at(P, k)] = T(0);
    dst[at(P + 1, k)] = T(0);
  }
}

// Order k of both pools of a state src after one half echo of the
// two-pool CPMG train (xcpmg_bwd.cu, xcpmg_bwd_lanes.cu): the
// exchange-relaxation, then the unit shift up, so F+(k) comes from F+(k −
// 1), F−(k) from F−(k + 1) (F−(K − 1) from beyond: 0), F+(0) = conj(the
// new F−(0)) and Z stays; the expressions are xrelax's. Element (p, q) of
// pool a at src[p·ps + q·qs] (pool b's planes 6-11): a logical state in
// device memory (ps = K·nA, qs = nA) or an atom's slot of the lane route
// in shared memory (ps = M·G, qs = 1, in int arithmetic).
template <typename T, typename I>
__device__ __forceinline__ void xhalf_at(const T* __restrict__ src, I ps,
                                         I qs, int K, int k,
                                         const Prop<T>& e, T (&na)[6],
                                         T (&nb)[6]) {
  auto at = [&](int p, int q) -> T { return src[p * ps + q * qs]; };
  if (k >= 1) {
    const T Par = at(0, k - 1), Pai = at(1, k - 1), Pbr = at(6, k - 1),
            Pbi = at(7, k - 1);
    na[0] = (e.E00r * Par - e.E00i * Pai) + (e.E01r * Pbr - e.E01i * Pbi);
    na[1] = (e.E00r * Pai + e.E00i * Par) + (e.E01r * Pbi + e.E01i * Pbr);
    nb[0] = (e.E10r * Par - e.E10i * Pai) + (e.E11r * Pbr - e.E11i * Pbi);
    nb[1] = (e.E10r * Pai + e.E10i * Par) + (e.E11r * Pbi + e.E11i * Pbr);
  } else {
    const T Mar = at(2, 1), Mai = at(3, 1), Mbr = at(8, 1), Mbi = at(9, 1);
    na[0] = (e.E00r * Mar + e.E00i * Mai) + (e.E01r * Mbr + e.E01i * Mbi);
    na[1] = -((e.E00r * Mai - e.E00i * Mar) + (e.E01r * Mbi - e.E01i * Mbr));
    nb[0] = (e.E10r * Mar + e.E10i * Mai) + (e.E11r * Mbr + e.E11i * Mbi);
    nb[1] = -((e.E10r * Mai - e.E10i * Mar) + (e.E11r * Mbi - e.E11i * Mbr));
  }
  if (k + 1 < K) {
    const T Mar = at(2, k + 1), Mai = at(3, k + 1), Mbr = at(8, k + 1),
            Mbi = at(9, k + 1);
    na[2] = (e.E00r * Mar + e.E00i * Mai) + (e.E01r * Mbr + e.E01i * Mbi);
    na[3] = (e.E00r * Mai - e.E00i * Mar) + (e.E01r * Mbi - e.E01i * Mbr);
    nb[2] = (e.E10r * Mar + e.E10i * Mai) + (e.E11r * Mbr + e.E11i * Mbi);
    nb[3] = (e.E10r * Mai - e.E10i * Mar) + (e.E11r * Mbi - e.E11i * Mbr);
  } else {
    na[2] = na[3] = nb[2] = nb[3] = T(0);
  }
  const T Zar = at(4, k), Zai = at(5, k), Zbr = at(10, k), Zbi = at(11, k);
  na[4] = e.Z00 * Zar + e.Z01 * Zbr;
  if (k == 0) na[4] = na[4] + e.ra;
  na[5] = e.Z00 * Zai + e.Z01 * Zbi;
  nb[4] = e.Z10 * Zar + e.Z11 * Zbr;
  if (k == 0) nb[4] = nb[4] + e.rb;
  nb[5] = e.Z10 * Zai + e.Z11 * Zbi;
}

// |kshift| unit shifts of both pools' ring buffers (one pair of offsets:
// both pools shift alike), or of their transposes.
template <typename T>
__device__ __forceinline__ void ring_shift2(const Planes<T>& st, int& op,
                                            int& om, int kshift) {
  const Planes<T> sb = pool_b(st);
  const int n = kshift > 0 ? kshift : -kshift;
  for (int u = 0; u < n; ++u) {
    int opb = op, omb = om;
    spgr::ring_shift(st, op, om, kshift > 0);
    spgr::ring_shift(sb, opb, omb, kshift > 0);
  }
}

template <typename T>
__device__ __forceinline__ void ring_shift2_T(const Planes<T>& h, int& op,
                                              int& om, int kshift) {
  const Planes<T> hb = pool_b(h);
  const int n = kshift > 0 ? kshift : -kshift;
  for (int u = 0; u < n; ++u) {
    int opb = op, omb = om;
    spgr::ring_shift_T(h, op, om, kshift > 0);
    spgr::ring_shift_T(hb, opb, omb, kshift > 0);
  }
}

}  // namespace epgx
}  // namespace mrphy
