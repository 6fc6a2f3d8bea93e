// xspgr_bwd_lanes: K21 `xspgr_bwd` and, as its variable-TR instance, K24
// `xspgr_v_bwd`, the two-phase chunk adjoint of the two-pool EPG-X
// gradient-spoiled train, on their lane route: a group of G lanes per atom
// over the orders, the chunk's states kept in shared memory (Hopper,
// sm_90a).
//
// Replaces the TPU kernels `_xspgr_bwd_kernel` (launched by
// `_xspgr_core_bwd`) and `_xv_bwd_kernel` (`_xspgr_core_v_bwd`) of
// mrphy_tpu/ops/epg_pallas.py, as xspgr_bwd.cu does; the wrapper
// (kernels/epg.py `adjoint_cfg`) takes this route where an atom's orders fit
// M ≤ 3 slots a lane (float32; 1 in float64) of G = 8, 16 or 32 lanes and
// the chunk's tc states fit the S that shared memory holds, and
// xspgr_bwd.cu's one-thread-per-atom route otherwise (default K 201, float64
// K 101). The entry points (kernels/epgx.py `_adjoint_chunk`) cap tc at S.
//
// What bounds it on the H100: arithmetic (~4× the forward's per order and
// TR), then reading the checkpoints once (15.1 GB at 65,536 atoms × 400
// TRs, K 48, tc 4, in float32). The one-thread route ran 3 warps an SM with
// 12·K values a thread in shared memory and passed every chunk state
// through device memory about three times.
//
// Design (epg_lanes.cuh). Lane l of the group holds orders l + i·G of both
// pools; the pre-RF state and the adjoint h live in registers; the RF mix,
// the exchange–relaxation and their transposes act on one order at a time,
// so each lane does its own; the spoiler's shift by kshift and its
// transpose are shuffles. Per chunk, newest first: the block reads the
// chunk's checkpoint once, coalesced along the atoms, into slot 0 of its
// shared states; phase 1 runs the forward from it in registers and stores
// the tc − 1 later pre-RF states into slots 1 … tc − 1; phase 2 walks them
// backwards as xspgr_bwd.cu does (the shift's transpose, the
// exchange–relaxation's transpose with the 14 entry contractions, the
// echo's cotangent, the mix's coefficient terms and transpose). Each lane
// sums its own orders' terms, the group adds its lanes in a fixed order
// (kernels/epg.py `_lane_sum`, which the plain versions take too), so
// per-atom outputs agree bit for bit (built without FMA contraction). Over
// a variable-TR train (VARTR) each step's 14 entries are read and its 14
// contractions written, as xspgr_bwd.cu's instance does. Outputs as
// xspgr_bwd.cu's, but dcf (⌈nA·G/32⌉, nTR, 9): a warp holds 32/G atoms.
#include "epg_lanes.cuh"
#include "epgx_common.cuh"

namespace mrphy {
namespace epgx {

using lanes::Group;
using spgr::Trig;

// One TR of the forward on every order of both pools: the RF mix, the
// exchange–relaxation, the spoiler's shift.
template <typename T, int M>
__device__ __forceinline__ void xstep_lanes(T (&x)[kPlanes][M],
                                            const Trig<T>& tg,
                                            const Prop<T>& e, int kshift,
                                            const Group& g) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (!g.valid(i)) continue;
    const T xa[6] = {x[0][i], x[1][i], x[2][i], x[3][i], x[4][i], x[5][i]};
    const T xb[6] = {x[6][i], x[7][i], x[8][i], x[9][i], x[10][i], x[11][i]};
    T na[6], nb[6];
    spgr::mix(tg, xa, na);
    spgr::mix(tg, xb, nb);
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

// par: (17, nA) at a fixed TR; over a variable-TR train (VARTR) the rows
// [M0a, M0b, b1] (3, nA), the entries of step t at pkt + t·14·nA and their
// contractions at dpkt + t·14·nA.
template <typename T, int M, bool VARTR>
__global__ void __launch_bounds__(lanes::kThreads)
    xspgr_bwd_lanes_kernel(const T* __restrict__ coef,
                           const T* __restrict__ par,
                           const T* __restrict__ pkt,
                           const T* __restrict__ chk,
                           const T* __restrict__ gy, T* __restrict__ dpar,
                           T* __restrict__ dcf, T* __restrict__ dpkt,
                           int64_t nA, int64_t nTR, int K, int kshift,
                           int flags, int64_t tc, int lg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const slots = reinterpret_cast<T*>(smem_raw);
  const int G = 1 << lg, lgA = lanes::log2i(lanes::kThreads) - lg;
  const int tid = threadIdx.x, ab = tid >> lg;
  const Group g{tid & (G - 1), G, K};
  const int64_t a0 = (int64_t)blockIdx.x << lgA, a = a0 + ab;
  const bool active = a < nA, lead = g.l == 0;
  const int64_t warp = ((int64_t)blockIdx.x * lanes::kThreads + tid) >> 5;
  // the warp's first atom is past nA: its rows are not written
  const bool writer = (tid & 31) == 0 && ((warp << 5) >> lg) < nA;
  const bool has_b1 = flags & spgr::kB1;
  const int st_atom = lanes::stride(kPlanes, M, G);
  const int st_slot = st_atom << lgA;
  T* const mine = slots + ab * st_atom;  // slot s at mine + s·st_slot
  lanes::zero(slots, (int)tc * st_slot);
  Prop<T> e{};
  T b1 = 0;
  if (active) {
    if constexpr (!VARTR) e = load_prop(par, nA, a);
    b1 = par[(VARTR ? 2 : 16) * nA + a];
  }
  T h[kPlanes][M];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p)
#pragma unroll
    for (int i = 0; i < M; ++i) h[p][i] = T(0);
  T acc[14];
#pragma unroll
  for (int i = 0; i < 14; ++i) acc[i] = T(0);
  T ab1 = 0;
  // the echoes' cotangent and (VARTR) the step's entries, read one TR
  // ahead (TRs newest first)
  const bool feed = lead && active;
  T gyr_t = feed ? gy[(a * nTR + nTR - 1) * 2] : T(0);
  T gyi_t = feed ? gy[(a * nTR + nTR - 1) * 2 + 1] : T(0);
  Prop<T> e_t{};
  if constexpr (VARTR)
    if (active) e_t = load_prop(pkt + (nTR - 1) * 14 * nA, nA, a);
  const int64_t plane = (int64_t)kPlanes * K * nA;
  const int64_t ntc = nTR / tc;
  for (int64_t j = ntc - 1; j >= 0; --j) {
    __syncthreads();  // every group is done with the last chunk's slots
    lanes::stage(chk + j * plane, slots, nA, a0, lgA, kPlanes, K, M, lg,
                 st_atom);
    __syncthreads();
    // phase 1: the forward from the chunk's start state, every state
    {
      T x[kPlanes][M];
      lanes::load(mine, x, g);
      Prop<T> e_f{};  // phase 1's entries, read one TR ahead
      if constexpr (VARTR)
        if (active && tc > 1) e_f = load_prop(pkt + j * tc * 14 * nA, nA, a);
      for (int64_t tl = 1; tl < tc; ++tl) {
        const int64_t t = j * tc + tl - 1;
        const Trig<T> tg = spgr::trig(coef, nTR, t, b1, has_b1);
        if constexpr (VARTR) {
          e = e_f;
          if (active && tl + 1 < tc)
            e_f = load_prop(pkt + (t + 1) * 14 * nA, nA, a);
        }
        xstep_lanes(x, tg, e, kshift, g);
        lanes::store(mine + tl * st_slot, x, g);
      }
    }
    // phase 2: the cotangent, backwards through the stored states
    for (int64_t tl = tc - 1; tl >= 0; --tl) {
      const int64_t t = j * tc + tl;
      const Trig<T> tg = spgr::trig(coef, nTR, t, b1, has_b1);
      const T gyr = gyr_t, gyi = gyi_t;
      gyr_t = feed && t > 0 ? gy[(a * nTR + t - 1) * 2] : T(0);
      gyi_t = feed && t > 0 ? gy[(a * nTR + t - 1) * 2 + 1] : T(0);
      if constexpr (VARTR) {
        e = e_t;
        if (active && t > 0) e_t = load_prop(pkt + (t - 1) * 14 * nA, nA, a);
      }
      const T* const x0 = mine + tl * st_slot;  // the pre-RF state
      lanes::shift_pool<0, true>(h, kshift, g);
      lanes::shift_pool<6, true>(h, kshift, g);
      // each lane's orders, summed in slot order
      T kE[12], km[8];
#pragma unroll
      for (int i = 0; i < 12; ++i) kE[i] = T(0);
#pragma unroll
      for (int i = 0; i < 8; ++i) km[i] = T(0);
      T d_ra = 0, d_rb = 0, d_c1e = 0, d_s1e = 0;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (!g.valid(i)) continue;
        const int k = g.order(i);
        T xa[6], xb[6];
#pragma unroll
        for (int p = 0; p < 6; ++p) {
          xa[p] = x0[(p * M + i) * G + g.l];
          xb[p] = x0[((6 + p) * M + i) * G + g.l];
        }
        T s1a[6], s1b[6];
        spgr::mix(tg, xa, s1a);
        spgr::mix(tg, xb, s1b);
        T ha[6] = {h[0][i], h[1][i], h[2][i], h[3][i], h[4][i], h[5][i]};
        T hv[6] = {h[6][i], h[7][i], h[8][i], h[9][i], h[10][i], h[11][i]};
        // the exchange-relaxation's transpose
        xrelax_T(e, k, s1a, s1b, ha, hv, kE, d_ra, d_rb);
        if (k == 0 && active) {
          // the echo's cotangent (the echo reads the mixed state)
          const T fr = s1a[0] + s1b[0], fi = s1a[1] + s1b[1];
          const T er = tg.c1 * gyr - tg.s1 * gyi;
          const T ei = tg.s1 * gyr + tg.c1 * gyi;
          ha[0] = ha[0] + er;
          ha[1] = ha[1] + ei;
          hv[0] = hv[0] + er;
          hv[1] = hv[1] + ei;
          d_c1e = gyr * fr + gyi * fi;
          d_s1e = gyr * fi - gyi * fr;
        }
        // the RF mix's coefficients, against the pre-RF state
        T ta[8], tb[8];
        mix_terms(ha, xa, ta);
        mix_terms(hv, xb, tb);
#pragma unroll
        for (int q = 0; q < 8; ++q) km[q] += ta[q] + tb[q];
        T oa[6], ob[6];
        spgr::mix_T(tg, ha, oa);
        spgr::mix_T(tg, hv, ob);
#pragma unroll
        for (int p = 0; p < 6; ++p) {
          h[p][i] = oa[p];
          h[6 + p][i] = ob[p];
        }
      }
      // the sums over the orders: the group adds its lanes
#pragma unroll
      for (int q = 0; q < 12; ++q) kE[q] = lanes::group_sum(kE[q], G);
#pragma unroll
      for (int q = 0; q < 8; ++q) km[q] = lanes::group_sum(km[q], G);
      T rows[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
      if (lead && active) {
        if constexpr (VARTR) {
          // this step's entry gradients, as they are
          T* dp = dpkt + t * 14 * nA + a;
          for (int q = 0; q < 12; ++q) dp[q * nA] = kE[q];
          dp[12 * nA] = d_ra;
          dp[13 * nA] = d_rb;
        } else {
#pragma unroll
          for (int q = 0; q < 12; ++q) acc[q] = acc[q] + kE[q];
          acc[12] = acc[12] + d_ra;
          acc[13] = acc[13] + d_rb;
        }
        // km: [ca2, sc2, ss2, ss, sc, hs, hc, ca]
        const T d_sa2 = tg.c2 * km[1] + tg.s2 * km[2];
        const T d_sa = tg.s1 * (km[3] + T(0.5) * km[5]) +
                       tg.c1 * (km[4] + T(0.5) * km[6]);
        rows[4] = tg.sa * (km[4] + T(0.5) * km[6]) + d_c1e;
        rows[5] = tg.sa * (km[3] + T(0.5) * km[5]) + d_s1e;
        rows[6] = tg.sa2 * km[1];
        rows[7] = tg.sa2 * km[2];
        if (has_b1) {
          // α = flip·b1 through the half-angle trig
          const T d_al = ((T(0.5) * tg.sa) * (d_sa2 - km[0]) + tg.ca * d_sa) -
                         tg.sa * km[7];
          ab1 = ab1 + d_al * coef[8 * nTR + t];
          rows[8] = d_al * b1;
        } else {
          rows[0] = km[0];
          rows[1] = d_sa2;
          rows[2] = d_sa;
          rows[3] = km[7];
        }
      }
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        const T v = lanes::warp_groups_sum(rows[c], G);
        if (writer) dcf[(warp * nTR + t) * 9 + c] = v;
      }
    }
  }
  if (lead && active) {
    T* dm = dpar;  // [dM0a, dM0b, db1]
    if constexpr (!VARTR) {
      for (int q = 0; q < 14; ++q) dpar[q * nA + a] = acc[q];
      dm += 14 * nA;
    }
    // the initial state: M0a on Za(0)'s real part, M0b on Zb(0)'s
    dm[a] = h[4][0];
    dm[nA + a] = h[10][0];
    dm[2 * nA + a] = ab1;
  }
}

template <typename T, int M, bool VARTR>
int launch_lanes_m(const T* coef, const T* par, const T* pkt, const T* chk,
                   const T* gy, T* dpar, T* dcf, T* dpkt, int64_t nA,
                   int64_t nTR, int64_t K, int64_t kshift, int64_t flags,
                   int64_t tc, int lg, void* stream) {
  const int A = lanes::kThreads >> lg;
  const size_t smem =
      (size_t)tc * A * lanes::stride(kPlanes, M, 1 << lg) * sizeof(T);
  if (!lanes::smem_fits(smem)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        xspgr_bwd_lanes_kernel<T, M, VARTR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + A - 1) / A);
  xspgr_bwd_lanes_kernel<T, M, VARTR><<<grid, lanes::kThreads, smem,
                                        (cudaStream_t)stream>>>(
      coef, par, pkt, chk, gy, dpar, dcf, dpkt, nA, nTR, (int)K, (int)kshift,
      (int)flags, tc, lg);
  return (int)cudaGetLastError();
}

// The instances: M 1-3 in float32, 1 in float64 (kernels/epg.py
// LANE_SLOTS_MAX).
template <typename T, bool VARTR>
int launch_xspgr_bwd_lanes(const T* coef, const T* par, const T* pkt,
                           const T* chk, const T* gy, T* dpar, T* dcf,
                           T* dpkt, int64_t nA, int64_t nTR, int64_t K,
                           int64_t kshift, int64_t flags, int64_t tc,
                           int64_t G, int64_t M, void* stream) {
  if (nA <= 0 || nTR <= 0 || K <= 0 || kshift == 0 || tc <= 0 ||
      nTR % tc != 0 || !lanes::valid_cfg(G, M, K) ||
      (VARTR && (pkt == nullptr || dpkt == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int lg = lanes::log2i((int)G);
  if (M == 1)
    return launch_lanes_m<T, 1, VARTR>(coef, par, pkt, chk, gy, dpar, dcf,
                                       dpkt, nA, nTR, K, kshift, flags, tc,
                                       lg, stream);
  if constexpr (sizeof(T) == 4) {
    if (M == 2)
      return launch_lanes_m<T, 2, VARTR>(coef, par, pkt, chk, gy, dpar, dcf,
                                         dpkt, nA, nTR, K, kshift, flags, tc,
                                         lg, stream);
    if (M == 3)
      return launch_lanes_m<T, 3, VARTR>(coef, par, pkt, chk, gy, dpar, dcf,
                                         dpkt, nA, nTR, K, kshift, flags, tc,
                                         lg, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace epgx
}  // namespace mrphy

// Inputs (coef (9, nTR), par (17, nA), chk (nTR / tc, 12, K, nA), g (nA,
// nTR, 2)), the outputs dpar (17, nA) and dcf (⌈nA·G/32⌉, nTR, 9); sizes,
// kshift, flags (1 b1), tc (the block keeps the chunk's tc states in shared
// memory), the lanes per atom G and the slots a lane M = ⌈K/G⌉. Returns the
// cudaError_t of the launch (0 = success; cudaErrorInvalidValue for
// arguments out of range or tc states past the device's shared memory per
// block).
#define MRPHY_XSPGR_BWD_LANES_ENTRY(NAME, T)                                 \
  extern "C" int NAME(const void* coef, const void* par, const void* chk,   \
                      const void* g, void* dpar, void* dcf, int64_t nA,     \
                      int64_t nTR, int64_t K, int64_t kshift, int64_t flags, \
                      int64_t tc, int64_t G, int64_t M, void* stream) {     \
    return mrphy::epgx::launch_xspgr_bwd_lanes<T, false>(                    \
        (const T*)coef, (const T*)par, nullptr, (const T*)chk, (const T*)g,  \
        (T*)dpar, (T*)dcf, nullptr, nA, nTR, K, kshift, flags, tc, G, M,     \
        stream);                                                             \
  }

MRPHY_XSPGR_BWD_LANES_ENTRY(mrphy_xspgr_bwd_lanes_f32, float)
MRPHY_XSPGR_BWD_LANES_ENTRY(mrphy_xspgr_bwd_lanes_f64, double)

// The variable-TR train: inputs coef (9, nTR), pk (3, nA) = [M0a, M0b, b1],
// the planes pkt (nTR, 14, nA), chk and g as above; the outputs dpar (3,
// nA) = [dM0a, dM0b, db1], dcf as above and dpkt (nTR, 14, nA).
#define MRPHY_XSPGR_V_BWD_LANES_ENTRY(NAME, T)                               \
  extern "C" int NAME(const void* coef, const void* pk, const void* pkt,    \
                      const void* chk, const void* g, void* dpar,           \
                      void* dcf, void* dpkt, int64_t nA, int64_t nTR,       \
                      int64_t K, int64_t kshift, int64_t flags, int64_t tc, \
                      int64_t G, int64_t M, void* stream) {                  \
    return mrphy::epgx::launch_xspgr_bwd_lanes<T, true>(                     \
        (const T*)coef, (const T*)pk, (const T*)pkt, (const T*)chk,          \
        (const T*)g, (T*)dpar, (T*)dcf, (T*)dpkt, nA, nTR, K, kshift, flags, \
        tc, G, M, stream);                                                   \
  }

MRPHY_XSPGR_V_BWD_LANES_ENTRY(mrphy_xspgr_v_bwd_lanes_f32, float)
MRPHY_XSPGR_V_BWD_LANES_ENTRY(mrphy_xspgr_v_bwd_lanes_f64, double)
