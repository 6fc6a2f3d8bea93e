// xmt_bwd_lanes: K33 `xmt_bwd` and, as its variable-TR instance, K36
// `xmt_v_bwd`, the two-phase chunk adjoint of the EPG-X(MT)
// gradient-spoiled train, on their lane route: a group of G lanes per atom
// over the orders, the chunk's states kept in shared memory (Hopper,
// sm_90a).
//
// Replaces the TPU kernels `_mt_bwd_kernel` (launched by `_mt_core_bwd`)
// and `_mtv_bwd_kernel` (`_mt_core_v_bwd`) of mrphy_tpu/ops/epg_pallas.py,
// as xmt_bwd.cu does; the wrapper (kernels/epg.py `adjoint_cfg` at 8
// planes) takes this route where an atom's orders fit the slots a lane
// (kernels/epg.py LANE_SLOTS_MAX) of G = 8, 16 or 32 lanes and the chunk's
// tc states fit the S that shared memory holds, and xmt_bwd.cu's
// one-thread-per-atom route otherwise (the default K 401; a chunk past S).
// The entry points (kernels/epgx.py `_mt_chunk`) cap tc at S.
//
// What bounds it on the H100: arithmetic (~4× the forward's per order and
// TR), then reading the checkpoints once (8.05 GB at 65,536 atoms × 400
// TRs, K 48, tc 5, in float32). The one-thread route ran 4 warps an SM with
// the adjoint's 8·K values a thread in shared memory and passed every
// chunk state through a device-memory scratch, ~80 GB of traffic there.
//
// Design (epg_lanes.cuh, epgx_lanes.cuh `xmt::mt_step_lanes`). Lane l of
// the group holds orders l + i·G of the 8 planes (pool a's F+, F−, Z, re
// and im, and the bound pool's Z pair); the pre-RF state and the adjoint h
// live in registers; the RF mix with the saturation, the
// exchange–relaxation and their transposes act on one order at a time, so
// each lane does its own; pool a's shift by kshift and its transpose are
// shuffles (in pieces where |kshift| ≥ G). Per chunk, newest first: the
// block reads the chunk's checkpoint once, coalesced along the atoms, into
// slot 0 of its shared states; phase 1 runs the forward from it in
// registers and stores the tc − 1 later pre-RF states into slots 1 … tc −
// 1; phase 2 walks them backwards as xmt_bwd.cu does (the shift's
// transpose, the exchange–relaxation's transpose at the mixed state with
// its 7 entry contractions, the echo's cotangent into Fa+(0), the
// saturation's term, pool a's mix coefficient terms and transpose). Each
// lane sums its own orders' terms in slot order, the group adds its lanes
// in a fixed order (kernels/epg.py `_lane_sum`, which the plain versions
// take too), so per-atom outputs agree bit for bit (built without FMA
// contraction). The echoes' cotangent and, over a variable-TR train
// (VARTR), each TR's 7 entries are read one TR ahead; the train's 7
// contractions of each TR are written to dpkt. Outputs as xmt_bwd.cu's,
// but dcf (⌈nA·G/32⌉, nTR, 10): a warp holds 32/G atoms and sums their
// per-TR rows by shuffles; the wrapper sums over warps in a fixed order.
// No device scratch.
#include "epgx_lanes.cuh"

namespace mrphy {
namespace xmt {

// pk: (11, nA) at a fixed TR; over a variable-TR train (VARTR) the rows
// [M0a, M0b, b1, wscale] (4, nA), the entries of TR t at pkt + t·7·nA and
// their contractions at dpkt + t·7·nA; dpk likewise (11 or 4 rows).
template <typename T, int M, bool VARTR>
__global__ void __launch_bounds__(lanes::kThreads)
    xmt_bwd_lanes_kernel(const T* __restrict__ coef,
                         const T* __restrict__ pk, const T* __restrict__ pkt,
                         const T* __restrict__ chk, const T* __restrict__ gy,
                         T* __restrict__ dpk, T* __restrict__ dcf,
                         T* __restrict__ dpkt, int64_t nA, int64_t nTR, int K,
                         int kshift, int flags, int64_t tc, int lg) {
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
  T b1 = 0, wsc = 0;
  if (active) {
    if constexpr (!VARTR) e = load_prop(pk, nA, a);
    const T* pm = VARTR ? pk : pk + 7 * nA;  // [M0a, M0b, b1, wscale]
    b1 = pm[2 * nA + a];
    wsc = pm[3 * nA + a];
  }
  T h[kPlanes][M];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p)
#pragma unroll
    for (int i = 0; i < M; ++i) h[p][i] = T(0);
  T acc[7];
#pragma unroll
  for (int q = 0; q < 7; ++q) acc[q] = T(0);
  T ab1 = 0, awsc = 0;
  // the echoes' cotangent and (VARTR) the TR's entries, read one TR ahead
  // (TRs newest first)
  const bool feed = lead && active;
  T gyr_t = feed ? gy[(a * nTR + nTR - 1) * 2] : T(0);
  T gyi_t = feed ? gy[(a * nTR + nTR - 1) * 2 + 1] : T(0);
  Prop<T> e_t{};
  if constexpr (VARTR)
    if (active) e_t = load_prop(pkt + (nTR - 1) * 7 * nA, nA, a);
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
        if (active && tc > 1) e_f = load_prop(pkt + j * tc * 7 * nA, nA, a);
      for (int64_t tl = 1; tl < tc; ++tl) {
        const int64_t t = j * tc + tl - 1;
        const Trig<T> tg = spgr::trig(coef, nTR, t, b1, has_b1);
        const T sat = saturation(coef, nTR, t, wsc);
        if constexpr (VARTR) {
          e = e_f;
          if (active && tl + 1 < tc)
            e_f = load_prop(pkt + (t + 1) * 7 * nA, nA, a);
        }
        mt_step_lanes(x, tg, sat, e, kshift, g);
        lanes::store(mine + tl * st_slot, x, g);
      }
    }
    // phase 2: the cotangent, backwards through the stored states
    for (int64_t tl = tc - 1; tl >= 0; --tl) {
      const int64_t t = j * tc + tl;
      const Trig<T> tg = spgr::trig(coef, nTR, t, b1, has_b1);
      const T wtt = coef[9 * nTR + t];
      const T sat = saturation(coef, nTR, t, wsc);
      const T gyr = gyr_t, gyi = gyi_t;
      gyr_t = feed && t > 0 ? gy[(a * nTR + t - 1) * 2] : T(0);
      gyi_t = feed && t > 0 ? gy[(a * nTR + t - 1) * 2 + 1] : T(0);
      if constexpr (VARTR) {
        e = e_t;
        if (active && t > 0) e_t = load_prop(pkt + (t - 1) * 7 * nA, nA, a);
      }
      const T* const x0 = mine + tl * st_slot;  // the pre-RF state
      lanes::shift_pool<0, true>(h, kshift, g);
      // each lane's orders, summed in slot order: the 5 entry terms, the
      // saturation's, pool a's 8 mix coefficient terms
      T kE[5] = {0, 0, 0, 0, 0}, km[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      T ksat = 0, d_ra = 0, d_rb = 0, d_c1e = 0, d_s1e = 0;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (!g.valid(i)) continue;
        const int k = g.order(i);
        T x[8];
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) x[p] = x0[(p * M + i) * G + g.l];
        T s1[8];
        mt_mix(tg, sat, x, s1);
        T hv[8];
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) hv[p] = h[p][i];
        // the exchange-relaxation's transpose at the mixed state
        mt_relax_T(e, k, s1, hv, kE, d_ra, d_rb);
        if (k == 0 && active) {
          // the echo's cotangent (the echo reads the mixed state)
          hv[0] = hv[0] + (tg.c1 * gyr - tg.s1 * gyi);
          hv[1] = hv[1] + (tg.s1 * gyr + tg.c1 * gyi);
          d_c1e = gyr * s1[0] + gyi * s1[1];
          d_s1e = gyr * s1[1] - gyi * s1[0];
        }
        // the saturation's term, then pool a's mix coefficients against
        // the pre-RF state
        ksat += hv[6] * x[6] + hv[7] * x[7];
        const T ha[6] = {hv[0], hv[1], hv[2], hv[3], hv[4], hv[5]};
        const T xa[6] = {x[0], x[1], x[2], x[3], x[4], x[5]};
        T ta[8];
        epgx::mix_terms(ha, xa, ta);
#pragma unroll
        for (int q = 0; q < 8; ++q) km[q] += ta[q];
        T o[6];
        spgr::mix_T(tg, ha, o);
#pragma unroll
        for (int p = 0; p < 6; ++p) h[p][i] = o[p];
        h[6][i] = sat * hv[6];
        h[7][i] = sat * hv[7];
      }
      // the sums over the orders: the group adds its lanes
#pragma unroll
      for (int q = 0; q < 5; ++q) kE[q] = lanes::group_sum(kE[q], G);
      ksat = lanes::group_sum(ksat, G);
#pragma unroll
      for (int q = 0; q < 8; ++q) km[q] = lanes::group_sum(km[q], G);
      T rows[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
      if (lead && active) {
        if constexpr (VARTR) {
          // this TR's entry gradients, as they are
          T* dp = dpkt + t * 7 * nA + a;
          for (int q = 0; q < 4; ++q) dp[q * nA] = kE[q];
          dp[4 * nA] = d_ra;
          dp[5 * nA] = d_rb;
          dp[6 * nA] = kE[4];
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = acc[q] + kE[q];
          acc[4] = acc[4] + d_ra;
          acc[5] = acc[5] + d_rb;
          acc[6] = acc[6] + kE[4];
        }
        awsc = awsc + (-wtt * sat) * ksat;
        // km: [ca2, sc2, ss2, ss, sc, hs, hc, ca]
        const T d_sa2 = tg.c2 * km[1] + tg.s2 * km[2];
        const T d_sa = tg.s1 * (km[3] + T(0.5) * km[5]) +
                       tg.c1 * (km[4] + T(0.5) * km[6]);
        rows[4] = tg.sa * (km[4] + T(0.5) * km[6]) + d_c1e;
        rows[5] = tg.sa * (km[3] + T(0.5) * km[5]) + d_s1e;
        rows[6] = tg.sa2 * km[1];
        rows[7] = tg.sa2 * km[2];
        rows[9] = (-wsc * sat) * ksat;
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
      for (int c = 0; c < 10; ++c) {
        const T v = lanes::warp_groups_sum(rows[c], G);
        if (writer) dcf[(warp * nTR + t) * 10 + c] = v;
      }
    }
  }
  if (lead && active) {
    T* dm = dpk;  // [dM0a, dM0b, db1, dwscale]
    if constexpr (!VARTR) {
      for (int q = 0; q < 7; ++q) dpk[q * nA + a] = acc[q];
      dm += 7 * nA;
    }
    // the initial state: M0a on Za(0)'s real part, M0b on Zb(0)'s
    dm[a] = h[4][0];
    dm[nA + a] = h[6][0];
    dm[2 * nA + a] = ab1;
    dm[3 * nA + a] = awsc;
  }
}

// The largest M built (kernels/epg.py LANE_SLOTS_MAX at 8 planes).
template <typename T>
constexpr int kSlotsMax = sizeof(T) == 4 ? 5 : 3;

// The launch at M slots a lane: the instances are M 1 … kSlotsMax, each
// passing a run-time M it is not on to the next.
template <typename T, bool VARTR, int M = 1>
int launch_lanes_m(int64_t m, const T* coef, const T* pk, const T* pkt,
                   const T* chk, const T* gy, T* dpk, T* dcf, T* dpkt,
                   int64_t nA, int64_t nTR, int64_t K, int64_t kshift,
                   int64_t flags, int64_t tc, int lg, void* stream) {
  if (m != M) {
    if constexpr (M < kSlotsMax<T>)
      return launch_lanes_m<T, VARTR, M + 1>(m, coef, pk, pkt, chk, gy, dpk,
                                             dcf, dpkt, nA, nTR, K, kshift,
                                             flags, tc, lg, stream);
    else
      return (int)cudaErrorInvalidValue;
  }
  const int G = 1 << lg, A = lanes::kThreads >> lg;
  if (tc > lanes::max_states(kPlanes, M, G, (int)sizeof(T)))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)tc * A * lanes::stride(kPlanes, M, G) * sizeof(T);
  if (!lanes::smem_fits(smem)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        xmt_bwd_lanes_kernel<T, M, VARTR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + A - 1) / A);
  xmt_bwd_lanes_kernel<T, M, VARTR><<<grid, lanes::kThreads, smem,
                                      (cudaStream_t)stream>>>(
      coef, pk, pkt, chk, gy, dpk, dcf, dpkt, nA, nTR, (int)K, (int)kshift,
      (int)flags, tc, lg);
  return (int)cudaGetLastError();
}

template <typename T, bool VARTR>
int launch_xmt_bwd_lanes(const T* coef, const T* pk, const T* pkt,
                         const T* chk, const T* gy, T* dpk, T* dcf, T* dpkt,
                         int64_t nA, int64_t nTR, int64_t K, int64_t kshift,
                         int64_t flags, int64_t tc, int64_t G, int64_t M,
                         void* stream) {
  if (nA <= 0 || nTR <= 0 || K <= 0 || kshift == 0 || tc <= 0 ||
      nTR % tc != 0 || !lanes::valid_cfg(G, M, K) ||
      (VARTR && (pkt == nullptr || dpkt == nullptr)))
    return (int)cudaErrorInvalidValue;
  return launch_lanes_m<T, VARTR>(M, coef, pk, pkt, chk, gy, dpk, dcf, dpkt,
                                  nA, nTR, K, kshift, flags, tc,
                                  lanes::log2i((int)G), stream);
}

}  // namespace xmt
}  // namespace mrphy

// Inputs (coef (10, nTR), pk (11, nA), chk (nTR / tc, 8, K, nA), g (nA,
// nTR, 2)), the outputs dpk (11, nA) and dcf (⌈nA·G/32⌉, nTR, 10); sizes,
// kshift, flags (1 b1), tc (the block keeps the chunk's tc states in shared
// memory), the lanes per atom G and the slots a lane M = ⌈K/G⌉. Returns the
// cudaError_t of the launch (0 = success; cudaErrorInvalidValue for
// arguments out of range, an M past the instances, tc past the S states
// (lanes::max_states) or tc states past the device's shared memory per
// block).
#define MRPHY_XMT_BWD_LANES_ENTRY(NAME, T)                                   \
  extern "C" int NAME(const void* coef, const void* pk, const void* chk,    \
                      const void* g, void* dpk, void* dcf, int64_t nA,      \
                      int64_t nTR, int64_t K, int64_t kshift, int64_t flags, \
                      int64_t tc, int64_t G, int64_t M, void* stream) {     \
    return mrphy::xmt::launch_xmt_bwd_lanes<T, false>(                       \
        (const T*)coef, (const T*)pk, nullptr, (const T*)chk, (const T*)g,   \
        (T*)dpk, (T*)dcf, nullptr, nA, nTR, K, kshift, flags, tc, G, M,      \
        stream);                                                             \
  }

MRPHY_XMT_BWD_LANES_ENTRY(mrphy_xmt_bwd_lanes_f32, float)
MRPHY_XMT_BWD_LANES_ENTRY(mrphy_xmt_bwd_lanes_f64, double)

// The variable-TR train: inputs coef (10, nTR), pk (4, nA) = [M0a, M0b,
// b1, wscale], the planes pkt (nTR, 7, nA), chk and g as above; the outputs
// dpk (4, nA) = [dM0a, dM0b, db1, dwscale], dcf as above and dpkt (nTR, 7,
// nA).
#define MRPHY_XMT_V_BWD_LANES_ENTRY(NAME, T)                                 \
  extern "C" int NAME(const void* coef, const void* pk, const void* pkt,    \
                      const void* chk, const void* g, void* dpk, void* dcf, \
                      void* dpkt, int64_t nA, int64_t nTR, int64_t K,       \
                      int64_t kshift, int64_t flags, int64_t tc, int64_t G, \
                      int64_t M, void* stream) {                             \
    return mrphy::xmt::launch_xmt_bwd_lanes<T, true>(                        \
        (const T*)coef, (const T*)pk, (const T*)pkt, (const T*)chk,          \
        (const T*)g, (T*)dpk, (T*)dcf, (T*)dpkt, nA, nTR, K, kshift, flags,  \
        tc, G, M, stream);                                                   \
  }

MRPHY_XMT_V_BWD_LANES_ENTRY(mrphy_xmt_v_bwd_lanes_f32, float)
MRPHY_XMT_V_BWD_LANES_ENTRY(mrphy_xmt_v_bwd_lanes_f64, double)
