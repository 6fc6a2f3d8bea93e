// xcpmg_bwd_lanes: K27 `xcpmg_bwd` and, as its echo-spacing-train
// instance, K30 `xcpmg_v_bwd`, the two-phase chunk adjoint of the two-pool
// EPG-X CPMG echo train, on their lane route: a group of G lanes per atom
// over the orders, the chunk's states kept in shared memory (Hopper,
// sm_90a).
//
// Replaces the TPU kernels `_xcpmg_bwd_kernel` (launched by
// `_xcpmg_core_bwd`) and `_xcv_bwd_kernel` (`_xcpmg_core_v_bwd`) of
// mrphy_tpu/ops/epg_pallas.py, as xcpmg_bwd.cu does; the wrapper
// (kernels/epg.py `adjoint_cfg`) takes this route where an atom's orders fit
// M ≤ 3 slots a lane (float32; 1 in float64) of G = 8, 16 or 32 lanes and
// the chunk's tc states fit the S that shared memory holds, and
// xcpmg_bwd.cu's one-thread-per-atom route otherwise (K > 96, float64
// K > 32: the 32-echo train's K 33 in float64 among them). The entry points
// (kernels/epgx.py `_adjoint_chunk`) cap tc at S.
//
// What bounds it on the H100: arithmetic (~3× the forward's per order and
// echo), then reading the checkpoints once (3.3 GB at 262,144 atoms × 32
// echoes × K 33, tc 4, in float32). The one-thread route ran ~4 warps an SM
// with 12·K values a thread in shared memory and passed every chunk state
// through a device-memory scratch (36 GB at that shape).
//
// Design (epg_lanes.cuh). Lane l of the group holds orders l + i·G of both
// pools; phase 1's state and the adjoint h live in registers; the
// exchange–relaxation, the refocusing mix and their transposes act on one
// order at a time, so each lane does its own; the crushers' unit shift and
// its transpose are shuffles. Under b1 an echo's refocusing trig costs
// transcendentals: lane l forms that of the chunk's echo l (tc ≤ S ≤ 8 ≤
// G) and the group shares it by shuffles. Per chunk,
// newest first: the block reads the chunk's checkpoint once, coalesced
// along the atoms, into slot 0 of its shared states; phase 1 runs the
// forward from it in registers (per echo: half, mix, half, the lane
// forward's steps of epgx_lanes.cuh) and stores the tc − 1 later pre-echo
// states into slots 1 … tc − 1; phase 2 walks them
// backwards as xcpmg_bwd.cu does: the refocusing's input formed again,
// order by order, from the stored state's neighbouring orders in shared
// memory (`epgx::xhalf_at`, as xcpmg_bwd.cu; no registers held for it, no
// shuffles), the echo's cotangent into both pools' F+(0), the shift's
// transpose, the exchange–relaxation's transpose at the mixed state, the
// mix's coefficient terms and transpose, the shift's transpose, the
// exchange–relaxation's transpose at the stored state. Each lane sums its
// own orders' terms: the 5 mix rows per echo, which the group adds in a
// fixed order (kernels/epg.py `_lane_sum`); the 14 entries' contractions
// at a fixed spacing in one sum per lane over both halves of every echo,
// which the group adds once at the end, and over an echo-spacing train
// (VARESP) per echo over both halves, written per echo to dpkt. The plain
// versions (kernels/epgx.py `_xcpmg_bwd`) take the same orders, so per-atom
// outputs agree bit for bit (built without FMA contraction). Outputs as
// xcpmg_bwd.cu's, but dcf (⌈nA·G/32⌉, nE, 5): a warp holds 32/G atoms and
// sums their per-echo rows by shuffles; the wrapper sums over warps in a
// fixed order.
#include "epgx_lanes.cuh"

namespace mrphy {
namespace xcpmg {

// x at a fixed spacing, y over a train.
template <bool Y, typename A>
__device__ __forceinline__ A& pick(A& x, A& y) {
  if constexpr (Y)
    return y;
  else
    return x;
}

// pk: (19, nA) at a fixed echo spacing; over an echo-spacing train
// (VARESP) the rows [cos φ_ex, sin φ_ex, M0a, M0b, b1] (5, nA), the entries
// of echo t at pkt + t·14·nA and their contractions at dpkt + t·14·nA.
template <typename T, int M, bool VARESP>
__global__ void __launch_bounds__(lanes::kThreads)
    xcpmg_bwd_lanes_kernel(const T* __restrict__ coef,
                           const T* __restrict__ pk,
                           const T* __restrict__ pkt,
                           const T* __restrict__ chk,
                           const T* __restrict__ gr,
                           const T* __restrict__ gi, T* __restrict__ dpar,
                           T* __restrict__ dcf, T* __restrict__ dpkt,
                           int64_t nA, int64_t nE, int K, int flags,
                           int64_t tc, int lg) {
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
  const bool has_b1 = flags & cpmg::kB1;
  const int st_atom = lanes::stride(kPlanes, M, G);
  const int st_slot = st_atom << lgA;
  T* const mine = slots + ab * st_atom;  // slot s at mine + s·st_slot
  lanes::zero(slots, (int)tc * st_slot);
  // [cos φ_ex, sin φ_ex, M0a, M0b, b1]
  const T* pm = VARESP ? pk : pk + 14 * nA;
  Prop<T> e{};
  T b1 = 0;
  if (active) {
    if constexpr (!VARESP) e = epgx::load_prop(pk, nA, a);
    b1 = pm[4 * nA + a];
  }
  T h[kPlanes][M];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p)
#pragma unroll
    for (int i = 0; i < M; ++i) h[p][i] = T(0);
  // at a fixed spacing the lane's sums of the 12 entries' terms over its
  // orders, both halves of every echo; lane 0's ∂ra and ∂rb
  T acc[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) acc[q] = T(0);
  T ara = 0, arb = 0, ab1 = 0;
  // the echoes' cotangent, read one echo ahead (echoes newest first)
  const bool feed = lead && active;
  T gyr_t = feed ? gr[(nE - 1) * nA + a] : T(0);
  T gyi_t = feed ? gi[(nE - 1) * nA + a] : T(0);
  const int64_t plane = (int64_t)kPlanes * K * nA;
  const int64_t ntc = nE / tc;
  for (int64_t j = ntc - 1; j >= 0; --j) {
    __syncthreads();  // every group is done with the last chunk's slots
    lanes::stage(chk + j * plane, slots, nA, a0, lgA, kPlanes, K, M, lg,
                 st_atom);
    cpmg::Trig<T> own{};
    if (has_b1 && g.l < tc)
      own = cpmg::trig(coef, nE, j * tc + g.l, b1, true);
    auto trig_at = [&](int64_t tl) {
      return has_b1 ? trig_from(own, (int)tl, G)
                    : cpmg::trig(coef, nE, j * tc + tl, b1, false);
    };
    __syncthreads();
    // phase 1: the forward from the chunk's start state, every state
    {
      T x[kPlanes][M];
      lanes::load(mine, x, g);
      for (int64_t tl = 1; tl < tc; ++tl) {
        const int64_t t = j * tc + tl - 1;
        const cpmg::Trig<T> tg = trig_at(tl - 1);
        if constexpr (VARESP)
          if (active) e = epgx::load_prop(pkt + t * 14 * nA, nA, a);
        xhalf_lanes(x, e, g);
        xmix_lanes(x, tg, g);
        xhalf_lanes(x, e, g);
        lanes::store(mine + tl * st_slot, x, g);
      }
    }
    // phase 2: the cotangent, backwards through the stored states
    for (int64_t tl = tc - 1; tl >= 0; --tl) {
      const int64_t t = j * tc + tl;
      const cpmg::Trig<T> tg = trig_at(tl);
      const T gyr = gyr_t, gyi = gyi_t;
      gyr_t = feed && t > 0 ? gr[(t - 1) * nA + a] : T(0);
      gyi_t = feed && t > 0 ? gi[(t - 1) * nA + a] : T(0);
      if constexpr (VARESP)
        if (active) e = epgx::load_prop(pkt + t * 14 * nA, nA, a);
      const T* const x0 = mine + tl * st_slot;  // the pre-echo state
      // the echo reads both pools' F+(0) after the second half
      if (lead) {
        h[0][0] = h[0][0] + gyr;
        h[1][0] = h[1][0] + gyi;
        h[6][0] = h[6][0] + gyr;
        h[7][0] = h[7][0] + gyi;
      }
      lanes::shift_pool<0, true>(h, 1, g);
      lanes::shift_pool<6, true>(h, 1, g);
      // the second half's transpose at the mix's output s1, then the mix's
      // coefficients (against its input sh, the first half formed again
      // from the stored state) and its transpose; each lane's orders summed
      // in slot order
      T kEv[12];  // over a train: this echo's
#pragma unroll
      for (int q = 0; q < 12; ++q) kEv[q] = T(0);
      T (&kE)[12] = pick<VARESP>(acc, kEv);
      T km[5] = {0, 0, 0, 0, 0};
      T dra2 = 0, drb2 = 0, dra1 = 0, drb1 = 0;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (!g.valid(i)) continue;
        const int k = g.order(i);
        T sha[6], shb[6];
        epgx::xhalf_at(x0, M * G, 1, K, k, e, sha, shb);
        T s1a[6], s1b[6];
        cpmg::mix0(tg, sha, s1a);
        cpmg::mix0(tg, shb, s1b);
        T ha[6] = {h[0][i], h[1][i], h[2][i], h[3][i], h[4][i], h[5][i]};
        T hv[6] = {h[6][i], h[7][i], h[8][i], h[9][i], h[10][i], h[11][i]};
        epgx::xrelax_T(e, k, s1a, s1b, ha, hv, kE, dra2, drb2);
        T ta[5], tb[5];
        cpmg::mix0_terms(ha, sha, ta);
        cpmg::mix0_terms(hv, shb, tb);
#pragma unroll
        for (int q = 0; q < 5; ++q) km[q] += ta[q] + tb[q];
        T oa[6], ob[6];
        cpmg::mix0_T(tg, ha, oa);
        cpmg::mix0_T(tg, hv, ob);
#pragma unroll
        for (int p = 0; p < 6; ++p) {
          h[p][i] = oa[p];
          h[6 + p][i] = ob[p];
        }
      }
      // the first half's transpose at the stored pre-echo state
      lanes::shift_pool<0, true>(h, 1, g);
      lanes::shift_pool<6, true>(h, 1, g);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (!g.valid(i)) continue;
        T xa[6], xb[6];
#pragma unroll
        for (int p = 0; p < 6; ++p) {
          xa[p] = x0[(p * M + i) * G + g.l];
          xb[p] = x0[((6 + p) * M + i) * G + g.l];
        }
        T ha[6] = {h[0][i], h[1][i], h[2][i], h[3][i], h[4][i], h[5][i]};
        T hv[6] = {h[6][i], h[7][i], h[8][i], h[9][i], h[10][i], h[11][i]};
        epgx::xrelax_T(e, g.order(i), xa, xb, ha, hv, kE, dra1, drb1);
#pragma unroll
        for (int p = 0; p < 6; ++p) {
          h[p][i] = ha[p];
          h[6 + p][i] = hv[p];
        }
      }
      // the sums over the orders: the group adds its lanes
#pragma unroll
      for (int q = 0; q < 5; ++q) km[q] = lanes::group_sum(km[q], G);
      if constexpr (VARESP) {
#pragma unroll
        for (int q = 0; q < 12; ++q) kEv[q] = lanes::group_sum(kEv[q], G);
      }
      T rows[5] = {0, 0, 0, 0, 0};
      if (lead && active) {
        if constexpr (VARESP) {
          // this echo's entry gradients, both halves
          T* dp = dpkt + t * 14 * nA + a;
          for (int q = 0; q < 12; ++q) dp[q * nA] = kEv[q];
          dp[12 * nA] = dra2 + dra1;
          dp[13 * nA] = drb2 + drb1;
        } else {
          ara = (ara + dra2) + dra1;
          arb = (arb + drb2) + drb1;
        }
        // km: [ca2, sa2, sc, hc, ca] of the refocusing about +x
        const T d_sa = km[2] + T(0.5) * km[3];
        if (has_b1) {
          // α = flip·b1 through the half-angle trig
          const T d_al = ((T(0.5) * tg.sa) * (km[1] - km[0]) + tg.ca * d_sa) -
                         tg.sa * km[4];
          ab1 = ab1 + d_al * coef[4 * nE + t];
          rows[4] = d_al * b1;
        } else {
          rows[0] = km[0];
          rows[1] = km[1];
          rows[2] = d_sa;
          rows[3] = km[4];
        }
      }
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        const T v = lanes::warp_groups_sum(rows[c], G);
        if (writer) dcf[(warp * nE + t) * 5 + c] = v;
      }
    }
  }
  if constexpr (!VARESP) {
#pragma unroll
    for (int q = 0; q < 12; ++q) acc[q] = lanes::group_sum(acc[q], G);
  }
  if (lead && active) {
    T* dm = dpar;  // [d cos φ_ex, d sin φ_ex, dM0a, dM0b, db1]
    if constexpr (!VARESP) {
      for (int q = 0; q < 12; ++q) dpar[q * nA + a] = acc[q];
      dpar[12 * nA + a] = ara;
      dpar[13 * nA + a] = arb;
      dm += 14 * nA;
    }
    // the excitation's state: per pool F+(0) = (exs, −exc)·M0p, F−(0) =
    // (exs, exc)·M0p
    const T exc = pm[a], exs = pm[nA + a], M0a = pm[2 * nA + a],
            M0b = pm[3 * nA + a];
    const T ra_ = h[0][0] + h[2][0], ia_ = -h[1][0] + h[3][0];
    const T rb_ = h[6][0] + h[8][0], ib_ = -h[7][0] + h[9][0];
    dm[a] = M0a * ia_ + M0b * ib_;
    dm[nA + a] = M0a * ra_ + M0b * rb_;
    dm[2 * nA + a] = exs * ra_ + exc * ia_;
    dm[3 * nA + a] = exs * rb_ + exc * ib_;
    dm[4 * nA + a] = ab1;
  }
}

template <typename T, int M, bool VARESP>
int launch_lanes_m(const T* coef, const T* pk, const T* pkt, const T* chk,
                   const T* gr, const T* gi, T* dpar, T* dcf, T* dpkt,
                   int64_t nA, int64_t nE, int64_t K, int64_t flags,
                   int64_t tc, int lg, void* stream) {
  const int G = 1 << lg, A = lanes::kThreads >> lg;
  if (tc > lanes::max_states(kPlanes, M, G, (int)sizeof(T)))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)tc * A * lanes::stride(kPlanes, M, G) * sizeof(T);
  if (!lanes::smem_fits(smem)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        xcpmg_bwd_lanes_kernel<T, M, VARESP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + A - 1) / A);
  xcpmg_bwd_lanes_kernel<T, M, VARESP><<<grid, lanes::kThreads, smem,
                                         (cudaStream_t)stream>>>(
      coef, pk, pkt, chk, gr, gi, dpar, dcf, dpkt, nA, nE, (int)K,
      (int)flags, tc, lg);
  return (int)cudaGetLastError();
}

// The instances: M 1-3 in float32, 1 in float64 (kernels/epg.py
// LANE_SLOTS_MAX).
template <typename T, bool VARESP>
int launch_xcpmg_bwd_lanes(const T* coef, const T* pk, const T* pkt,
                           const T* chk, const T* gr, const T* gi, T* dpar,
                           T* dcf, T* dpkt, int64_t nA, int64_t nE,
                           int64_t K, int64_t flags, int64_t tc, int64_t G,
                           int64_t M, void* stream) {
  if (nA <= 0 || nE <= 0 || K < 2 || tc <= 0 || nE % tc != 0 ||
      (flags & ~(int64_t)cpmg::kB1) != 0 || !lanes::valid_cfg(G, M, K) ||
      (VARESP && (pkt == nullptr || dpkt == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int lg = lanes::log2i((int)G);
  if (M == 1)
    return launch_lanes_m<T, 1, VARESP>(coef, pk, pkt, chk, gr, gi, dpar,
                                        dcf, dpkt, nA, nE, K, flags, tc, lg,
                                        stream);
  if constexpr (sizeof(T) == 4) {
    if (M == 2)
      return launch_lanes_m<T, 2, VARESP>(coef, pk, pkt, chk, gr, gi, dpar,
                                          dcf, dpkt, nA, nE, K, flags, tc,
                                          lg, stream);
    if (M == 3)
      return launch_lanes_m<T, 3, VARESP>(coef, pk, pkt, chk, gr, gi, dpar,
                                          dcf, dpkt, nA, nE, K, flags, tc,
                                          lg, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace xcpmg
}  // namespace mrphy

// Inputs (coef (5, nE), pk (19, nA), chk (nE / tc, 12, K, nA), gr, gi (nE,
// nA)), the outputs dpar (19, nA) and dcf (⌈nA·G/32⌉, nE, 5); sizes, flags
// (1 b1), tc (the block keeps the chunk's tc states in shared memory), the
// lanes per atom G and the slots a lane M = ⌈K/G⌉. Returns the cudaError_t
// of the launch (0 = success; cudaErrorInvalidValue for arguments out of
// range, tc past the S states of kernels/epg.py `lane_capacity` or shared
// memory past the device's limit per block).
#define MRPHY_XCPMG_BWD_LANES_ENTRY(NAME, T)                                  \
  extern "C" int NAME(const void* coef, const void* pk, const void* chk,     \
                      const void* gr, const void* gi, void* dpar, void* dcf, \
                      int64_t nA, int64_t nE, int64_t K, int64_t flags,      \
                      int64_t tc, int64_t G, int64_t M, void* stream) {      \
    return mrphy::xcpmg::launch_xcpmg_bwd_lanes<T, false>(                    \
        (const T*)coef, (const T*)pk, nullptr, (const T*)chk, (const T*)gr,   \
        (const T*)gi, (T*)dpar, (T*)dcf, nullptr, nA, nE, K, flags, tc, G, M, \
        stream);                                                              \
  }

MRPHY_XCPMG_BWD_LANES_ENTRY(mrphy_xcpmg_bwd_lanes_f32, float)
MRPHY_XCPMG_BWD_LANES_ENTRY(mrphy_xcpmg_bwd_lanes_f64, double)

// The echo-spacing train: inputs coef (5, nE), pk (5, nA) = [cos φ_ex,
// sin φ_ex, M0a, M0b, b1], the planes pkt (nE, 14, nA), chk, gr and gi as
// above; the outputs dpar (5, nA), dcf as above and dpkt (nE, 14, nA).
#define MRPHY_XCPMG_V_BWD_LANES_ENTRY(NAME, T)                                \
  extern "C" int NAME(const void* coef, const void* pk, const void* pkt,     \
                      const void* chk, const void* gr, const void* gi,       \
                      void* dpar, void* dcf, void* dpkt, int64_t nA,         \
                      int64_t nE, int64_t K, int64_t flags, int64_t tc,      \
                      int64_t G, int64_t M, void* stream) {                  \
    return mrphy::xcpmg::launch_xcpmg_bwd_lanes<T, true>(                     \
        (const T*)coef, (const T*)pk, (const T*)pkt, (const T*)chk,           \
        (const T*)gr, (const T*)gi, (T*)dpar, (T*)dcf, (T*)dpkt, nA, nE, K,   \
        flags, tc, G, M, stream);                                             \
  }

MRPHY_XCPMG_V_BWD_LANES_ENTRY(mrphy_xcpmg_v_bwd_lanes_f32, float)
MRPHY_XCPMG_V_BWD_LANES_ENTRY(mrphy_xcpmg_v_bwd_lanes_f64, double)
