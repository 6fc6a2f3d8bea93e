// spgr_bwd_lanes: K15 `spgr_bwd`, the two-phase chunk adjoint of the SPGR /
// MRF-FISP EPG train, on its lane route: a group of G lanes per atom over
// the orders, the chunk's states kept in shared memory (Hopper, sm_90a).
//
// Replaces the TPU kernel `_spgr_bwd_kernel` (launched by `_spgr_bwd`,
// mrphy_tpu/ops/epg_pallas.py), as spgr_bwd.cu does; the wrapper
// (kernels/epg.py `adjoint_cfg`) takes this route where an atom's orders fit
// M ≤ 5 slots a lane (float32; 2 in float64) of G = 8, 16 or 32 lanes and
// the chunk's tc states fit the S that shared memory holds, and
// spgr_bwd.cu's one-thread-per-atom route otherwise (K > 160, float64
// K > 64). The entry point (kernels/epg.py `adjoint_tc`) caps tc at S.
//
// What bounds it on the H100: arithmetic (~2.5× the forward's per order
// and TR), then reading the checkpoints once (6.04 GB at 65,536 atoms × 400
// TRs, K 48, tc 5, in float32). The one-thread route ran ~6 warps an SM
// with 6·K values a thread in shared memory and passed every chunk state
// through a device-memory scratch (60 GB at that shape).
//
// Design (epg_lanes.cuh; phase 1's step in spgr_lanes.cuh, which K14's
// lane forward takes too). Lane l of the group holds orders l + i·G; the
// pre-RF state and the adjoint h live in registers; the RF mix, relaxation
// with the spoiler's diffusion attenuation and their transposes act on one
// order at a time, so each lane does its own; the spoiler's shift by kshift
// and its transpose are shuffles (shifts of G orders or more in pieces).
// Each lane reads its orders' b-factor coefficients once (at a fixed TR
// their attenuations too). Under b1 or variable TR/TE a step's scalars cost
// transcendentals: lane l forms those of the chunk's TR l (tc ≤ S ≤ 8 ≤ G)
// and the group shares them by shuffles. Per chunk, newest first: the block
// reads the chunk's checkpoint once, coalesced along the atoms, into slot 0
// of its shared states; phase 1 runs the forward from it in registers and
// stores the tc − 1 later pre-RF states into slots 1 … tc − 1; phase 2 walks
// them backwards as spgr_bwd.cu does (the shift's transpose, the diffusion
// and relaxation transposes, the echo's cotangent at F+(0) after the mix:
// lane 0's slot 0, the mix's coefficient terms and transpose). Each lane
// sums its own orders' terms, the group adds its lanes in a fixed order
// (kernels/epg.py `_lane_sum`, which the plain version `spgr_bwd_torch`
// takes too), so per-atom outputs agree bit for bit (built without FMA
// contraction). Outputs as spgr_bwd.cu's, but dcf (⌈nA·G/32⌉, nTR, nC): a
// warp holds 32/G atoms and sums their per-TR rows by shuffles; the wrapper
// sums over warps in a fixed order.
#include "spgr_lanes.cuh"

namespace mrphy {
namespace spgr {

// The diffusion attenuations of one order (slot i): at a fixed TR the
// lane's own (A0), over a TR train formed from its coefficients (cd); 1
// without diffusion.
template <typename T, int M>
__device__ __forceinline__ void slot_att(const T (&cd)[3][M],
                                         const T (&A0)[3][M], int i, T dqt,
                                         bool has_d, bool vartr, T (&A)[3]) {
#pragma unroll
  for (int q = 0; q < 3; ++q)
    A[q] = !has_d ? T(1) : (vartr ? exp(-dqt * cd[q][i]) : A0[q][i]);
}

template <typename T, int M>
__global__ void __launch_bounds__(lanes::kThreads)
    spgr_bwd_lanes_kernel(const T* __restrict__ coef,
                          const T* __restrict__ par,
                          const T* __restrict__ cdiff,
                          const T* __restrict__ chk, const T* __restrict__ gy,
                          T* __restrict__ dpar, T* __restrict__ dcf,
                          int64_t nA, int64_t nTR, int nC, int K, int kshift,
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
  const bool has_b1 = flags & kB1, vartr = flags & kVarTR,
             has_d = flags & kDiff;
  // under b1 or variable TR/TE lane l forms the scalars of the chunk's TR
  // l and the group shares them by shuffles
  const bool spread = has_b1 || vartr;
  const int st_atom = lanes::stride(6, M, G);
  const int st_slot = st_atom << lgA;
  T* const mine = slots + ab * st_atom;  // slot s at mine + s·st_slot
  lanes::zero(slots, (int)tc * st_slot);
  T p[4] = {0, 0, 0, 0}, b1 = 0, dq = 0;
  if (active) {
#pragma unroll
    for (int q = 0; q < 4; ++q) p[q] = par[q * nA + a];
    b1 = par[5 * nA + a];
    dq = par[6 * nA + a];
  }
  // this lane's orders' b-factor coefficients, and at a fixed TR their
  // attenuations
  T cd[3][M], A0[3][M];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < M; ++i) {
      cd[q][i] = has_d && g.valid(i) ? cdiff[q * K + g.order(i)] : T(0);
      A0[q][i] = has_d && !vartr ? exp(-dq * cd[q][i]) : T(1);
    }
  T h[6][M];
#pragma unroll
  for (int q = 0; q < 6; ++q)
#pragma unroll
    for (int i = 0; i < M; ++i) h[q][i] = T(0);
  T aE1 = 0, aE2 = 0, aE2te = 0, arec = 0, ab1 = 0, aDq = 0;
  // the echoes' cotangent, read one TR ahead (TRs newest first)
  const bool feed = lead && active;
  T gyr_t = feed ? gy[(a * nTR + nTR - 1) * 2] : T(0);
  T gyi_t = feed ? gy[(a * nTR + nTR - 1) * 2 + 1] : T(0);
  const int64_t plane = (int64_t)6 * K * nA;
  const int64_t ntc = nTR / tc;
  for (int64_t j = ntc - 1; j >= 0; --j) {
    __syncthreads();  // every group is done with the last chunk's slots
    lanes::stage(chk + j * plane, slots, nA, a0, lgA, 6, K, M, lg, st_atom);
    StepS<T> own{};
    if (spread && g.l < tc)
      own = step_scalars(coef, nTR, j * tc + g.l, p, b1, dq, has_b1, vartr);
    auto step = [&](int64_t tl) {
      return spread ? step_from(own, (int)tl, G)
                    : step_scalars(coef, nTR, j * tc + tl, p, b1, dq, has_b1,
                                   vartr);
    };
    __syncthreads();
    // phase 1: the forward from the chunk's start state, every state
    {
      T x[6][M], f0[2];
      lanes::load(mine, x, g);
      auto att = [&](int i, T dqt, T (&A)[3]) {
        slot_att(cd, A0, i, dqt, has_d, vartr, A);
      };
      for (int64_t tl = 1; tl < tc; ++tl) {
        step_lanes(x, step(tl - 1), att, has_d, kshift, g, f0);
        lanes::store(mine + tl * st_slot, x, g);
      }
    }
    // phase 2: the cotangent, backwards through the stored states
    for (int64_t tl = tc - 1; tl >= 0; --tl) {
      const int64_t t = j * tc + tl;
      const StepS<T> s = step(tl);
      const Trig<T>& tg = s.tg;
      const Factors<T>& f = s.f;
      const T gyr = gyr_t, gyi = gyi_t;
      gyr_t = feed && t > 0 ? gy[(a * nTR + t - 1) * 2] : T(0);
      gyi_t = feed && t > 0 ? gy[(a * nTR + t - 1) * 2 + 1] : T(0);
      const T* const x0 = mine + tl * st_slot;  // the pre-RF state
      lanes::shift_pool<0, true>(h, kshift, g);
      // each lane's orders, summed in slot order
      T kcontr = 0, kE2 = 0, kE1 = 0, kca2 = 0, ksc2 = 0, kss2 = 0, kss = 0,
        ksc = 0, khs = 0, khc = 0, kca = 0;
      T d_rec = 0, d_E2te = 0, d_c1e = 0, d_s1e = 0;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (!g.valid(i)) continue;
        const int k = g.order(i);
        T x[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) x[q] = x0[(q * M + i) * G + g.l];
        T s1[6];
        mix(tg, x, s1);
        T hv[6] = {h[0][i], h[1][i], h[2][i], h[3][i], h[4][i], h[5][i]};
        T A[3];
        slot_att(cd, A0, i, s.dqt, has_d, vartr, A);
        const T c[3] = {cd[0][i], cd[1][i], cd[2][i]};
        // the diffusion and relaxation transposes
        relax_T_c(f, k, has_d, c, A, s1, hv, kcontr, kE2, kE1, d_rec);
        if (k == 0) {
          // the echo's cotangent (the echo reads the mixed state)
          const T fr = s1[0], fi = s1[1];
          d_E2te = gyr * (tg.c1 * fr + tg.s1 * fi) +
                   gyi * (tg.c1 * fi - tg.s1 * fr);
          hv[0] = hv[0] + f.E2te * (tg.c1 * gyr - tg.s1 * gyi);
          hv[1] = hv[1] + f.E2te * (tg.s1 * gyr + tg.c1 * gyi);
          d_c1e = f.E2te * (gyr * fr + gyi * fi);
          d_s1e = f.E2te * (gyr * fi - gyi * fr);
        }
        // the RF mix's coefficients, against the pre-RF state
        kca2 += ((hv[0] * x[0] + hv[1] * x[1]) + hv[2] * x[2]) +
                hv[3] * x[3];
        ksc2 += ((hv[0] * x[2] + hv[1] * x[3]) + hv[2] * x[0]) +
                hv[3] * x[1];
        kss2 += ((-hv[0] * x[3] + hv[1] * x[2]) + hv[2] * x[1]) -
                hv[3] * x[0];
        kss += (hv[0] + hv[2]) * x[4] + (hv[1] + hv[3]) * x[5];
        ksc += (hv[0] - hv[2]) * x[5] - (hv[1] - hv[3]) * x[4];
        khs += -hv[4] * (x[0] + x[2]) - hv[5] * (x[1] + x[3]);
        khc += hv[4] * (x[1] - x[3]) + hv[5] * (x[2] - x[0]);
        kca += hv[4] * x[4] + hv[5] * x[5];
        T o[6];
        mix_T(tg, hv, o);
#pragma unroll
        for (int q = 0; q < 6; ++q) h[q][i] = o[q];
      }
      // the sums over the orders: the group adds its lanes
      if (has_d) kcontr = lanes::group_sum(kcontr, G);
      kE2 = lanes::group_sum(kE2, G);
      kE1 = lanes::group_sum(kE1, G);
      kca2 = lanes::group_sum(kca2, G);
      ksc2 = lanes::group_sum(ksc2, G);
      kss2 = lanes::group_sum(kss2, G);
      kss = lanes::group_sum(kss, G);
      ksc = lanes::group_sum(ksc, G);
      khs = lanes::group_sum(khs, G);
      khc = lanes::group_sum(khc, G);
      kca = lanes::group_sum(kca, G);
      T rows[11] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
      if (lead && active) {
        const T contr = -kcontr;
        if (vartr) {
          // the slots hold (R1, R2, M0): chain the per-TR factors back to
          // them and to the tr/te rows; rec = M0·(1 − E1)
          const T trn = coef[9 * nTR + t], ten = coef[10 * nTR + t];
          const T d_E1tot = kE1 - p[2] * d_rec;
          aE2te = aE2te + (T(1) - f.E1) * d_rec;
          aE1 = aE1 - (trn * f.E1) * d_E1tot;
          aE2 = (aE2 - (trn * f.E2) * kE2) - (ten * f.E2te) * d_E2te;
          T d_tr = ((-p[0]) * f.E1) * d_E1tot - (p[1] * f.E2) * kE2;
          if (has_d) {
            aDq = aDq + trn * contr;
            d_tr = d_tr + dq * contr;
          }
          rows[9] = d_tr;
          rows[10] = ((-p[1]) * f.E2te) * d_E2te;
        } else {
          aE1 = aE1 + kE1;
          aE2 = aE2 + kE2;
          arec = arec + d_rec;
          aE2te = aE2te + d_E2te;
          if (has_d) aDq = aDq + contr;
        }
        const T d_sa2 = tg.c2 * ksc2 + tg.s2 * kss2;
        const T d_sa = tg.s1 * (kss + T(0.5) * khs) +
                       tg.c1 * (ksc + T(0.5) * khc);
        rows[4] = tg.sa * (ksc + T(0.5) * khc) + d_c1e;
        rows[5] = tg.sa * (kss + T(0.5) * khs) + d_s1e;
        rows[6] = tg.sa2 * ksc2;
        rows[7] = tg.sa2 * kss2;
        if (has_b1) {
          // α = flip·b1 through the half-angle trig
          const T d_al = ((T(0.5) * tg.sa) * (d_sa2 - kca2) + tg.ca * d_sa) -
                         tg.sa * kca;
          ab1 = ab1 + d_al * coef[8 * nTR + t];
          rows[8] = d_al * b1;
        } else {
          rows[0] = kca2;
          rows[1] = d_sa2;
          rows[2] = d_sa;
          rows[3] = kca;
        }
      }
#pragma unroll
      for (int c = 0; c < 11; ++c) {
        if (c >= nC) break;
        const T v = lanes::warp_groups_sum(rows[c], G);
        if (writer) dcf[(warp * nTR + t) * nC + c] = v;
      }
    }
  }
  if (lead && active) {
    // the initial state is z0 on Z(0)'s real part
    const T out[7] = {aE1, aE2, aE2te, arec, h[4][0], ab1, aDq};
    for (int o = 0; o < 7; ++o) dpar[o * nA + a] = out[o];
  }
}

template <typename T, int M>
int launch_lanes_m(const T* coef, const T* par, const T* cdiff, const T* chk,
                   const T* gy, T* dpar, T* dcf, int64_t nA, int64_t nTR,
                   int64_t nC, int64_t K, int64_t kshift, int64_t flags,
                   int64_t tc, int lg, void* stream) {
  const int G = 1 << lg, A = lanes::kThreads >> lg;
  if (tc > lanes::max_states(6, M, G, (int)sizeof(T)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tc * A * lanes::stride(6, M, G) * sizeof(T);
  if (!lanes::smem_fits(smem)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spgr_bwd_lanes_kernel<T, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + A - 1) / A);
  spgr_bwd_lanes_kernel<T, M><<<grid, lanes::kThreads, smem,
                                (cudaStream_t)stream>>>(
      coef, par, cdiff, chk, gy, dpar, dcf, nA, nTR, (int)nC, (int)K,
      (int)kshift, (int)flags, tc, lg);
  return (int)cudaGetLastError();
}

// The instances: M 1-5 in float32, 1-2 in float64 (kernels/epg.py
// LANE_SLOTS_MAX).
template <typename T>
int launch_spgr_bwd_lanes(const T* coef, const T* par, const T* cdiff,
                          const T* chk, const T* gy, T* dpar, T* dcf,
                          int64_t nA, int64_t nTR, int64_t nC, int64_t K,
                          int64_t kshift, int64_t flags, int64_t tc,
                          int64_t G, int64_t M, void* stream) {
  if (nA <= 0 || nTR <= 0 || K <= 0 || kshift == 0 || tc <= 0 ||
      nTR % tc != 0 || nC != ((flags & kVarTR) ? 11 : 9) ||
      (flags & ~(int64_t)(kB1 | kVarTR | kDiff)) != 0 ||
      !lanes::valid_cfg(G, M, K))
    return (int)cudaErrorInvalidValue;
  const int lg = lanes::log2i((int)G);
  switch (M) {
#define MRPHY_SPGR_LANES_M(MM)                                              \
  case MM:                                                                  \
    return launch_lanes_m<T, MM>(coef, par, cdiff, chk, gy, dpar, dcf, nA, \
                                 nTR, nC, K, kshift, flags, tc, lg, stream);
    MRPHY_SPGR_LANES_M(1)
    MRPHY_SPGR_LANES_M(2)
    default:
      break;
  }
  if constexpr (sizeof(T) == 4) {
    switch (M) {
      MRPHY_SPGR_LANES_M(3)
      MRPHY_SPGR_LANES_M(4)
      MRPHY_SPGR_LANES_M(5)
      default:
        break;
    }
  }
#undef MRPHY_SPGR_LANES_M
  return (int)cudaErrorInvalidValue;
}

}  // namespace spgr
}  // namespace mrphy

// Inputs (coef (nC, nTR), par (7, nA), cdiff (3, K), chk (nTR / tc, 6, K,
// nA), g (nA, nTR, 2)), the outputs dpar (7, nA) and dcf (⌈nA·G/32⌉, nTR,
// nC); sizes, kshift, flags (1 b1, 2 variable TR/TE, 4 diffusion), tc (the
// block keeps the chunk's tc states in shared memory), the lanes per atom G
// and the slots a lane M = ⌈K/G⌉. Returns the cudaError_t of the launch (0
// = success; cudaErrorInvalidValue for arguments out of range, tc past the
// S states of kernels/epg.py `lane_capacity` or shared memory past the
// device's limit per block).
#define MRPHY_SPGR_BWD_LANES_ENTRY(NAME, T)                                   \
  extern "C" int NAME(const void* coef, const void* par, const void* cdiff,  \
                      const void* chk, const void* g, void* dpar, void* dcf, \
                      int64_t nA, int64_t nTR, int64_t nC, int64_t K,        \
                      int64_t kshift, int64_t flags, int64_t tc, int64_t G,  \
                      int64_t M, void* stream) {                              \
    return mrphy::spgr::launch_spgr_bwd_lanes<T>(                             \
        (const T*)coef, (const T*)par, (const T*)cdiff, (const T*)chk,        \
        (const T*)g, (T*)dpar, (T*)dcf, nA, nTR, nC, K, kshift, flags, tc, G, \
        M, stream);                                                           \
  }

MRPHY_SPGR_BWD_LANES_ENTRY(mrphy_spgr_bwd_lanes_f32, float)
MRPHY_SPGR_BWD_LANES_ENTRY(mrphy_spgr_bwd_lanes_f64, double)
