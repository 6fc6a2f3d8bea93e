// cpmg_bwd_lanes: K18 `cpmg_bwd`, the two-phase chunk adjoint of the CPMG
// echo train, on its lane route: a group of G lanes per atom over the
// orders, the chunk's states kept in shared memory (Hopper, sm_90a).
//
// Replaces the TPU kernel `_cpmg_bwd_kernel` (launched by `_cpmg_core_bwd`,
// mrphy_tpu/ops/epg_pallas.py), as cpmg_bwd.cu does; the wrapper
// (kernels/epg.py `adjoint_cfg`) takes this route where an atom's orders fit
// M ≤ 5 slots a lane (float32; 2 in float64) of G = 8, 16 or 32 lanes and
// the chunk's tc states fit the S that shared memory holds, and
// cpmg_bwd.cu's one-thread-per-atom route otherwise (K 401, float64 K 201).
// The entry point of the T2 fit (kernels/epg.py `adjoint_tc`) takes the
// largest divisor of the train within S (tc 4 at 32 echoes, K 33).
//
// What bounds it on the H100: arithmetic, and reading the checkpoints once
// (6.6 GB at 1,048,576 atoms × 32 echoes × K 33, tc 4, in float32). The
// one-thread route ran 8 warps an SM with 6·K values a thread in shared
// memory and passed every chunk state through device memory about six
// times.
//
// Design (epg_lanes.cuh; the forward's steps in cpmg_lanes.cuh, which
// K17's lane route shares). Lane l of the group holds orders l + i·G; the
// state, the adjoint h and the echo's two intermediate states live in
// registers; relaxation, the refocusing mix and their transposes act on
// one order at a time, so each lane does its own; the crushers' unit shift
// and its transpose are shuffles. Per chunk, newest first: the block reads
// the chunk's checkpoint once, coalesced along the atoms, into slot 0 of
// its shared states; phase 1 runs the forward from it in registers and
// stores the tc − 1 later pre-echo states into slots 1 … tc − 1; phase 2
// walks them backwards as cpmg_bwd.cu does (the cotangent at F+(0), the
// second half's transpose, the mix's coefficient terms and transpose, the
// first half's transpose). Each lane sums its own orders' terms, the group
// adds its lanes in a fixed order (kernels/epg.py `_lane_sum`, which the
// plain version `cpmg_bwd_torch` takes too), so per-atom outputs agree bit
// for bit (built without FMA contraction). Outputs as cpmg_bwd.cu's, but
// dcf (⌈nA·G/32⌉, nE, nC): a warp holds 32/G atoms and sums their per-echo
// rows by shuffles; the wrapper sums over warps in a fixed order.
#include "cpmg_lanes.cuh"

namespace mrphy {
namespace cpmg {

template <typename T, int M>
__global__ void __launch_bounds__(lanes::kThreads)
    cpmg_bwd_lanes_kernel(const T* __restrict__ coef,
                          const T* __restrict__ par, const T* __restrict__ dqr,
                          const T* __restrict__ cdiff,
                          const T* __restrict__ chk, const T* __restrict__ gr,
                          const T* __restrict__ gi, T* __restrict__ dpar,
                          T* __restrict__ dcf, int64_t nA, int64_t nE, int nC,
                          int flags, int64_t tc, int lg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const slots = reinterpret_cast<T*>(smem_raw);
  const int G = 1 << lg, lgA = lanes::log2i(lanes::kThreads) - lg;
  const int tid = threadIdx.x, ab = tid >> lg;
  const Group g{tid & (G - 1), G, (int)nE + 1};
  const int K = g.K;
  const int64_t a0 = (int64_t)blockIdx.x << lgA, a = a0 + ab;
  const bool active = a < nA, lead = g.l == 0;
  const int64_t warp = ((int64_t)blockIdx.x * lanes::kThreads + tid) >> 5;
  // the warp's first atom is past nA: its rows are not written
  const bool writer = (tid & 31) == 0 && ((warp << 5) >> lg) < nA;
  const bool has_b1 = flags & kB1, varesp = flags & kVarEsp,
             has_d = flags & kDiff;
  // under b1 or a spacing train the echo's scalars cost transcendentals:
  // lane l forms those of the chunk's echo l (tc ≤ S ≤ G) and the group
  // shares them by shuffles
  const bool spread = has_b1 || varesp;
  const int st_atom = lanes::stride(6, M, G);
  const int st_slot = st_atom << lgA;
  T* const mine = slots + ab * st_atom;  // slot s at mine + s·st_slot
  lanes::zero(slots, (int)tc * st_slot);
  T p0 = 0, p1 = 0, p2 = 0, b1 = 0, dq = 0;
  if (active) {
    p0 = par[a];
    p1 = par[nA + a];
    p2 = par[2 * nA + a];
    b1 = par[6 * nA + a];
    dq = dqr[a];
  }
  T h[6][M];
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int i = 0; i < M; ++i) h[p][i] = T(0);
  T aE1 = 0, aE2 = 0, arec = 0, ab1 = 0, aDq = 0;
  const int64_t plane = (int64_t)6 * K * nA;
  const int64_t ntc = nE / tc;
  for (int64_t j = ntc - 1; j >= 0; --j) {
    __syncthreads();  // every group is done with the last chunk's slots
    lanes::stage(chk + j * plane, slots, nA, a0, lgA, 6, K, M, lg, st_atom);
    EchoS<T> own{};
    if (spread && g.l < tc)
      own = echo_scalars(coef, nE, j * tc + g.l, p0, p1, p2, b1, dq, has_b1,
                         varesp);
    auto echo = [&](int64_t tl) {
      return spread ? echo_from(own, (int)tl, G)
                    : echo_scalars(coef, nE, j * tc + tl, p0, p1, p2, b1, dq,
                                   has_b1, varesp);
    };
    __syncthreads();
    // phase 1: the forward from the chunk's start state, every state
    {
      T x[6][M];
      lanes::load(mine, x, g);
      for (int64_t tl = 1; tl < tc; ++tl) {
        const EchoS<T> e = echo(tl - 1);
        half_lanes(x, e, cdiff, has_d, g);
        mix_lanes(x, e.tg, g);
        half_lanes(x, e, cdiff, has_d, g);
        lanes::store(mine + tl * st_slot, x, g);
      }
    }
    // phase 2: the cotangent, backwards through the stored states
    for (int64_t tl = tc - 1; tl >= 0; --tl) {
      const int64_t t = j * tc + tl;
      const EchoS<T> e = echo(tl);
      const T* const x0 = mine + tl * st_slot;  // the pre-echo state
      T sh[6][M];
      lanes::load(x0, sh, g);
      half_lanes(sh, e, cdiff, has_d, g);  // the refocusing's input
      // the echo reads F+(0) after the second half
      if (lead && active) {
        h[0][0] = h[0][0] + gr[t * nA + a];
        h[1][0] = h[1][0] + gi[t * nA + a];
      }
      lanes::shift_pool<0, true>(h, 1, g);
      // the second half's transpose at the mix's output s1, then the mix's
      // coefficients (against its input sh) and its transpose; each lane's
      // orders summed in slot order
      T c2 = 0, e2_2 = 0, e1_2 = 0, r2 = 0;
      T kca2 = 0, ksc2 = 0, ksc = 0, khc = 0, kca = 0;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (!g.valid(i)) continue;
        const T si[6] = {sh[0][i], sh[1][i], sh[2][i],
                         sh[3][i], sh[4][i], sh[5][i]};
        T s1[6];
        mix0(e.tg, si, s1);
        T hv[6] = {h[0][i], h[1][i], h[2][i], h[3][i], h[4][i], h[5][i]};
        T A[3];
        att(cdiff, K, g.order(i), e.dqt, has_d, A);
        spgr::relax_T_att(e.f, K, g.order(i), has_d, cdiff, A, s1, hv, c2,
                          e2_2, e1_2, r2);
        T tm[5];
        mix0_terms(hv, si, tm);
        kca2 += tm[0];
        ksc2 += tm[1];
        ksc += tm[2];
        khc += tm[3];
        kca += tm[4];
        T o[6];
        mix0_T(e.tg, hv, o);
#pragma unroll
        for (int p = 0; p < 6; ++p) h[p][i] = o[p];
      }
      // the first half's transpose at the pre-echo state
      lanes::shift_pool<0, true>(h, 1, g);
      T c1 = 0, e2_1 = 0, e1_1 = 0, r1 = 0;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (!g.valid(i)) continue;
        T xi[6];
#pragma unroll
        for (int p = 0; p < 6; ++p) xi[p] = x0[(p * M + i) * G + g.l];
        T hv[6] = {h[0][i], h[1][i], h[2][i], h[3][i], h[4][i], h[5][i]};
        T A[3];
        att(cdiff, K, g.order(i), e.dqt, has_d, A);
        spgr::relax_T_att(e.f, K, g.order(i), has_d, cdiff, A, xi, hv, c1,
                          e2_1, e1_1, r1);
#pragma unroll
        for (int p = 0; p < 6; ++p) h[p][i] = hv[p];
      }
      // the sums over the orders: the group adds its lanes
      if (has_d) {
        c2 = lanes::group_sum(c2, G);
        c1 = lanes::group_sum(c1, G);
      }
      e2_2 = lanes::group_sum(e2_2, G);
      e1_2 = lanes::group_sum(e1_2, G);
      e2_1 = lanes::group_sum(e2_1, G);
      e1_1 = lanes::group_sum(e1_1, G);
      kca2 = lanes::group_sum(kca2, G);
      ksc2 = lanes::group_sum(ksc2, G);
      ksc = lanes::group_sum(ksc, G);
      khc = lanes::group_sum(khc, G);
      kca = lanes::group_sum(kca, G);
      T rows[6] = {0, 0, 0, 0, 0, 0};
      if (lead && active) {
        // each half's factors (and diffusion), the second half first (r2,
        // r1: order 0's, this lane's own)
        T d_esp = 0;
        const T hn = varesp ? T(0.5) * coef[5 * nE + t] : T(0);
        const Factors<T>& f = e.f;
        const T kc[2] = {c2, c1}, kE2[2] = {e2_2, e2_1}, kE1[2] = {e1_2, e1_1},
                d_rec[2] = {r2, r1};
        for (int u = 0; u < 2; ++u) {
          if (has_d) {
            const T contr = -kc[u];
            if (varesp) {
              aDq = aDq + hn * contr;
              d_esp = d_esp + (T(0.5) * dq) * contr;
            } else {
              aDq = aDq + contr;
            }
          }
          if (varesp) {
            // the slots hold (R1, R2, M0); rech = M0·(1 − E1h)
            const T d_E1tot = kE1[u] - p2 * d_rec[u];
            arec = arec + (T(1) - f.E1) * d_rec[u];
            aE1 = aE1 - (hn * f.E1) * d_E1tot;
            aE2 = aE2 - (hn * f.E2) * kE2[u];
            d_esp = d_esp - T(0.5) * ((p0 * f.E1) * d_E1tot +
                                      (p1 * f.E2) * kE2[u]);
          } else {
            aE1 = aE1 + kE1[u];
            aE2 = aE2 + kE2[u];
            arec = arec + d_rec[u];
          }
        }
        const Trig<T>& tg = e.tg;
        const T d_sa = ksc + T(0.5) * khc;
        if (has_b1) {
          // α = flip·b1 through the half-angle trig
          const T d_al = ((T(0.5) * tg.sa) * (ksc2 - kca2) + tg.ca * d_sa) -
                         tg.sa * kca;
          ab1 = ab1 + d_al * coef[4 * nE + t];
          rows[4] = d_al * b1;
        } else {
          rows[0] = kca2;
          rows[1] = ksc2;
          rows[2] = d_sa;
          rows[3] = kca;
        }
        rows[5] = d_esp;
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        if (c >= nC) break;
        const T v = lanes::warp_groups_sum(rows[c], G);
        if (writer) dcf[(warp * nE + t) * nC + c] = v;
      }
    }
  }
  if (lead && active) {
    // the excitation's state: F+(0) = (e_ss, −e_sc), F−(0) = (e_ss, e_sc),
    // Z(0) = e_ca
    const T out[8] = {aE1, aE2, arec, h[0][0] + h[2][0], -h[1][0] + h[3][0],
                      h[4][0], ab1, aDq};
    for (int o = 0; o < 8; ++o) dpar[o * nA + a] = out[o];
  }
}

template <typename T, int M>
int launch_lanes_m(const T* coef, const T* par, const T* dq, const T* cdiff,
                   const T* chk, const T* gr, const T* gi, T* dpar, T* dcf,
                   int64_t nA, int64_t nE, int64_t nC, int64_t flags,
                   int64_t tc, int lg, void* stream) {
  const int A = lanes::kThreads >> lg;
  const size_t smem =
      (size_t)tc * A * lanes::stride(6, M, 1 << lg) * sizeof(T);
  if (!lanes::smem_fits(smem)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cpmg_bwd_lanes_kernel<T, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + A - 1) / A);
  cpmg_bwd_lanes_kernel<T, M><<<grid, lanes::kThreads, smem,
                                (cudaStream_t)stream>>>(
      coef, par, dq, cdiff, chk, gr, gi, dpar, dcf, nA, nE, (int)nC,
      (int)flags, tc, lg);
  return (int)cudaGetLastError();
}

// The instances: M 1-5 in float32, 1-2 in float64 (kernels/epg.py
// LANE_SLOTS_MAX).
template <typename T>
int launch_cpmg_bwd_lanes(const T* coef, const T* par, const T* dq,
                          const T* cdiff, const T* chk, const T* gr,
                          const T* gi, T* dpar, T* dcf, int64_t nA,
                          int64_t nE, int64_t nC, int64_t flags, int64_t tc,
                          int64_t G, int64_t M, void* stream) {
  // tc ≤ G: lane l forms the scalars of the chunk's echo l
  if (!valid_args(nA, nE, nC, flags, tc, 128) ||
      !lanes::valid_cfg(G, M, nE + 1) || tc > G)
    return (int)cudaErrorInvalidValue;
  const int lg = lanes::log2i((int)G);
  switch (M) {
#define MRPHY_CPMG_LANES_M(MM)                                              \
  case MM:                                                                  \
    return launch_lanes_m<T, MM>(coef, par, dq, cdiff, chk, gr, gi, dpar,  \
                                 dcf, nA, nE, nC, flags, tc, lg, stream);
    MRPHY_CPMG_LANES_M(1)
    MRPHY_CPMG_LANES_M(2)
    default:
      break;
  }
  if constexpr (sizeof(T) == 4) {
    switch (M) {
      MRPHY_CPMG_LANES_M(3)
      MRPHY_CPMG_LANES_M(4)
      MRPHY_CPMG_LANES_M(5)
      default:
        break;
    }
  }
#undef MRPHY_CPMG_LANES_M
  return (int)cudaErrorInvalidValue;
}

}  // namespace cpmg
}  // namespace mrphy

// Inputs (coef, par, dq, cdiff, chk (nE / tc, 6, K, nA), gr, gi (nE, nA)),
// the outputs dpar (8, nA) and dcf (⌈nA·G/32⌉, nE, nC); sizes, flags (1
// b1, 2 spacing train, 4 diffusion), tc (the block keeps the chunk's tc
// states in shared memory; tc ≤ G), the lanes per atom G and the slots a
// lane M = ⌈K/G⌉. Returns the cudaError_t of the launch (0 = success;
// cudaErrorInvalidValue for arguments out of range, tc > G included, or
// tc states past the device's shared memory per block).
#define MRPHY_CPMG_BWD_LANES_ENTRY(NAME, T)                                   \
  extern "C" int NAME(const void* coef, const void* par, const void* dq,     \
                      const void* cdiff, const void* chk, const void* gr,    \
                      const void* gi, void* dpar, void* dcf, int64_t nA,     \
                      int64_t nE, int64_t nC, int64_t flags, int64_t tc,     \
                      int64_t G, int64_t M, void* stream) {                  \
    return mrphy::cpmg::launch_cpmg_bwd_lanes<T>(                             \
        (const T*)coef, (const T*)par, (const T*)dq, (const T*)cdiff,         \
        (const T*)chk, (const T*)gr, (const T*)gi, (T*)dpar, (T*)dcf, nA, nE, \
        nC, flags, tc, G, M, stream);                                         \
  }

MRPHY_CPMG_BWD_LANES_ENTRY(mrphy_cpmg_bwd_lanes_f32, float)
MRPHY_CPMG_BWD_LANES_ENTRY(mrphy_cpmg_bwd_lanes_f64, double)
