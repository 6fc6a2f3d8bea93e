// xspgr_fwd_lanes: K20 `xspgr_fwd_chk` and, as its variable-TR instance,
// K23 `xspgr_v_fwd_chk`, the two-pool EPG-X gradient-spoiled train with
// chunk checkpoints, on their lane route: a group of G lanes per atom over
// the orders, the state in registers (Hopper, sm_90a).
//
// Replaces the TPU kernels `_xspgr_fwd_chk_kernel` (launched by
// `_xspgr_core_fwd`) and `_xv_fwd_chk_kernel` (`_xspgr_core_v_fwd`) of
// mrphy_tpu/ops/epg_pallas.py, as xspgr_fwd.cu's _chk entry points do; the
// wrapper (kernels/epg.py `forward_cfg`) takes this route where an atom's
// orders fit M ≤ 5 slots a lane (float32; 2 in float64) of G = 8, 16 or 32
// lanes, and xspgr_fwd.cu's one thread per atom otherwise (default K 201,
// float64 K 101). Inputs and outputs are xspgr_fwd.cu's: the echoes sig
// (nA, nTR, 2) and the state at the start of every chunk of tc TRs, chk
// (nTR/tc, 12, K, nA), the layout the adjoints K21/K24 read on either of
// their routes.
//
// What bounds it on the H100: writing the checkpoints at the lane
// adjoint's capped chunk (15.1 GB at 65,536 atoms × 400 TRs, K 48, tc 4,
// in float32: 4.5 ms), then arithmetic (~155 operations per atom, order
// and TR, ~3.3 ms at the card's float32 peak). The one-thread route kept
// 12·K values a thread in shared memory: 3 warps an SM at K 48, one
// dependent chain each, and every order's 12 values passed through shared
// memory twice per TR.
//
// Design (epg_lanes.cuh, epgx_lanes.cuh). Lane l of the group holds
// orders l + i·G of both pools in registers; per TR the RF mix and the
// exchange–relaxation run order by order on each lane's own slots and the
// spoiler's shift by kshift is shuffles (`xstep_lanes`, the step the lane
// adjoints' phase 1 takes). At a chunk start each group stores its state
// into its atom's slot of the block's shared memory and, after a block
// sync, the block writes the rows (plane, order < K) along its atoms
// (`lanes::unstage`), so the checkpoint leaves in whole sectors. The echo
// is lane 0's slot-0 total of both pools, demodulated; lane t mod G keeps
// TR t's, and every G TRs the group writes them as one run of 2·G values
// of the atom's row of sig. Under b1 lane l forms the trig of TR t0 + l of
// each run of G TRs and the group shares it by shuffles; over a
// variable-TR train (VARTR) each step's 14 entries are read at the step
// (a second set read one TR ahead cost 14 registers and, at 16 warps an
// SM, spills). Built for 4 blocks an SM (16 warps, ≤ 128 registers) in
// float32 at M ≤ 3, 3 (12 warps) above and in float64
// (lanes::kFwdBlocks).
// Built without FMA contraction, in the plain versions' order of
// operations (kernels/epgx.py `xspgr_fwd_chk_torch`,
// `xspgr_v_fwd_chk_torch`): echoes and checkpoints agree bit for bit.
#include "epgx_lanes.cuh"

namespace mrphy {
namespace epgx {

using spgr::Trig;

// par: (17, nA) at a fixed TR; over a variable-TR train (VARTR) the rows
// [M0a, M0b, b1] (3, nA), the entries of step t at pkt + t·14·nA.
template <typename T, int M, bool VARTR>
__global__ void __launch_bounds__(lanes::kThreads, (lanes::kFwdBlocks<T, M>))
    xspgr_fwd_lanes_kernel(const T* __restrict__ coef,
                           const T* __restrict__ par,
                           const T* __restrict__ pkt, T* __restrict__ sig,
                           T* __restrict__ chk, int64_t nA, int64_t nTR,
                           int K, int kshift, int flags, int64_t tc,
                           int lg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const slots = reinterpret_cast<T*>(smem_raw);
  const int G = 1 << lg, lgA = lanes::log2i(lanes::kThreads) - lg;
  const int tid = threadIdx.x, ab = tid >> lg;
  const Group g{tid & (G - 1), G, K};
  const int64_t a0 = (int64_t)blockIdx.x << lgA, a = a0 + ab;
  const bool active = a < nA;
  const bool has_b1 = flags & spgr::kB1;
  const int st_atom = lanes::stride(kPlanes, M, G);
  T* const mine = slots + ab * st_atom;
  // the entries (over a train, step t's, read at the step)
  Prop<T> e{};
  T M0a = 0, M0b = 0, b1 = 0;
  if (active) {
    const T* pm = VARTR ? par : par + 14 * nA;  // [M0a, M0b, b1]
    if constexpr (!VARTR) e = load_prop(par, nA, a);
    M0a = pm[a];
    M0b = pm[nA + a];
    b1 = pm[2 * nA + a];
  }
  T x[kPlanes][M];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p)
#pragma unroll
    for (int i = 0; i < M; ++i) x[p][i] = T(0);
  if (g.l == 0) {
    x[4][0] = M0a;
    x[10][0] = M0b;
  }
  T* const out = sig + a * nTR * 2;
  const int64_t plane = (int64_t)kPlanes * K * nA;
  Trig<T> own{};   // under b1: TR t0 + l's trig
  T er = 0, ei = 0;  // TR t's echo on lane t mod G
  int64_t left = 0;  // TRs to the next chunk start
  for (int64_t t = 0; t < nTR; ++t) {
    const int tl = (int)(t & (G - 1));
    if (left == 0) {
      // the chunk's start state, through the atom's shared slot
      lanes::checkpoint(chk + (t / tc) * plane, x, mine, slots, nA, a0, lgA,
                        lg, st_atom, g);
      left = tc;
    }
    --left;
    if (has_b1 && tl == 0 && t + g.l < nTR)
      own = spgr::trig(coef, nTR, t + g.l, b1, true);
    const Trig<T> tg =
        has_b1 ? trig_from(own, tl, G) : spgr::trig(coef, nTR, t, b1, false);
    if constexpr (VARTR)
      if (active) e = load_prop(pkt + t * 14 * nA, nA, a);
    T f0[2];
    xstep_lanes(x, tg, e, kshift, g, f0);
    // the echo: lane 0's total F+(0) of the mixed state, demodulated
    const T fr = lanes::shfl(f0[0], 0, G), fi = lanes::shfl(f0[1], 0, G);
    if (g.l == tl) {
      er = tg.c1 * fr + tg.s1 * fi;
      ei = tg.c1 * fi - tg.s1 * fr;
    }
    if (active && (tl == G - 1 || t == nTR - 1) && g.l <= tl) {
      T* const o = out + 2 * (t - tl + g.l);
      o[0] = er;
      o[1] = ei;
    }
  }
}

// The launch at M slots a lane: the instances are M 1-5 in float32, 1-2 in
// float64 (lanes::kFwdSlotsMax, kernels/epg.py FWD_SLOTS_MAX), each
// passing a run-time M it is not on to the next.
template <typename T, bool VARTR, int M = 1>
int launch_fwd_lanes_m(int64_t m, const T* coef, const T* par, const T* pkt,
                       T* sig, T* chk, int64_t nA, int64_t nTR, int64_t K,
                       int64_t kshift, int64_t flags, int64_t tc, int lg,
                       void* stream) {
  if (m != M) {
    if constexpr (M < lanes::kFwdSlotsMax<T>)
      return launch_fwd_lanes_m<T, VARTR, M + 1>(m, coef, par, pkt, sig, chk,
                                                 nA, nTR, K, kshift, flags,
                                                 tc, lg, stream);
    else
      return (int)cudaErrorInvalidValue;
  }
  const int A = lanes::kThreads >> lg;
  const size_t smem =
      (size_t)A * lanes::stride(kPlanes, M, 1 << lg) * sizeof(T);
  if (!lanes::smem_fits(smem)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        xspgr_fwd_lanes_kernel<T, M, VARTR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + A - 1) / A);
  xspgr_fwd_lanes_kernel<T, M, VARTR><<<grid, lanes::kThreads, smem,
                                        (cudaStream_t)stream>>>(
      coef, par, pkt, sig, chk, nA, nTR, (int)K, (int)kshift, (int)flags,
      tc, lg);
  return (int)cudaGetLastError();
}

template <typename T, bool VARTR>
int launch_xspgr_fwd_lanes(const T* coef, const T* par, const T* pkt,
                           T* sig, T* chk, int64_t nA, int64_t nTR,
                           int64_t K, int64_t kshift, int64_t flags,
                           int64_t tc, int64_t G, int64_t M, void* stream) {
  if (nA <= 0 || nTR <= 0 || K <= 0 || kshift == 0 || tc <= 0 ||
      nTR % tc != 0 || !lanes::valid_cfg(G, M, K) || chk == nullptr ||
      (VARTR && pkt == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_fwd_lanes_m<T, VARTR>(M, coef, par, pkt, sig, chk, nA, nTR,
                                      K, kshift, flags, tc,
                                      lanes::log2i((int)G), stream);
}

}  // namespace epgx
}  // namespace mrphy

// Inputs (coef (9, nTR), par (17, nA)), the echoes sig (nA, nTR, 2) and
// the checkpoints chk (nTR / tc, 12, K, nA); sizes, kshift, flags (1 b1),
// tc, the lanes per atom G and the slots a lane M = ⌈K/G⌉. Returns the
// cudaError_t of the launch (0 = success; cudaErrorInvalidValue for
// arguments out of range or a block's shared memory past the device's
// limit).
#define MRPHY_XSPGR_FWD_LANES_ENTRY(NAME, T)                                 \
  extern "C" int NAME(const void* coef, const void* par, void* sig,         \
                      void* chk, int64_t nA, int64_t nTR, int64_t K,        \
                      int64_t kshift, int64_t flags, int64_t tc, int64_t G, \
                      int64_t M, void* stream) {                             \
    return mrphy::epgx::launch_xspgr_fwd_lanes<T, false>(                    \
        (const T*)coef, (const T*)par, nullptr, (T*)sig, (T*)chk, nA, nTR,   \
        K, kshift, flags, tc, G, M, stream);                                 \
  }

MRPHY_XSPGR_FWD_LANES_ENTRY(mrphy_xspgr_fwd_chk_lanes_f32, float)
MRPHY_XSPGR_FWD_LANES_ENTRY(mrphy_xspgr_fwd_chk_lanes_f64, double)

// The variable-TR train: inputs coef (9, nTR), pk (3, nA) = [M0a, M0b, b1]
// and the per-step propagator planes pkt (nTR, 14, nA); the rest as above.
#define MRPHY_XSPGR_V_FWD_LANES_ENTRY(NAME, T)                               \
  extern "C" int NAME(const void* coef, const void* pk, const void* pkt,    \
                      void* sig, void* chk, int64_t nA, int64_t nTR,        \
                      int64_t K, int64_t kshift, int64_t flags, int64_t tc, \
                      int64_t G, int64_t M, void* stream) {                  \
    return mrphy::epgx::launch_xspgr_fwd_lanes<T, true>(                     \
        (const T*)coef, (const T*)pk, (const T*)pkt, (T*)sig, (T*)chk, nA,   \
        nTR, K, kshift, flags, tc, G, M, stream);                            \
  }

MRPHY_XSPGR_V_FWD_LANES_ENTRY(mrphy_xspgr_v_fwd_chk_lanes_f32, float)
MRPHY_XSPGR_V_FWD_LANES_ENTRY(mrphy_xspgr_v_fwd_chk_lanes_f64, double)
