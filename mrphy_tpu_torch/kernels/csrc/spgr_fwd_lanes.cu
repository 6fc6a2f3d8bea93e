// spgr_fwd_lanes: K14 `spgr_fwd_chk`, the gradient-spoiled EPG train (SPGR
// / MRF-FISP) with chunk checkpoints, on its lane route: a group of G lanes
// per atom over the orders, the state in registers (Hopper, sm_90a).
//
// Replaces the TPU kernel `_spgr_fwd_chk_kernel` (launched by
// `_spgr_fwd_chk`, mrphy_tpu/ops/epg_pallas.py), as spgr_fwd.cu's _chk
// entry points do; the wrapper (kernels/epg.py `forward_cfg` at 6 planes)
// takes this route where an atom's orders fit M ≤ kSlotsMax slots a lane of
// G = 8, 16 or 32 lanes, and spgr_fwd.cu's one thread per atom otherwise
// (the default K = nTR·|kshift| + 1, float64 K 201, and the state in device
// memory). Inputs and outputs are spgr_fwd.cu's: the echoes sig (nA, nTR,
// 2) and the state at the start of every chunk of tc TRs, chk (nTR/tc, 6,
// K, nA), the layout the adjoint K15 reads on either of its routes.
//
// What bounds it on the H100: writing the checkpoints at the lane
// adjoint's capped chunk (6.04 GB at 65,536 atoms × 400 TRs, K 48, tc 5, in
// float32: 1.8 ms), then arithmetic (~45 operations per atom, order and TR
// without diffusion). The one-thread route kept 6·K values a thread in
// shared memory: 64-thread blocks and 6 warps an SM at K 48, one dependent
// chain each, every order's 6 values through shared memory twice per TR,
// and each echo written alone at a stride of nTR·2 values.
//
// Design (epg_lanes.cuh, spgr_lanes.cuh). Lane l of the group holds orders
// l + i·G in registers; per TR the RF mix, relaxation with the spoiler's
// diffusion attenuation and the shift by kshift (shuffles, in pieces past
// G − 1 orders, mirrored for kshift < 0) run as the adjoint K15's phase 1
// does (`step_lanes`, one step for both); the echo reads lane 0's slot 0
// between the mix and the relaxation. Each lane keeps its orders'
// b-factor coefficients (over a TR train) or their attenuations (at a
// fixed TR), 3·M registers. At a chunk start each group stores its state
// into its atom's slot of the block's shared memory and, after a block
// sync, the block writes the rows (plane, order < K) along its atoms
// (`lanes::checkpoint`), so the checkpoint leaves in whole sectors. Lane t
// mod G keeps TR t's echo, and every G TRs the group writes them as one
// run of 2·G values of the atom's row of sig. Under b1 or a variable TR/TE
// lane l forms the scalars (trig, the factors through expm1, the diffusion
// step) of TR t0 + l of each run of G TRs and the group shares them by
// shuffles. Built for kBlocks blocks an SM. Built without FMA contraction,
// in the plain version's order of operations (kernels/epg.py
// `spgr_fwd_chk_torch`): echoes and checkpoints agree bit for bit.
#include "spgr_lanes.cuh"

namespace mrphy {
namespace spgr {

// The largest M built (kernels/epg.py FWD_SLOTS_MAX at 6 planes), and the
// blocks an SM each instance is built for: 4 (16 warps, at most 128
// registers a thread) in float32 and float64 M 1, 3 (12 warps, 168) for
// float64 M 2-3, 2 (8 warps) for float64 M 4, which ptxas -v showed
// spilling at 168 (float32 M 6-8 take 128 without spills).
template <typename T>
constexpr int kSlotsMax = sizeof(T) == 4 ? 8 : 4;
template <typename T, int M>
constexpr int kBlocks = sizeof(T) == 4 || M == 1 ? 4 : (M <= 3 ? 3 : 2);

template <typename T, int M>
__global__ void __launch_bounds__(lanes::kThreads, (kBlocks<T, M>))
    spgr_fwd_lanes_kernel(const T* __restrict__ coef,
                          const T* __restrict__ par,
                          const T* __restrict__ cdiff, T* __restrict__ sig,
                          T* __restrict__ chk, int64_t nA, int64_t nTR, int K,
                          int kshift, int flags, int64_t tc, int lg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const slots = reinterpret_cast<T*>(smem_raw);
  const int G = 1 << lg, lgA = lanes::log2i(lanes::kThreads) - lg;
  const int ab = threadIdx.x >> lg;
  const Group g{(int)threadIdx.x & (G - 1), G, K};
  const int64_t a0 = (int64_t)blockIdx.x << lgA, a = a0 + ab;
  const bool active = a < nA;
  const bool has_b1 = flags & kB1, vartr = flags & kVarTR,
             has_d = flags & kDiff;
  const bool spread = has_b1 || vartr;
  const int st_atom = lanes::stride(6, M, G);
  T* const mine = slots + ab * st_atom;
  T p[4] = {0, 0, 0, 0}, z0 = 0, b1 = 0, dq = 0;
  if (active) {
#pragma unroll
    for (int q = 0; q < 4; ++q) p[q] = par[q * nA + a];
    z0 = par[4 * nA + a];
    b1 = par[5 * nA + a];
    dq = par[6 * nA + a];
  }
  // this lane's orders' b-factor coefficients (over a TR train) or their
  // attenuations exp(−dq·c) (at a fixed TR)
  T dd[3][M];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const T c = has_d && g.valid(i) ? cdiff[q * K + g.order(i)] : T(0);
      dd[q][i] = has_d && !vartr ? exp(-dq * c) : c;
    }
  auto att = [&](int i, T dqt, T (&A)[3]) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
      A[q] = !has_d ? T(1) : (vartr ? exp(-dqt * dd[q][i]) : dd[q][i]);
  };
  T x[6][M];
#pragma unroll
  for (int q = 0; q < 6; ++q)
#pragma unroll
    for (int i = 0; i < M; ++i) x[q][i] = T(0);
  if (g.l == 0) x[4][0] = z0;
  T* const out = sig + a * nTR * 2;
  const int64_t plane = (int64_t)6 * K * nA;
  StepS<T> own{};    // under b1 or variable TR/TE: TR t0 + l's scalars
  T er = 0, ei = 0;  // TR t's echo on lane t mod G
  T f0[2] = {0, 0};
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
    if (spread && tl == 0 && t + g.l < nTR)
      own = step_scalars(coef, nTR, t + g.l, p, b1, dq, has_b1, vartr);
    const StepS<T> s =
        spread ? step_from(own, tl, G)
               : step_scalars(coef, nTR, t, p, b1, dq, false, false);
    step_lanes(x, s, att, has_d, kshift, g, f0);
    // the echo: lane 0's F+(0) of the mixed state, demodulated, with its
    // TE decay
    const T fr = lanes::shfl(f0[0], 0, G), fi = lanes::shfl(f0[1], 0, G);
    if (g.l == tl) {
      er = s.f.E2te * (s.tg.c1 * fr + s.tg.s1 * fi);
      ei = s.f.E2te * (s.tg.c1 * fi - s.tg.s1 * fr);
    }
    if (active && (tl == G - 1 || t == nTR - 1) && g.l <= tl) {
      T* const o = out + 2 * (t - tl + g.l);
      o[0] = er;
      o[1] = ei;
    }
  }
}

// The launch at M slots a lane: the instances are M 1 … kSlotsMax, each
// passing a run-time M it is not on to the next.
template <typename T, int M = 1>
int launch_fwd_lanes_m(int64_t m, const T* coef, const T* par,
                       const T* cdiff, T* sig, T* chk, int64_t nA,
                       int64_t nTR, int64_t K, int64_t kshift, int64_t flags,
                       int64_t tc, int lg, void* stream) {
  if (m != M) {
    if constexpr (M < kSlotsMax<T>)
      return launch_fwd_lanes_m<T, M + 1>(m, coef, par, cdiff, sig, chk, nA,
                                          nTR, K, kshift, flags, tc, lg,
                                          stream);
    else
      return (int)cudaErrorInvalidValue;
  }
  const int A = lanes::kThreads >> lg;
  // one shared state an atom
  const size_t smem = (size_t)A * lanes::stride(6, M, 1 << lg) * sizeof(T);
  if (!lanes::smem_fits(smem)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spgr_fwd_lanes_kernel<T, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + A - 1) / A);
  spgr_fwd_lanes_kernel<T, M><<<grid, lanes::kThreads, smem,
                                (cudaStream_t)stream>>>(
      coef, par, cdiff, sig, chk, nA, nTR, (int)K, (int)kshift, (int)flags,
      tc, lg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_spgr_fwd_lanes(const T* coef, const T* par, const T* cdiff,
                          T* sig, T* chk, int64_t nA, int64_t nTR, int64_t nC,
                          int64_t K, int64_t kshift, int64_t flags,
                          int64_t tc, int64_t G, int64_t M, void* stream) {
  if (nA <= 0 || nTR <= 0 || K <= 0 || kshift == 0 || tc <= 0 ||
      nTR % tc != 0 || nC != ((flags & kVarTR) ? 11 : 9) ||
      (flags & ~(int64_t)(kB1 | kVarTR | kDiff)) != 0 ||
      !lanes::valid_cfg(G, M, K) || chk == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_fwd_lanes_m<T>(M, coef, par, cdiff, sig, chk, nA, nTR, K,
                               kshift, flags, tc, lanes::log2i((int)G),
                               stream);
}

}  // namespace spgr
}  // namespace mrphy

// Inputs (coef (nC, nTR), par (7, nA), cdiff (3, K)), the echoes sig (nA,
// nTR, 2) and the checkpoints chk (nTR / tc, 6, K, nA); sizes, kshift,
// flags (1 b1, 2 variable TR/TE, 4 diffusion), tc, the lanes per atom G
// and the slots a lane M = ⌈K/G⌉. Returns the cudaError_t of the launch (0
// = success; cudaErrorInvalidValue for arguments out of range, an M past
// the instances or a block's shared memory past the device's limit).
#define MRPHY_SPGR_FWD_LANES_ENTRY(NAME, T)                                   \
  extern "C" int NAME(const void* coef, const void* par, const void* cdiff,  \
                      void* sig, void* chk, int64_t nA, int64_t nTR,         \
                      int64_t nC, int64_t K, int64_t kshift, int64_t flags,  \
                      int64_t tc, int64_t G, int64_t M, void* stream) {       \
    return mrphy::spgr::launch_spgr_fwd_lanes<T>(                             \
        (const T*)coef, (const T*)par, (const T*)cdiff, (T*)sig, (T*)chk, nA, \
        nTR, nC, K, kshift, flags, tc, G, M, stream);                         \
  }

MRPHY_SPGR_FWD_LANES_ENTRY(mrphy_spgr_fwd_chk_lanes_f32, float)
MRPHY_SPGR_FWD_LANES_ENTRY(mrphy_spgr_fwd_chk_lanes_f64, double)
