// xcpmg_fwd_lanes: K26 `xcpmg_fwd_chk` and, as its echo-spacing-train
// instance, K29 `xcpmg_v_fwd_chk`, the two-pool EPG-X CPMG echo train with
// chunk checkpoints, on their lane route: a group of G lanes per atom over
// the orders, the state in registers (Hopper, sm_90a).
//
// Replaces the TPU kernels `_xcpmg_fwd_chk_kernel` (launched by
// `_xcpmg_core_fwd`) and `_xcv_fwd_chk_kernel` (`_xcpmg_core_v_fwd`) of
// mrphy_tpu/ops/epg_pallas.py, as xcpmg_fwd.cu's _chk entry points do; the
// wrapper (kernels/epg.py `forward_cfg`) takes this route where an atom's
// orders fit M ≤ 5 slots a lane (float32; 2 in float64) of G = 8, 16 or 32
// lanes, and xcpmg_fwd.cu's one thread per atom otherwise (K 161 in
// float32, K 81 in float64). Inputs and outputs are xcpmg_fwd.cu's: the
// echoes er, ei (nE, nA) and the pre-echo state at the start of every chunk
// of tc echoes, chk (nE/tc, 12, K, nA), the layout the adjoints K27/K30
// read on either of their routes.
//
// What bounds it on the H100: writing the checkpoints (3.3 GB at 262,144
// atoms × 32 echoes, K 33, tc 4, in float32: ~1.0 ms), then arithmetic
// (~130 operations per atom, order and echo). The one-thread route kept
// 12·K values a thread in shared memory: 4 warps an SM at K 33, one
// dependent chain each, every order's 12 values through shared memory
// twice per half echo.
//
// Design (epg_lanes.cuh, epgx_lanes.cuh). From the excitation's closed-form
// state in lane 0's slot 0, per echo: a half (`xhalf_lanes`: the
// exchange–relaxation of each lane's orders, the crusher's unit shift by
// shuffles), the refocusing mix about +x (`xmix_lanes`) and a second half,
// all in registers; the echo Fa+(0) + Fb+(0) is lane 0's. Lane t mod G
// keeps echo t's; every G echoes the groups put theirs in shared memory
// and the block writes the rows (echo, atoms), each along its atoms. At a
// chunk start each group stores its state into its atom's slot and, after a
// block sync, the block writes the rows (plane, order < K) along its atoms
// (`lanes::unstage`). Under b1 lane l forms the refocusing trig of echo
// t0 + l of each run of G echoes and the group shares it by shuffles; over
// an echo-spacing train (VARESP) echo t's 14 entries are read once for
// both halves, at the echo. Built for 4 blocks an SM (16 warps, ≤ 128
// registers) in float32 at M ≤ 3, 3 (12 warps) above and in float64
// (lanes::kFwdBlocks). Built without FMA contraction, in the plain
// versions' order of operations (kernels/epgx.py `xcpmg_fwd_chk_torch`,
// `xcpmg_v_fwd_chk_torch`): echoes and checkpoints agree bit for bit.
#include "epgx_lanes.cuh"

namespace mrphy {
namespace xcpmg {

// pk: (19, nA) per-atom rows [E00r, …, Z11, ra, rb, cos φ_ex, sin φ_ex,
// M0a, M0b, b1]; over an echo-spacing train (VARESP) the last five rows
// (5, nA), the entries of echo t at pkt + t·14·nA.
template <typename T, int M, bool VARESP>
__global__ void __launch_bounds__(lanes::kThreads, (lanes::kFwdBlocks<T, M>))
    xcpmg_fwd_lanes_kernel(const T* __restrict__ coef,
                           const T* __restrict__ pk,
                           const T* __restrict__ pkt, T* __restrict__ er,
                           T* __restrict__ ei, T* __restrict__ chk,
                           int64_t nA, int64_t nE, int K, int flags,
                           int64_t tc, int lg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const slots = reinterpret_cast<T*>(smem_raw);
  const int G = 1 << lg, lgA = lanes::log2i(lanes::kThreads) - lg;
  const int ab = threadIdx.x >> lg;
  const Group g{(int)threadIdx.x & (G - 1), G, K};
  const int64_t a0 = (int64_t)blockIdx.x << lgA, a = a0 + ab;
  const bool active = a < nA;
  const bool has_b1 = flags & cpmg::kB1;
  const int st_atom = lanes::stride(kPlanes, M, G);
  T* const mine = slots + ab * st_atom;
  // the echoes of a run of G, (2, G, A) after the slots
  T* const ebuf = slots + (st_atom << lgA);
  // the entries over esp/2 (over a train, echo t's, read at the echo for
  // both halves)
  Prop<T> e{};
  T exc = 0, exs = 0, M0a = 0, M0b = 0, b1 = 0;
  if (active) {
    const T* pm = VARESP ? pk : pk + 14 * nA;  // [exc, exs, M0a, M0b, b1]
    if constexpr (!VARESP) e = epgx::load_prop(pk, nA, a);
    exc = pm[a];
    exs = pm[nA + a];
    M0a = pm[2 * nA + a];
    M0b = pm[3 * nA + a];
    b1 = pm[4 * nA + a];
  }
  T x[kPlanes][M];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p)
#pragma unroll
    for (int i = 0; i < M; ++i) x[p][i] = T(0);
  if (g.l == 0) {
    // the excitation's state, per pool F+(0) = (exs, −exc)·M0p, F−(0) =
    // (exs, exc)·M0p
    x[0][0] = exs * M0a;
    x[1][0] = -exc * M0a;
    x[2][0] = exs * M0a;
    x[3][0] = exc * M0a;
    x[6][0] = exs * M0b;
    x[7][0] = -exc * M0b;
    x[8][0] = exs * M0b;
    x[9][0] = exc * M0b;
  }
  const int64_t plane = (int64_t)kPlanes * K * nA;
  cpmg::Trig<T> own{};  // under b1: echo t0 + l's refocusing trig
  T vr = 0, vi = 0;     // echo t on lane t mod G
  int64_t left = 0;     // echoes to the next chunk start
  for (int64_t t = 0; t < nE; ++t) {
    const int tl = (int)(t & (G - 1));
    if (left == 0) {
      // the chunk's start state, through the atom's shared slot
      lanes::checkpoint(chk + (t / tc) * plane, x, mine, slots, nA, a0, lgA,
                        lg, st_atom, g);
      left = tc;
    }
    --left;
    if (has_b1 && tl == 0 && t + g.l < nE)
      own = cpmg::trig(coef, nE, t + g.l, b1, true);
    const cpmg::Trig<T> tg =
        has_b1 ? trig_from(own, tl, G) : cpmg::trig(coef, nE, t, b1, false);
    if constexpr (VARESP)
      if (active) e = epgx::load_prop(pkt + t * 14 * nA, nA, a);
    xhalf_lanes(x, e, g);
    xmix_lanes(x, tg, g);
    xhalf_lanes(x, e, g);
    // the echo: the total F+(0), lane 0's
    const T fr = lanes::shfl(x[0][0] + x[6][0], 0, G);
    const T fi = lanes::shfl(x[1][0] + x[7][0], 0, G);
    if (g.l == tl) {
      vr = fr;
      vi = fi;
    }
    if (tl == G - 1 || t == nE - 1)
      lanes::echo_run(er, ei, ebuf, vr, vi, t, tl, nA, a0, lgA, ab, g);
  }
}

// The launch at M slots a lane: the instances are M 1-5 in float32, 1-2 in
// float64 (lanes::kFwdSlotsMax, kernels/epg.py FWD_SLOTS_MAX), each
// passing a run-time M it is not on to the next.
template <typename T, bool VARESP, int M = 1>
int launch_fwd_lanes_m(int64_t m, const T* coef, const T* pk, const T* pkt,
                       T* er, T* ei, T* chk, int64_t nA, int64_t nE,
                       int64_t K, int64_t flags, int64_t tc, int lg,
                       void* stream) {
  if (m != M) {
    if constexpr (M < lanes::kFwdSlotsMax<T>)
      return launch_fwd_lanes_m<T, VARESP, M + 1>(m, coef, pk, pkt, er, ei,
                                                  chk, nA, nE, K, flags, tc,
                                                  lg, stream);
    else
      return (int)cudaErrorInvalidValue;
  }
  const int G = 1 << lg, A = lanes::kThreads >> lg;
  // one shared state an atom, then the run of echoes
  const size_t smem =
      ((size_t)A * lanes::stride(kPlanes, M, G) + 2 * G * A) * sizeof(T);
  if (!lanes::smem_fits(smem)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        xcpmg_fwd_lanes_kernel<T, M, VARESP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + A - 1) / A);
  xcpmg_fwd_lanes_kernel<T, M, VARESP><<<grid, lanes::kThreads, smem,
                                         (cudaStream_t)stream>>>(
      coef, pk, pkt, er, ei, chk, nA, nE, (int)K, (int)flags, tc, lg);
  return (int)cudaGetLastError();
}

template <typename T, bool VARESP>
int launch_xcpmg_fwd_lanes(const T* coef, const T* pk, const T* pkt, T* er,
                           T* ei, T* chk, int64_t nA, int64_t nE, int64_t K,
                           int64_t flags, int64_t tc, int64_t G, int64_t M,
                           void* stream) {
  if (nA <= 0 || nE <= 0 || K < 2 || tc <= 0 || nE % tc != 0 ||
      (flags & ~(int64_t)cpmg::kB1) != 0 || !lanes::valid_cfg(G, M, K) ||
      chk == nullptr || (VARESP && pkt == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_fwd_lanes_m<T, VARESP>(M, coef, pk, pkt, er, ei, chk, nA, nE,
                                       K, flags, tc, lanes::log2i((int)G),
                                       stream);
}

}  // namespace xcpmg
}  // namespace mrphy

// Inputs (coef (5, nE), pk (19, nA)), the echoes er, ei (nE, nA) and the
// checkpoints chk (nE / tc, 12, K, nA); sizes, flags (1 b1), tc, the lanes
// per atom G and the slots a lane M = ⌈K/G⌉. Returns the cudaError_t of
// the launch (0 = success; cudaErrorInvalidValue for arguments out of
// range or a block's shared memory past the device's limit).
#define MRPHY_XCPMG_FWD_LANES_ENTRY(NAME, T)                                 \
  extern "C" int NAME(const void* coef, const void* pk, void* er, void* ei, \
                      void* chk, int64_t nA, int64_t nE, int64_t K,         \
                      int64_t flags, int64_t tc, int64_t G, int64_t M,      \
                      void* stream) {                                        \
    return mrphy::xcpmg::launch_xcpmg_fwd_lanes<T, false>(                   \
        (const T*)coef, (const T*)pk, nullptr, (T*)er, (T*)ei, (T*)chk, nA,  \
        nE, K, flags, tc, G, M, stream);                                     \
  }

MRPHY_XCPMG_FWD_LANES_ENTRY(mrphy_xcpmg_fwd_chk_lanes_f32, float)
MRPHY_XCPMG_FWD_LANES_ENTRY(mrphy_xcpmg_fwd_chk_lanes_f64, double)

// The echo-spacing train: inputs coef (5, nE), pk (5, nA) = [cos φ_ex,
// sin φ_ex, M0a, M0b, b1] and the planes pkt (nE, 14, nA), each echo's
// propagator over esp_t/2; the outputs as above.
#define MRPHY_XCPMG_V_FWD_LANES_ENTRY(NAME, T)                               \
  extern "C" int NAME(const void* coef, const void* pk, const void* pkt,    \
                      void* er, void* ei, void* chk, int64_t nA,            \
                      int64_t nE, int64_t K, int64_t flags, int64_t tc,     \
                      int64_t G, int64_t M, void* stream) {                  \
    return mrphy::xcpmg::launch_xcpmg_fwd_lanes<T, true>(                    \
        (const T*)coef, (const T*)pk, (const T*)pkt, (T*)er, (T*)ei,         \
        (T*)chk, nA, nE, K, flags, tc, G, M, stream);                        \
  }

MRPHY_XCPMG_V_FWD_LANES_ENTRY(mrphy_xcpmg_v_fwd_chk_lanes_f32, float)
MRPHY_XCPMG_V_FWD_LANES_ENTRY(mrphy_xcpmg_v_fwd_chk_lanes_f64, double)
