// cpmg_fwd_lanes: K17 `cpmg_fwd_chk`, the CPMG spin-echo train (single
// pool) with chunk checkpoints, on its lane route: a group of G lanes per
// atom over the orders, the state in registers (Hopper, sm_90a).
//
// Replaces the TPU kernel `_cpmg_fwd_chk_kernel` (launched by
// `_cpmg_core_fwd`, mrphy_tpu/ops/epg_pallas.py), as cpmg_fwd.cu's _chk
// entry points do; the wrapper (kernels/epg.py `forward_cfg` at 6 planes)
// takes this route where an atom's orders fit M ≤ kSlotsMax slots a lane of
// G = 8, 16 or 32 lanes, and cpmg_fwd.cu's one thread per atom otherwise
// (K 401, float64 K 201, and the state in device memory). Inputs and
// outputs are cpmg_fwd.cu's: the echoes er, ei (nE, nA) and the pre-echo
// state at the start of every chunk of tc echoes, chk (nE/tc, 6, K, nA),
// the layout the adjoint K18 reads on either of its routes.
//
// What bounds it on the H100: writing the checkpoints (6.6 GB at 1,048,576
// atoms × 32 echoes, K 33, tc 4, in float32: ~2.0 ms), then arithmetic
// (~40 operations per atom, order and echo). The one-thread route kept
// 6·K values a thread in shared memory: 8 warps an SM at K 33, one
// dependent chain each, every order's 6 values through shared memory twice
// per half echo.
//
// Design (epg_lanes.cuh, cpmg_lanes.cuh). From the excitation's closed-form
// state in lane 0's slot 0, per echo: a half (`half_lanes`: relaxation with
// recovery and the diffusion attenuation of each lane's orders, the
// crusher's unit shift by shuffles), the refocusing mix about +x
// (`mix_lanes`) and a second half, all in registers; the echo F+(0) is lane
// 0's. Lane t mod G keeps echo t's; every G echoes the groups put theirs in
// shared memory and the block writes the rows (echo, atoms), each along its
// atoms. At a chunk start each group stores its state into its atom's slot
// and, after a block sync, the block writes the rows (plane, order < K)
// along its atoms (`lanes::unstage`). Under b1 or a spacing train lane l
// forms the scalars (refocusing trig, the halves' factors through expm1,
// the diffusion step) of echo t0 + l of each run of G echoes and the group
// shares them by shuffles; diffusion's attenuations are each lane's own,
// from cdiff (3, K). Built for kBlocks blocks an SM. Built without FMA
// contraction, in the plain version's order of operations (kernels/epg.py
// `cpmg_fwd_chk_torch`): echoes and checkpoints agree bit for bit.
#include "cpmg_lanes.cuh"

namespace mrphy {
namespace cpmg {

// The largest M built (kernels/epg.py FWD_SLOTS_MAX at 6 planes), and the
// blocks an SM each instance is built for: 4 (16 warps, at most 128
// registers a thread) in float32 and float64 M 1, 3 (12 warps, 168) for
// float64 M ≥ 2, which ptxas -v showed spilling at 128.
template <typename T>
constexpr int kSlotsMax = sizeof(T) == 4 ? 8 : 4;
template <typename T, int M>
constexpr int kBlocks = sizeof(T) == 4 || M == 1 ? 4 : 3;

template <typename T, int M>
__global__ void __launch_bounds__(lanes::kThreads, (kBlocks<T, M>))
    cpmg_fwd_lanes_kernel(const T* __restrict__ coef,
                          const T* __restrict__ par, const T* __restrict__ dqr,
                          const T* __restrict__ cdiff, T* __restrict__ er,
                          T* __restrict__ ei, T* __restrict__ chk, int64_t nA,
                          int64_t nE, int flags, int64_t tc, int lg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const slots = reinterpret_cast<T*>(smem_raw);
  const int G = 1 << lg, lgA = lanes::log2i(lanes::kThreads) - lg;
  const int ab = threadIdx.x >> lg;
  const Group g{(int)threadIdx.x & (G - 1), G, (int)nE + 1};
  const int K = g.K;
  const int64_t a0 = (int64_t)blockIdx.x << lgA, a = a0 + ab;
  const bool active = a < nA;
  const bool has_b1 = flags & kB1, varesp = flags & kVarEsp,
             has_d = flags & kDiff;
  const bool spread = has_b1 || varesp;
  const int st_atom = lanes::stride(6, M, G);
  T* const mine = slots + ab * st_atom;
  // the echoes of a run of G, (2, G, A) after the slots
  T* const ebuf = slots + (st_atom << lgA);
  T p0 = 0, p1 = 0, p2 = 0, e_ss = 0, e_sc = 0, e_ca = 0, b1 = 0, dq = 0;
  if (active) {
    p0 = par[a];
    p1 = par[nA + a];
    p2 = par[2 * nA + a];
    e_ss = par[3 * nA + a];
    e_sc = par[4 * nA + a];
    e_ca = par[5 * nA + a];
    b1 = par[6 * nA + a];
    dq = dqr[a];
  }
  T x[6][M];
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int i = 0; i < M; ++i) x[p][i] = T(0);
  if (g.l == 0) {
    // the excitation's state: F+(0) = (e_ss, −e_sc), F−(0) = (e_ss, e_sc),
    // Z(0) = e_ca
    x[0][0] = e_ss;
    x[1][0] = -e_sc;
    x[2][0] = e_ss;
    x[3][0] = e_sc;
    x[4][0] = e_ca;
  }
  const int64_t plane = (int64_t)6 * K * nA;
  EchoS<T> own{};  // under b1 or a train: echo t0 + l's scalars
  T vr = 0, vi = 0;  // echo t on lane t mod G
  int64_t left = 0;  // echoes to the next chunk start
  for (int64_t t = 0; t < nE; ++t) {
    const int tl = (int)(t & (G - 1));
    if (left == 0) {
      // the chunk's start state, through the atom's shared slot
      lanes::checkpoint(chk + (t / tc) * plane, x, mine, slots, nA, a0, lgA,
                        lg, st_atom, g);
      left = tc;
    }
    --left;
    if (spread && tl == 0 && t + g.l < nE)
      own = echo_scalars(coef, nE, t + g.l, p0, p1, p2, b1, dq, has_b1,
                         varesp);
    const EchoS<T> e =
        spread ? echo_from(own, tl, G)
               : echo_scalars(coef, nE, t, p0, p1, p2, b1, dq, false, false);
    half_lanes(x, e, cdiff, has_d, g);
    mix_lanes(x, e.tg, g);
    half_lanes(x, e, cdiff, has_d, g);
    // the echo: F+(0), lane 0's
    const T fr = lanes::shfl(x[0][0], 0, G);
    const T fi = lanes::shfl(x[1][0], 0, G);
    if (g.l == tl) {
      vr = fr;
      vi = fi;
    }
    if (tl == G - 1 || t == nE - 1)
      lanes::echo_run(er, ei, ebuf, vr, vi, t, tl, nA, a0, lgA, ab, g);
  }
}

// The launch at M slots a lane: the instances are M 1 … kSlotsMax, each
// passing a run-time M it is not on to the next.
template <typename T, int M = 1>
int launch_fwd_lanes_m(int64_t m, const T* coef, const T* par, const T* dq,
                       const T* cdiff, T* er, T* ei, T* chk, int64_t nA,
                       int64_t nE, int64_t flags, int64_t tc, int lg,
                       void* stream) {
  if (m != M) {
    if constexpr (M < kSlotsMax<T>)
      return launch_fwd_lanes_m<T, M + 1>(m, coef, par, dq, cdiff, er, ei,
                                          chk, nA, nE, flags, tc, lg, stream);
    else
      return (int)cudaErrorInvalidValue;
  }
  const int G = 1 << lg, A = lanes::kThreads >> lg;
  // one shared state an atom, then the run of echoes
  const size_t smem =
      ((size_t)A * lanes::stride(6, M, G) + 2 * G * A) * sizeof(T);
  if (!lanes::smem_fits(smem)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cpmg_fwd_lanes_kernel<T, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + A - 1) / A);
  cpmg_fwd_lanes_kernel<T, M><<<grid, lanes::kThreads, smem,
                                (cudaStream_t)stream>>>(
      coef, par, dq, cdiff, er, ei, chk, nA, nE, (int)flags, tc, lg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cpmg_fwd_lanes(const T* coef, const T* par, const T* dq,
                          const T* cdiff, T* er, T* ei, T* chk, int64_t nA,
                          int64_t nE, int64_t nC, int64_t flags, int64_t tc,
                          int64_t G, int64_t M, void* stream) {
  if (!valid_args(nA, nE, nC, flags, tc, lanes::kThreads) ||
      !lanes::valid_cfg(G, M, nE + 1) || chk == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_fwd_lanes_m<T>(M, coef, par, dq, cdiff, er, ei, chk, nA, nE,
                               flags, tc, lanes::log2i((int)G), stream);
}

}  // namespace cpmg
}  // namespace mrphy

// Inputs (coef (nC, nE), par (7, nA), dq (1, nA), cdiff (3, K)), the echoes
// er, ei (nE, nA) and the checkpoints chk (nE / tc, 6, K, nA); sizes, flags
// (1 b1, 2 spacing train, 4 diffusion), tc, the lanes per atom G and the
// slots a lane M = ⌈K/G⌉. Returns the cudaError_t of the launch (0 =
// success; cudaErrorInvalidValue for arguments out of range, an M past the
// instances or a block's shared memory past the device's limit).
#define MRPHY_CPMG_FWD_LANES_ENTRY(NAME, T)                                  \
  extern "C" int NAME(const void* coef, const void* par, const void* dq,    \
                      const void* cdiff, void* er, void* ei, void* chk,     \
                      int64_t nA, int64_t nE, int64_t nC, int64_t flags,    \
                      int64_t tc, int64_t G, int64_t M, void* stream) {      \
    return mrphy::cpmg::launch_cpmg_fwd_lanes<T>(                            \
        (const T*)coef, (const T*)par, (const T*)dq, (const T*)cdiff,        \
        (T*)er, (T*)ei, (T*)chk, nA, nE, nC, flags, tc, G, M, stream);       \
  }

MRPHY_CPMG_FWD_LANES_ENTRY(mrphy_cpmg_fwd_chk_lanes_f32, float)
MRPHY_CPMG_FWD_LANES_ENTRY(mrphy_cpmg_fwd_chk_lanes_f64, double)
