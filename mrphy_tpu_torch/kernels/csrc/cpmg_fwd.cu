// cpmg_fwd: the CPMG spin-echo train (single pool) on Hopper (sm_90a), with
// and without chunk checkpoints.
//
// Replaces two TPU kernels of mrphy_tpu/ops/epg_pallas.py: `_cpmg_kernel`
// (launched by `_cpmg_core`), the echo train of T2 mapping, as the entry
// points mrphy_cpmg_fwd_*; and `_cpmg_fwd_chk_kernel` (launched by
// `_cpmg_core_fwd`), the same train writing the pre-echo state at the start
// of every chunk of tc echoes for the adjoint cpmg_bwd, as
// mrphy_cpmg_fwd_chk_*. The excitation is the closed-form state it leaves
// (F± = sinα·(sinφ ∓ i·cosφ)·M0, Z = cosα·M0). Per atom and echo: relaxation
// over esp/2 with recovery into Z(0) (and the crusher's diffusion
// attenuation), a unit shift, the refocusing mix about +x, the same half
// again, and the echo F+(0). Options: per-atom b1 (half-angle trig per atom
// and echo), a per-echo spacing train (factors formed per echo with expm1),
// diffusion (3 exps per order and half).
//
// What bounds it on the H100: arithmetic. Per atom, order and echo the two
// halves and the mix are ~40 multiplies and adds without FMA contraction:
// ~4.4e10 operations at 1,048,576 atoms × 32 echoes × K 33, under 1 ms at the
// card's float32 peak. Device memory sees the per-atom rows once, the echoes
// (268 MB there) and, for K17, the checkpoints (0.83 GB each).
//
// Design, as spgr_fwd.cu: one thread per atom walks the whole train; its
// state (6·K values, 792 B at K 33 in float32) lives in shared memory,
// planes strided by the block's threads, 32/64/128 threads a block as the
// wrapper chose (kernels/epg.py `launch_cfg`), or in device memory where 32
// threads' states would not fit (K > 295 in float32). F± are ring buffers
// over the orders, so each unit shift moves two offsets and writes two
// slots. Each half is one pass over the orders; the first half's pass
// relaxes in place, the second mixes and relaxes. The echoes are written
// (nE, nA), atoms fastest (coalesced). Built without FMA contraction, in
// the plain version's order of operations (kernels/epg.py `cpmg_fwd_torch`):
// the two agree bit for bit.
#include "cpmg_common.cuh"

namespace mrphy {
namespace cpmg {

using spgr::Planes;

template <typename T, bool CHK>
__global__ void cpmg_fwd_kernel(const T* __restrict__ coef,
                                const T* __restrict__ par,
                                const T* __restrict__ dqr,
                                const T* __restrict__ cdiff,
                                T* __restrict__ er, T* __restrict__ ei,
                                T* __restrict__ chk, T* __restrict__ gstate,
                                int64_t nA, int64_t nE, int flags,
                                int64_t tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t a = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= nA) return;
  const bool has_b1 = flags & kB1, varesp = flags & kVarEsp,
             has_d = flags & kDiff;
  const int K = (int)nE + 1;
  const Planes<T> st =
      gstate ? Planes<T>{gstate + a, nA, K}
             : Planes<T>{reinterpret_cast<T*>(smem_raw) + threadIdx.x,
                         (int64_t)blockDim.x, K};
  const T p0 = par[a], p1 = par[nA + a], p2 = par[2 * nA + a],
          e_ss = par[3 * nA + a], e_sc = par[4 * nA + a],
          e_ca = par[5 * nA + a], b1 = par[6 * nA + a], dq = dqr[a];
  for (int p = 0; p < 6; ++p)
    for (int k = 0; k < K; ++k) st(p, k) = T(0);
  st(0, 0) = e_ss;
  st(1, 0) = -e_sc;
  st(2, 0) = e_ss;
  st(3, 0) = e_sc;
  st(4, 0) = e_ca;
  int op = 0, om = 0;  // the ring offsets of F+ and F−
  for (int64_t t = 0; t < nE; ++t) {
    if (CHK && t % tc == 0) {
      // the chunk's start state, orders in logical order
      T* c = chk + (t / tc) * 6 * K * nA + a;
      int ip = op, im = om;
      for (int k = 0; k < K; ++k) {
        c[(0 * (int64_t)K + k) * nA] = st(0, ip);
        c[(1 * (int64_t)K + k) * nA] = st(1, ip);
        c[(2 * (int64_t)K + k) * nA] = st(2, im);
        c[(3 * (int64_t)K + k) * nA] = st(3, im);
        c[(4 * (int64_t)K + k) * nA] = st(4, k);
        c[(5 * (int64_t)K + k) * nA] = st(5, k);
        ip = spgr::wrap_inc(ip, K);
        im = spgr::wrap_inc(im, K);
      }
    }
    const Trig<T> g = trig(coef, nE, t, b1, has_b1);
    const Factors<T> f = factors(coef, nE, t, p0, p1, p2, varesp);
    const T dqt = varesp ? dq * (T(0.5) * coef[5 * nE + t]) : dq;
    // the first half: relax every order in place, then the unit shift
    int ip = op, im = om;
    for (int k = 0; k < K; ++k) {
      T n[6] = {st(0, ip), st(1, ip), st(2, im), st(3, im), st(4, k), st(5, k)};
      T A[3] = {T(1), T(1), T(1)};
      if (has_d) spgr::attenuation(cdiff, K, k, dqt, A);
      spgr::relax(f, k, has_d, A, n);
      st(0, ip) = n[0];
      st(1, ip) = n[1];
      st(2, im) = n[2];
      st(3, im) = n[3];
      st(4, k) = n[4];
      st(5, k) = n[5];
      ip = spgr::wrap_inc(ip, K);
      im = spgr::wrap_inc(im, K);
    }
    spgr::ring_shift(st, op, om, true);
    // the refocusing, the second half's relaxation, the unit shift
    ip = op;
    im = om;
    for (int k = 0; k < K; ++k) {
      const T x[6] = {st(0, ip), st(1, ip), st(2, im),
                      st(3, im), st(4, k),  st(5, k)};
      T n[6];
      mix0(g, x, n);
      T A[3] = {T(1), T(1), T(1)};
      if (has_d) spgr::attenuation(cdiff, K, k, dqt, A);
      spgr::relax(f, k, has_d, A, n);
      st(0, ip) = n[0];
      st(1, ip) = n[1];
      st(2, im) = n[2];
      st(3, im) = n[3];
      st(4, k) = n[4];
      st(5, k) = n[5];
      ip = spgr::wrap_inc(ip, K);
      im = spgr::wrap_inc(im, K);
    }
    spgr::ring_shift(st, op, om, true);
    er[t * nA + a] = st(0, op);
    ei[t * nA + a] = st(1, op);
  }
}

template <typename T, bool CHK>
int launch_cpmg_fwd(const T* coef, const T* par, const T* dq, const T* cdiff,
                    T* er, T* ei, T* chk, T* gstate, int64_t nA, int64_t nE,
                    int64_t nC, int64_t flags, int64_t tc, int64_t threads,
                    void* stream) {
  if (!valid_args(nA, nE, nC, flags, tc, threads) || (CHK && chk == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      gstate ? 0 : (size_t)threads * 6 * (size_t)(nE + 1) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cpmg_fwd_kernel<T, CHK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + threads - 1) / threads);
  cpmg_fwd_kernel<T, CHK><<<grid, (unsigned)threads, smem,
                            (cudaStream_t)stream>>>(
      coef, par, dq, cdiff, er, ei, chk, gstate, nA, nE, (int)flags, tc);
  return (int)cudaGetLastError();
}

}  // namespace cpmg
}  // namespace mrphy

// Inputs (coef, par, dq, cdiff), the echoes er, ei (nE, nA), the checkpoints
// chk (nE / tc, 6, K, nA) (the _chk entries only), the state in device
// memory gstate (6, K, nA) or NULL to keep it in shared memory; sizes, flags
// (1 b1, 2 spacing train, 4 diffusion), tc, threads per block. Returns the
// cudaError_t of the launch (0 = success).
#define MRPHY_CPMG_FWD_ENTRY(NAME, T, CHK)                                    \
  extern "C" int NAME(const void* coef, const void* par, const void* dq,     \
                      const void* cdiff, void* er, void* ei, void* chk,      \
                      void* gstate, int64_t nA, int64_t nE, int64_t nC,      \
                      int64_t flags, int64_t tc, int64_t threads,            \
                      void* stream) {                                         \
    return mrphy::cpmg::launch_cpmg_fwd<T, CHK>(                              \
        (const T*)coef, (const T*)par, (const T*)dq, (const T*)cdiff,         \
        (T*)er, (T*)ei, (T*)chk, (T*)gstate, nA, nE, nC, flags, tc, threads,  \
        stream);                                                              \
  }

MRPHY_CPMG_FWD_ENTRY(mrphy_cpmg_fwd_f32, float, false)
MRPHY_CPMG_FWD_ENTRY(mrphy_cpmg_fwd_f64, double, false)
MRPHY_CPMG_FWD_ENTRY(mrphy_cpmg_fwd_chk_f32, float, true)
MRPHY_CPMG_FWD_ENTRY(mrphy_cpmg_fwd_chk_f64, double, true)
