// spgr_fwd: the gradient-spoiled EPG train (SPGR / MRF-FISP) on Hopper
// (sm_90a), with and without chunk checkpoints.
//
// Replaces two TPU kernels of mrphy_tpu/ops/epg_pallas.py: `_spgr_kernel`
// (launched by `_spgr_fast`), the dictionary's forward, as the entry points
// mrphy_spgr_fwd_*; and `_spgr_fwd_chk_kernel` (launched by
// `_spgr_fwd_chk`), the same train writing the state at the start of every
// chunk of tc TRs for the adjoint spgr_bwd, as mrphy_spgr_fwd_chk_*. Per
// atom and TR: the RF mix, the echo F+(0) demodulated by the transmit phase
// with its TE decay, relaxation with recovery into Z(0), the spoiler's
// diffusion attenuation (has_d; 3 exps per order, per TR under variable
// TR), and |kshift| unit shifts of the orders. Options: per-atom b1
// (half-angle trig per atom and TR), variable TR/TE (factors formed per TR
// with expm1), diffusion, any nonzero kshift, an initial Z(0) (zinit).
//
// What bounds it on the H100: arithmetic. Per atom, order and TR the mix
// and relaxation are ~45 multiplies and adds without FMA contraction (~60
// with diffusion, plus its exps): 7.5e10 operations at 65,536 atoms × 400
// TRs × K 48, ~1 ms at the card's float32 peak. Device memory sees the
// per-atom rows once, the echoes (210 MB there) and the checkpoints.
//
// Design. One thread per atom walks the whole train; its state (6·K values:
// 1.1 KB at K 48 in float32, 2.4k values at the default K = nTR·|kshift| + 1
// of a 400-TR train, past a thread's 255 registers) lives in shared memory,
// planes strided by the block's threads so that a warp's accesses fall in
// distinct banks; the wrapper picks 32, 64 or 128 threads per block for the
// most resident threads per SM. Where even 32 threads' states would exceed
// a block's shared memory, the state lives in device memory (stride nA,
// coalesced). The F± planes are ring buffers over the orders: the spoiler's
// unit shift moves two offsets and writes the k = 0 crossing and the
// dropped order K − 1, so each TR is one pass over the orders. K is a
// run-time value. Per-TR coefficients are read by every thread at one
// address (a broadcast). Built without FMA contraction, in the plain
// version's order of operations (kernels/epg.py `spgr_fwd_torch`): the two
// agree bit for bit. Templated on the scalar type (float for production,
// double for a tight check against JAX in float64) and on the checkpoints.
#include "spgr_common.cuh"

namespace mrphy {
namespace spgr {

template <typename T, bool CHK>
__global__ void spgr_fwd_kernel(const T* __restrict__ coef,
                                const T* __restrict__ par,
                                const T* __restrict__ cdiff,
                                T* __restrict__ sig, T* __restrict__ chk,
                                T* __restrict__ gstate, int64_t nA,
                                int64_t nTR, int K, int kshift, int flags,
                                int64_t tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t a = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= nA) return;
  const bool has_b1 = flags & kB1, vartr = flags & kVarTR,
             has_d = flags & kDiff;
  const Planes<T> st =
      gstate ? Planes<T>{gstate + a, nA, K}
             : Planes<T>{reinterpret_cast<T*>(smem_raw) + threadIdx.x,
                         (int64_t)blockDim.x, K};
  const T p0 = par[a], p1 = par[nA + a], p2 = par[2 * nA + a],
          p3 = par[3 * nA + a], z0 = par[4 * nA + a], b1 = par[5 * nA + a],
          dq = par[6 * nA + a];
  for (int p = 0; p < 6; ++p)
    for (int k = 0; k < K; ++k) st(p, k) = T(0);
  st(4, 0) = z0;
  const int nshift = kshift > 0 ? kshift : -kshift;
  int op = 0, om = 0;  // the ring offsets of F+ and F−
  T* out = sig + a * nTR * 2;
  for (int64_t t = 0; t < nTR; ++t) {
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
        ip = wrap_inc(ip, K);
        im = wrap_inc(im, K);
      }
    }
    const Trig<T> g = trig(coef, nTR, t, b1, has_b1);
    const Factors<T> f = factors(coef, nTR, t, p0, p1, p2, p3, vartr);
    const T dqt = vartr ? dq * coef[9 * nTR + t] : dq;
    int ip = op, im = om;
    for (int k = 0; k < K; ++k) {
      const T x[6] = {st(0, ip), st(1, ip), st(2, im),
                      st(3, im), st(4, k),  st(5, k)};
      T n[6];
      mix(g, x, n);
      if (k == 0) {
        out[2 * t] = f.E2te * (g.c1 * n[0] + g.s1 * n[1]);
        out[2 * t + 1] = f.E2te * (g.c1 * n[1] - g.s1 * n[0]);
      }
      T A[3] = {T(1), T(1), T(1)};
      if (has_d) attenuation(cdiff, K, k, dqt, A);
      relax(f, k, has_d, A, n);
      st(0, ip) = n[0];
      st(1, ip) = n[1];
      st(2, im) = n[2];
      st(3, im) = n[3];
      st(4, k) = n[4];
      st(5, k) = n[5];
      ip = wrap_inc(ip, K);
      im = wrap_inc(im, K);
    }
    for (int u = 0; u < nshift; ++u) ring_shift(st, op, om, kshift > 0);
  }
}

template <typename T, bool CHK>
int launch_spgr_fwd(const T* coef, const T* par, const T* cdiff, T* sig,
                    T* chk, T* gstate, int64_t nA, int64_t nTR, int64_t nC,
                    int64_t K, int64_t kshift, int64_t flags, int64_t tc,
                    int64_t threads, void* stream) {
  if (nA <= 0 || nTR <= 0 || K <= 0 || kshift == 0 || tc <= 0 ||
      nTR % tc != 0 || nC != ((flags & kVarTR) ? 11 : 9) ||
      !valid_threads((int)threads) || (CHK && chk == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      gstate ? 0 : (size_t)threads * 6 * (size_t)K * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spgr_fwd_kernel<T, CHK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + threads - 1) / threads);
  spgr_fwd_kernel<T, CHK><<<grid, (unsigned)threads, smem,
                            (cudaStream_t)stream>>>(
      coef, par, cdiff, sig, chk, gstate, nA, nTR, (int)K, (int)kshift,
      (int)flags, tc);
  return (int)cudaGetLastError();
}

}  // namespace spgr
}  // namespace mrphy

// Inputs (coef, par, cdiff), the echoes sig (nA, nTR, 2), the checkpoints
// chk (nTR / tc, 6, K, nA) (the _chk entries only), the state in device
// memory gstate (6, K, nA) or NULL to keep it in shared memory; sizes,
// kshift, flags (1 b1, 2 variable TR/TE, 4 diffusion), tc, threads per
// block. Returns the cudaError_t of the launch (0 = success).
#define MRPHY_SPGR_FWD_ENTRY(NAME, T, CHK)                                    \
  extern "C" int NAME(const void* coef, const void* par, const void* cdiff,  \
                      void* sig, void* chk, void* gstate, int64_t nA,        \
                      int64_t nTR, int64_t nC, int64_t K, int64_t kshift,    \
                      int64_t flags, int64_t tc, int64_t threads,            \
                      void* stream) {                                         \
    return mrphy::spgr::launch_spgr_fwd<T, CHK>(                              \
        (const T*)coef, (const T*)par, (const T*)cdiff, (T*)sig, (T*)chk,     \
        (T*)gstate, nA, nTR, nC, K, kshift, flags, tc, threads, stream);      \
  }

MRPHY_SPGR_FWD_ENTRY(mrphy_spgr_fwd_f32, float, false)
MRPHY_SPGR_FWD_ENTRY(mrphy_spgr_fwd_f64, double, false)
MRPHY_SPGR_FWD_ENTRY(mrphy_spgr_fwd_chk_f32, float, true)
MRPHY_SPGR_FWD_ENTRY(mrphy_spgr_fwd_chk_f64, double, true)
