// xspgr_fwd: the two-pool EPG-X gradient-spoiled train (exchange-sensitive
// MRF dictionaries) on Hopper (sm_90a), at a fixed TR or a variable-TR
// train, with and without chunk checkpoints.
//
// Replaces four TPU kernels of mrphy_tpu/ops/epg_pallas.py: `_epgx_kernel`
// (launched by `_xspgr_core`), the dictionary's forward at a fixed TR, as
// the entry points mrphy_xspgr_fwd_*; `_xspgr_fwd_chk_kernel` (launched by
// `_xspgr_core_fwd`), the same train writing the state at the start of
// every chunk of tc TRs for the adjoint xspgr_bwd, as mrphy_xspgr_fwd_chk_*;
// and their variable-TR counterparts `_epgx_v_kernel` (`_xspgr_core_v`) and
// `_xv_fwd_chk_kernel` (`_xspgr_core_v_fwd`), as mrphy_xspgr_v_fwd_* and
// mrphy_xspgr_v_fwd_chk_*. Per atom and TR: the RF mix on pool a and on
// pool b, the echo (the total Fa+(0) + Fb+(0) demodulated by the transmit
// phase), the exact exchange-relaxation of every order (the complex 2×2
// propagator on F+, its conjugate on F−, the real 2×2 on Z with the affine
// recovery into Z(0)), and |kshift| unit shifts of both pools. Options:
// per-atom b1 (half-angle trig per atom and TR), any nonzero kshift, any K.
// At a fixed TR the 14 propagator entries are per-atom rows of par; over a
// variable-TR train they are read per step from the planes pkt (nTR, 14,
// nA), one coalesced load of each entry across the atoms.
//
// What bounds it on the H100: arithmetic. Per atom, order and TR the two
// mixes and the exchange-relaxation are ~155 multiplies and adds without
// FMA contraction: ~2e11 operations at 65,536 atoms × 400 TRs × K 48, ~3
// ms at the card's float32 peak. Device memory sees the per-atom rows
// once (the variable-TR planes once: 1.47 GB at 65,536 atoms × 400 TRs in
// float32, ~0.44 ms), the echoes (210 MB there) and the checkpoints.
//
// Design. One thread per atom walks the whole train, as spgr_fwd does; its
// 12·K state values (2.3 KB at K 48 in float32) live in shared memory,
// planes strided by the block's threads, both pools' F± planes ring
// buffers over the orders that share one pair of offsets (the pools shift
// alike). At K 48 a 32-thread block holds 74 KB, three blocks an SM: 96
// resident threads (kernels/epg.py `launch_cfg` with 12 planes); where
// even 32 threads' states exceed a block's shared memory (K > 151 in
// float32, K > 75 in float64) the state lives in device memory (stride
// nA, coalesced). The 14 propagator entries sit in registers (reloaded
// every step over a variable-TR train); per-TR coefficients are read by
// every thread at one address (a broadcast). Built without FMA
// contraction, in the plain version's order of operations
// (kernels/epgx.py `xspgr_fwd_torch`, `xspgr_v_fwd_torch`): the two agree
// bit for bit. Templated on the scalar type, on the checkpoints and on the
// variable-TR train.
#include "epgx_common.cuh"

namespace mrphy {
namespace epgx {

using spgr::Trig;

// par: (17, nA) at a fixed TR; over a variable-TR train (VARTR) the rows
// [M0a, M0b, b1] (3, nA), the entries of step t at pkt + t·14·nA.
template <typename T, bool CHK, bool VARTR>
__global__ void xspgr_fwd_kernel(const T* __restrict__ coef,
                                 const T* __restrict__ par,
                                 const T* __restrict__ pkt,
                                 T* __restrict__ sig, T* __restrict__ chk,
                                 T* __restrict__ gstate, int64_t nA,
                                 int64_t nTR, int K, int kshift, int flags,
                                 int64_t tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t a = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= nA) return;
  const bool has_b1 = flags & spgr::kB1;
  const Planes<T> st =
      gstate ? Planes<T>{gstate + a, nA, K}
             : Planes<T>{reinterpret_cast<T*>(smem_raw) + threadIdx.x,
                         (int64_t)blockDim.x, K};
  const Planes<T> sb = pool_b(st);
  Prop<T> e{};
  if constexpr (!VARTR) e = load_prop(par, nA, a);
  const T* pm = VARTR ? par : par + 14 * nA;  // [M0a, M0b, b1]
  const T M0a = pm[a], M0b = pm[nA + a], b1 = pm[2 * nA + a];
  for (int p = 0; p < kPlanes; ++p)
    for (int k = 0; k < K; ++k) st(p, k) = T(0);
  st(4, 0) = M0a;
  sb(4, 0) = M0b;
  int op = 0, om = 0;  // the ring offsets of F+ and F− (both pools)
  T* out = sig + a * nTR * 2;
  for (int64_t t = 0; t < nTR; ++t) {
    if (CHK && t % tc == 0) {
      // the chunk's start state, orders in logical order
      T* c = chk + (t / tc) * kPlanes * K * nA + a;
      int ip = op, im = om;
      for (int k = 0; k < K; ++k) {
        for (int q = 0; q < 2; ++q) {
          const Planes<T>& s = q ? sb : st;
          T* cq = c + (int64_t)6 * q * K * nA;
          cq[(0 * (int64_t)K + k) * nA] = s(0, ip);
          cq[(1 * (int64_t)K + k) * nA] = s(1, ip);
          cq[(2 * (int64_t)K + k) * nA] = s(2, im);
          cq[(3 * (int64_t)K + k) * nA] = s(3, im);
          cq[(4 * (int64_t)K + k) * nA] = s(4, k);
          cq[(5 * (int64_t)K + k) * nA] = s(5, k);
        }
        ip = spgr::wrap_inc(ip, K);
        im = spgr::wrap_inc(im, K);
      }
    }
    if constexpr (VARTR) e = load_prop(pkt + t * 14 * nA, nA, a);
    const Trig<T> g = spgr::trig(coef, nTR, t, b1, has_b1);
    int ip = op, im = om;
    for (int k = 0; k < K; ++k) {
      const T xa[6] = {st(0, ip), st(1, ip), st(2, im),
                       st(3, im), st(4, k),  st(5, k)};
      const T xb[6] = {sb(0, ip), sb(1, ip), sb(2, im),
                       sb(3, im), sb(4, k),  sb(5, k)};
      T na[6], nb[6];
      spgr::mix(g, xa, na);
      spgr::mix(g, xb, nb);
      if (k == 0) {
        const T fr = na[0] + nb[0], fi = na[1] + nb[1];
        out[2 * t] = g.c1 * fr + g.s1 * fi;
        out[2 * t + 1] = g.c1 * fi - g.s1 * fr;
      }
      xrelax(e, k, na, nb);
      st(0, ip) = na[0];
      st(1, ip) = na[1];
      st(2, im) = na[2];
      st(3, im) = na[3];
      st(4, k) = na[4];
      st(5, k) = na[5];
      sb(0, ip) = nb[0];
      sb(1, ip) = nb[1];
      sb(2, im) = nb[2];
      sb(3, im) = nb[3];
      sb(4, k) = nb[4];
      sb(5, k) = nb[5];
      ip = spgr::wrap_inc(ip, K);
      im = spgr::wrap_inc(im, K);
    }
    ring_shift2(st, op, om, kshift);
  }
}

template <typename T, bool CHK, bool VARTR>
int launch_xspgr_fwd(const T* coef, const T* par, const T* pkt, T* sig,
                     T* chk, T* gstate, int64_t nA, int64_t nTR, int64_t K,
                     int64_t kshift, int64_t flags, int64_t tc,
                     int64_t threads, void* stream) {
  if (nA <= 0 || nTR <= 0 || K <= 0 || kshift == 0 || tc <= 0 ||
      nTR % tc != 0 || !spgr::valid_threads((int)threads) ||
      (CHK && chk == nullptr) || (VARTR && pkt == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      gstate ? 0 : (size_t)threads * kPlanes * (size_t)K * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        xspgr_fwd_kernel<T, CHK, VARTR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + threads - 1) / threads);
  xspgr_fwd_kernel<T, CHK, VARTR><<<grid, (unsigned)threads, smem,
                                    (cudaStream_t)stream>>>(
      coef, par, pkt, sig, chk, gstate, nA, nTR, (int)K, (int)kshift,
      (int)flags, tc);
  return (int)cudaGetLastError();
}

}  // namespace epgx
}  // namespace mrphy

// Inputs (coef (9, nTR), par (17, nA)), the echoes sig (nA, nTR, 2), the
// checkpoints chk (nTR / tc, 12, K, nA) (the _chk entries only), the state
// in device memory gstate (12, K, nA) or NULL to keep it in shared memory;
// sizes, kshift, flags (1 b1), tc, threads per block. Returns the
// cudaError_t of the launch (0 = success).
#define MRPHY_XSPGR_FWD_ENTRY(NAME, T, CHK)                                  \
  extern "C" int NAME(const void* coef, const void* par, void* sig,         \
                      void* chk, void* gstate, int64_t nA, int64_t nTR,     \
                      int64_t K, int64_t kshift, int64_t flags, int64_t tc, \
                      int64_t threads, void* stream) {                       \
    return mrphy::epgx::launch_xspgr_fwd<T, CHK, false>(                     \
        (const T*)coef, (const T*)par, nullptr, (T*)sig, (T*)chk,            \
        (T*)gstate, nA, nTR, K, kshift, flags, tc, threads, stream);         \
  }

MRPHY_XSPGR_FWD_ENTRY(mrphy_xspgr_fwd_f32, float, false)
MRPHY_XSPGR_FWD_ENTRY(mrphy_xspgr_fwd_f64, double, false)
MRPHY_XSPGR_FWD_ENTRY(mrphy_xspgr_fwd_chk_f32, float, true)
MRPHY_XSPGR_FWD_ENTRY(mrphy_xspgr_fwd_chk_f64, double, true)

// The variable-TR train: inputs coef (9, nTR), pk (3, nA) = [M0a, M0b, b1]
// and the per-step propagator planes pkt (nTR, 14, nA); the rest as above.
#define MRPHY_XSPGR_V_FWD_ENTRY(NAME, T, CHK)                                \
  extern "C" int NAME(const void* coef, const void* pk, const void* pkt,    \
                      void* sig, void* chk, void* gstate, int64_t nA,       \
                      int64_t nTR, int64_t K, int64_t kshift, int64_t flags, \
                      int64_t tc, int64_t threads, void* stream) {           \
    return mrphy::epgx::launch_xspgr_fwd<T, CHK, true>(                      \
        (const T*)coef, (const T*)pk, (const T*)pkt, (T*)sig, (T*)chk,       \
        (T*)gstate, nA, nTR, K, kshift, flags, tc, threads, stream);         \
  }

MRPHY_XSPGR_V_FWD_ENTRY(mrphy_xspgr_v_fwd_f32, float, false)
MRPHY_XSPGR_V_FWD_ENTRY(mrphy_xspgr_v_fwd_f64, double, false)
MRPHY_XSPGR_V_FWD_ENTRY(mrphy_xspgr_v_fwd_chk_f32, float, true)
MRPHY_XSPGR_V_FWD_ENTRY(mrphy_xspgr_v_fwd_chk_f64, double, true)
