// xmt_fwd: the EPG-X(MT) gradient-spoiled train (qMT dictionaries) on
// Hopper (sm_90a) at a fixed TR and over a variable-TR train, with and
// without chunk checkpoints.
//
// Replaces four TPU kernels of mrphy_tpu/ops/epg_pallas.py: `_mt_kernel`
// (launched by `_mt_core`), the dictionary's forward, as the entry points
// mrphy_xmt_fwd_*; `_mt_fwd_chk_kernel` (launched by `_mt_core_fwd`), the
// same train writing the state at the start of every chunk of tc TRs for
// the adjoint xmt_bwd, as mrphy_xmt_fwd_chk_*; and their variable-TR forms
// `_mtv_kernel` (launched by `_mt_core_v`) and `_mtv_fwd_chk_kernel`
// (launched by `_mt_core_v_fwd`), as mrphy_xmt_v_fwd_* and
// mrphy_xmt_v_fwd_chk_*, which read TR t's 7 propagator entries from the
// per-TR planes pkt (nTR, 7, nA) in place of the per-atom rows (the
// exchange-relaxation over each interval tr[t], built in torch by
// ops/epg.py `_mt_step_entries`). Per atom and TR: the RF
// mix on pool a and the bound pool's saturation Zb ← exp(−wt_t·wscale)·Zb
// (the rank-1 structure of W = π∫ω1²·G(Δ, T2b) over a qMT dictionary: a
// per-TR power train times a per-atom lineshape), the echo (pool a's F+(0)
// demodulated by the transmit phase), pool a's transverse decay E2a, the
// real 2×2 exchange of the Z pair with the affine recovery into Z(0), and
// |kshift| unit shifts of pool a. Options: per-atom b1 (half-angle trig per
// atom and TR), any nonzero kshift, any K.
//
// What bounds it on the H100: arithmetic. Per atom, order and TR pool a's
// mix, the saturation and the relaxation-exchange are ~65 multiplies and
// adds without FMA contraction: ~8e10 operations at 65,536 atoms × 400 TRs ×
// K 48, ~1.2 ms at the card's float32 peak. Device memory sees the
// per-atom rows once, the echoes (210 MB there) and the checkpoints; over
// a variable-TR train also the planes pkt once (734 MB there).
//
// Design. One thread per atom walks the whole train, as xspgr_fwd does; its
// 8·K state values (1.5 KB at K 48 in float32) live in shared memory,
// planes strided by the block's threads, pool a's F± planes ring buffers
// over the orders (the shift moves two offsets and writes two slots). At
// K 48 a 128-thread block holds 192 KB, one block an SM: 128 resident
// threads (kernels/epg.py `launch_cfg` with 8 planes); where even 32
// threads' states exceed a block's shared memory (K > 227 in float32, K >
// 113 in float64) the state lives in device memory (stride nA, coalesced).
// The 7 entries sit in registers (over a variable-TR train loaded at the
// start of every TR, coalesced over the atoms); per-TR coefficients are
// read by every thread at one address (a broadcast); one precise exp per
// atom and TR. Built without FMA contraction, in the plain version's order
// of operations (kernels/epgx.py `xmt_fwd_torch`, `xmt_v_fwd_torch`): the
// two agree bit for bit. Templated on the scalar type, on the checkpoints
// and on the variable-TR train (VARTR, as xspgr_fwd.cu's).
#include "xmt_common.cuh"

namespace mrphy {
namespace xmt {

// pk: (11, nA) at a fixed TR; over a variable-TR train (VARTR) the rows
// [M0a, M0b, b1, wscale] (4, nA), the entries of TR t at pkt + t·7·nA.
template <typename T, bool CHK, bool VARTR>
__global__ void xmt_fwd_kernel(const T* __restrict__ coef,
                               const T* __restrict__ pk,
                               const T* __restrict__ pkt, T* __restrict__ sig,
                               T* __restrict__ chk, T* __restrict__ gstate,
                               int64_t nA, int64_t nTR, int K, int kshift,
                               int flags, int64_t tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t a = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= nA) return;
  const bool has_b1 = flags & spgr::kB1;
  const Planes<T> st =
      gstate ? Planes<T>{gstate + a, nA, K}
             : Planes<T>{reinterpret_cast<T*>(smem_raw) + threadIdx.x,
                         (int64_t)blockDim.x, K};
  Prop<T> e{};
  if constexpr (!VARTR) e = load_prop(pk, nA, a);
  const T* pm = VARTR ? pk : pk + 7 * nA;  // [M0a, M0b, b1, wscale]
  const T M0a = pm[a], M0b = pm[nA + a], b1 = pm[2 * nA + a],
          wsc = pm[3 * nA + a];
  for (int p = 0; p < kPlanes; ++p)
    for (int k = 0; k < K; ++k) st(p, k) = T(0);
  st(4, 0) = M0a;
  st(6, 0) = M0b;
  int op = 0, om = 0;  // the ring offsets of pool a's F+ and F−
  T* out = sig + a * nTR * 2;
  for (int64_t t = 0; t < nTR; ++t) {
    if (CHK && t % tc == 0) {
      // the chunk's start state, orders in logical order
      T* c = chk + (t / tc) * kPlanes * K * nA + a;
      int ip = op, im = om;
      for (int k = 0; k < K; ++k) {
        c[(0 * (int64_t)K + k) * nA] = st(0, ip);
        c[(1 * (int64_t)K + k) * nA] = st(1, ip);
        c[(2 * (int64_t)K + k) * nA] = st(2, im);
        c[(3 * (int64_t)K + k) * nA] = st(3, im);
        for (int p = 4; p < kPlanes; ++p)
          c[((int64_t)p * K + k) * nA] = st(p, k);
        ip = spgr::wrap_inc(ip, K);
        im = spgr::wrap_inc(im, K);
      }
    }
    if constexpr (VARTR) e = load_prop(pkt + t * 7 * nA, nA, a);
    const Trig<T> g = spgr::trig(coef, nTR, t, b1, has_b1);
    const T sat = saturation(coef, nTR, t, wsc);
    int ip = op, im = om;
    for (int k = 0; k < K; ++k) {
      const T x[8] = {st(0, ip), st(1, ip), st(2, im), st(3, im),
                      st(4, k),  st(5, k),  st(6, k),  st(7, k)};
      T n[8];
      mt_mix(g, sat, x, n);
      if (k == 0) {
        out[2 * t] = g.c1 * n[0] + g.s1 * n[1];
        out[2 * t + 1] = g.c1 * n[1] - g.s1 * n[0];
      }
      mt_relax(e, k, n);
      st(0, ip) = n[0];
      st(1, ip) = n[1];
      st(2, im) = n[2];
      st(3, im) = n[3];
      for (int p = 4; p < kPlanes; ++p) st(p, k) = n[p];
      ip = spgr::wrap_inc(ip, K);
      im = spgr::wrap_inc(im, K);
    }
    const int ns = kshift > 0 ? kshift : -kshift;
    for (int u = 0; u < ns; ++u) spgr::ring_shift(st, op, om, kshift > 0);
  }
}

template <typename T, bool CHK, bool VARTR>
int launch_xmt_fwd(const T* coef, const T* pk, const T* pkt, T* sig, T* chk,
                   T* gstate, int64_t nA, int64_t nTR, int64_t K,
                   int64_t kshift, int64_t flags, int64_t tc, int64_t threads,
                   void* stream) {
  if (nA <= 0 || nTR <= 0 || K <= 0 || kshift == 0 || tc <= 0 ||
      nTR % tc != 0 || !spgr::valid_threads((int)threads) ||
      (CHK && chk == nullptr) || (VARTR && pkt == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      gstate ? 0 : (size_t)threads * kPlanes * (size_t)K * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        xmt_fwd_kernel<T, CHK, VARTR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + threads - 1) / threads);
  xmt_fwd_kernel<T, CHK, VARTR><<<grid, (unsigned)threads, smem,
                                  (cudaStream_t)stream>>>(
      coef, pk, pkt, sig, chk, gstate, nA, nTR, (int)K, (int)kshift,
      (int)flags, tc);
  return (int)cudaGetLastError();
}

}  // namespace xmt
}  // namespace mrphy

// Inputs (coef (10, nTR), pk (11, nA)), the echoes sig (nA, nTR, 2), the
// checkpoints chk (nTR / tc, 8, K, nA) (the _chk entries only), the state
// in device memory gstate (8, K, nA) or NULL to keep it in shared memory;
// sizes, kshift, flags (1 b1), tc, threads per block. Returns the
// cudaError_t of the launch (0 = success).
#define MRPHY_XMT_FWD_ENTRY(NAME, T, CHK)                                    \
  extern "C" int NAME(const void* coef, const void* pk, void* sig,          \
                      void* chk, void* gstate, int64_t nA, int64_t nTR,     \
                      int64_t K, int64_t kshift, int64_t flags, int64_t tc, \
                      int64_t threads, void* stream) {                       \
    return mrphy::xmt::launch_xmt_fwd<T, CHK, false>(                        \
        (const T*)coef, (const T*)pk, nullptr, (T*)sig, (T*)chk, (T*)gstate, \
        nA, nTR, K, kshift, flags, tc, threads, stream);                     \
  }

MRPHY_XMT_FWD_ENTRY(mrphy_xmt_fwd_f32, float, false)
MRPHY_XMT_FWD_ENTRY(mrphy_xmt_fwd_f64, double, false)
MRPHY_XMT_FWD_ENTRY(mrphy_xmt_fwd_chk_f32, float, true)
MRPHY_XMT_FWD_ENTRY(mrphy_xmt_fwd_chk_f64, double, true)

// The variable-TR instances: pk (4, nA) = [M0a, M0b, b1, wscale] and the
// per-TR planes pkt (nTR, 7, nA); the rest as above.
#define MRPHY_XMT_V_FWD_ENTRY(NAME, T, CHK)                                  \
  extern "C" int NAME(const void* coef, const void* pk, const void* pkt,    \
                      void* sig, void* chk, void* gstate, int64_t nA,       \
                      int64_t nTR, int64_t K, int64_t kshift, int64_t flags, \
                      int64_t tc, int64_t threads, void* stream) {           \
    return mrphy::xmt::launch_xmt_fwd<T, CHK, true>(                         \
        (const T*)coef, (const T*)pk, (const T*)pkt, (T*)sig, (T*)chk,       \
        (T*)gstate, nA, nTR, K, kshift, flags, tc, threads, stream);         \
  }

MRPHY_XMT_V_FWD_ENTRY(mrphy_xmt_v_fwd_f32, float, false)
MRPHY_XMT_V_FWD_ENTRY(mrphy_xmt_v_fwd_f64, double, false)
MRPHY_XMT_V_FWD_ENTRY(mrphy_xmt_v_fwd_chk_f32, float, true)
MRPHY_XMT_V_FWD_ENTRY(mrphy_xmt_v_fwd_chk_f64, double, true)
