// xspgr_bwd: the two-phase chunk adjoint of the two-pool EPG-X
// gradient-spoiled train on Hopper (sm_90a), at a fixed TR or over a
// variable-TR train.
//
// Replaces two TPU kernels of mrphy_tpu/ops/epg_pallas.py:
// `_xspgr_bwd_kernel` (launched by `_xspgr_core_bwd`), as the entry points
// mrphy_xspgr_bwd_*, and its variable-TR counterpart `_xv_bwd_kernel`
// (launched by `_xspgr_core_v_bwd`), as mrphy_xspgr_v_bwd_*. Chunks of tc
// TRs are visited newest first. Phase 1 re-runs the forward from the
// chunk's start state (chk, written by xspgr_fwd_chk or xspgr_v_fwd_chk)
// and stores every pre-RF state; phase 2 walks them backwards, per TR: the
// shift's transpose on both pools, the exchange-relaxation transpose
// (conj(E)ᵀ on F+, Eᵀ on F−, Zᵀ on Z) with the 14 propagator entries'
// contractions, the echo's cotangent into both pools' F+(0), the RF mix's
// coefficient terms summed over the pools, and the mix's transpose on both
// pools. Outputs at a fixed TR: dpar (17, nA) = [dE00r, dE00i, dE01r,
// dE01i, dE10r, dE10i, dE11r, dE11i, dZ00, dZ01, dZ10, dZ11, dra, drb,
// dM0a, dM0b, db1] (dM0a and dM0b the final cotangents of Za(0) and
// Zb(0)). Over a variable-TR train the entries differ per step, so their
// 14 contractions are written per step, dpkt (nTR, 14, nA), and dpar (3,
// nA) = [dM0a, dM0b, db1] (the initial Z(0)'s; the recovery's share of M0a
// and M0b comes back through dpkt's ra and rb rows). Both: dcf (ceil(nA/32),
// nTR, 9), each warp's per-TR coefficient rows summed over its atoms,
// which the wrapper sums over warps in a fixed order (no atomics).
//
// What bounds it on the H100: arithmetic and device memory. Phase 1 writes
// and phase 2 reads every pre-RF state, 12·K values per atom and TR (121
// GB at 65,536 atoms × 400 TRs × K 48 in float32, ~36 ms at the card's
// rate), beside ~4× the forward's arithmetic. Over a variable-TR train
// both phases also read the step's 14 entries and phase 2 writes its 14
// contractions (1.47 GB each way at 65,536 atoms × 400 TRs in float32).
//
// Design. One thread per atom, as xspgr_fwd. Phase 1 runs from chk into a
// device-memory scratch (tc − 1, 12, K, nA), orders in logical order, the
// shift written as an index offset (F+(k) → F+(k + s), F−(k) → F−(k − s),
// the k = 0 crossing conjugated into F+(s − k)), as spgr_bwd does for one
// pool. The adjoint state h (12·K values) lives in shared memory as ring
// buffers over the orders, as the forward's state does (in device memory
// where the forward's would), so the shift's transpose is two offsets and
// three slots a pool. At a fixed TR the 15 per-atom accumulators (14
// entries and b1) sit in registers; over a variable-TR train only b1's
// does, and the step's 14 entry sums are stored as they are formed. Every
// sum over the orders is taken one order at a time in the plain version's
// order (kernels/epgx.py `xspgr_bwd_torch`, `xspgr_v_bwd_torch`), so
// per-atom results agree bit for bit (built without FMA contraction). The
// per-TR rows are reduced over a warp's atoms by shuffles; lanes past nA
// add zeros. No fallback: every instance the forward with checkpoints
// takes, this kernel takes, with the chunk length the wrapper chose for
// the scratch (kernels/epg.py `pick_tc` with 12 planes).
#include "epgx_common.cuh"

namespace mrphy {
namespace epgx {

using spgr::Trig;

// One pool's relaxed order k (n) written into dst shifted by s orders: up
// (P = F+, M = F−) F+(k) → F+(k + s), F−(k) → F−(k − s), and for 1 ≤ k ≤ s
// F−(k) → conj into F+(s − k); the mirror otherwise.
template <typename T>
__device__ __forceinline__ void store_shifted(T* __restrict__ dst,
                                              int64_t nA, int K, int s,
                                              int P, int M, const T (&n)[6],
                                              int k) {
  auto at = [&](int p, int kk) -> int64_t {
    return ((int64_t)p * K + kk) * nA;
  };
  dst[at(4, k)] = n[4];
  dst[at(5, k)] = n[5];
  if (k + s < K) {
    dst[at(P, k + s)] = n[P];
    dst[at(P + 1, k + s)] = n[P + 1];
  }
  if (k >= s) {
    dst[at(M, k - s)] = n[M];
    dst[at(M + 1, k - s)] = n[M + 1];
  }
  if (k >= 1 && k <= s && s - k < K) {  // crossing k = 0: conjugated
    dst[at(P, s - k)] = n[M];
    dst[at(P + 1, s - k)] = -n[M + 1];
  }
}

// The orders of one pool that the shift brings in from beyond K − 1.
template <typename T>
__device__ __forceinline__ void zero_shifted_in(T* __restrict__ dst,
                                                int64_t nA, int K, int s,
                                                int P, int M) {
  auto at = [&](int p, int kk) -> int64_t {
    return ((int64_t)p * K + kk) * nA;
  };
  for (int k = K - s > 0 ? K - s : 0; k < K; ++k) {
    dst[at(M, k)] = T(0);
    dst[at(M + 1, k)] = T(0);
  }
  for (int k = 0; k < s - K + 1 && k < K; ++k) {
    dst[at(P, k)] = T(0);
    dst[at(P + 1, k)] = T(0);
  }
}

// One TR of the forward from the pre-RF state src into the next one, dst,
// both in logical order (element (p, k) at [(p·K + k)·nA]).
template <typename T>
__device__ void xfwd_direct(const T* __restrict__ src, T* __restrict__ dst,
                            const Trig<T>& g, const Prop<T>& e, int64_t nA,
                            int K, int kshift) {
  const int s = kshift > 0 ? kshift : -kshift;
  const int P = kshift > 0 ? 0 : 2, M = kshift > 0 ? 2 : 0;
  const int64_t pool = (int64_t)6 * K * nA;
  for (int k = 0; k < K; ++k) {
    T xa[6], xb[6];
    for (int p = 0; p < 6; ++p) {
      xa[p] = src[((int64_t)p * K + k) * nA];
      xb[p] = src[pool + ((int64_t)p * K + k) * nA];
    }
    T na[6], nb[6];
    spgr::mix(g, xa, na);
    spgr::mix(g, xb, nb);
    xrelax(e, k, na, nb);
    store_shifted(dst, nA, K, s, P, M, na, k);
    store_shifted(dst + pool, nA, K, s, P, M, nb, k);
  }
  zero_shifted_in(dst, nA, K, s, P, M);
  zero_shifted_in(dst + pool, nA, K, s, P, M);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// par: (17, nA) at a fixed TR; over a variable-TR train (VARTR) the rows
// [M0a, M0b, b1] (3, nA), the entries of step t at pkt + t·14·nA and their
// contractions at dpkt + t·14·nA.
template <typename T, bool VARTR>
__global__ void xspgr_bwd_kernel(const T* __restrict__ coef,
                                 const T* __restrict__ par,
                                 const T* __restrict__ pkt,
                                 const T* __restrict__ chk,
                                 const T* __restrict__ gy,
                                 T* __restrict__ scratch,
                                 T* __restrict__ hstate,
                                 T* __restrict__ dpar, T* __restrict__ dcf,
                                 T* __restrict__ dpkt, int64_t nA,
                                 int64_t nTR, int K, int kshift, int flags,
                                 int64_t tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t a = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // threads past nA take part in the warps' sums with zeros
  const bool active = a < nA;
  const int64_t warp = a >> 5;
  const bool writer = (threadIdx.x & 31) == 0 && warp * 32 < nA;
  const bool has_b1 = flags & spgr::kB1;
  const Planes<T> h =
      hstate ? Planes<T>{hstate + a, nA, K}
             : Planes<T>{reinterpret_cast<T*>(smem_raw) + threadIdx.x,
                         (int64_t)blockDim.x, K};
  const Planes<T> hb = pool_b(h);
  Prop<T> e{};
  T b1 = 0;
  if (active) {
    if constexpr (!VARTR) e = load_prop(par, nA, a);
    b1 = par[(VARTR ? 2 : 16) * nA + a];
    for (int p = 0; p < kPlanes; ++p)
      for (int k = 0; k < K; ++k) h(p, k) = T(0);
  }
  T acc[14];
  for (int i = 0; i < 14; ++i) acc[i] = T(0);
  T ab1 = 0;
  int op = 0, om = 0;  // the adjoint's ring offsets of F+ and F−
  const int64_t plane = (int64_t)kPlanes * K * nA;
  const int64_t pool = (int64_t)6 * K * nA;
  const int64_t ntc = nTR / tc;
  for (int64_t j = ntc - 1; j >= 0; --j) {
    const T* c0 = chk + j * plane;
    // phase 1: the forward from the chunk's start state, every state
    if (active)
      for (int64_t tl = 0; tl + 1 < tc; ++tl) {
        const int64_t t = j * tc + tl;
        const Trig<T> g = spgr::trig(coef, nTR, t, b1, has_b1);
        if constexpr (VARTR) e = load_prop(pkt + t * 14 * nA, nA, a);
        xfwd_direct((tl == 0 ? c0 : scratch + (tl - 1) * plane) + a,
                    scratch + tl * plane + a, g, e, nA, K, kshift);
      }
    // phase 2: the cotangent, backwards through the stored states
    for (int64_t tl = tc - 1; tl >= 0; --tl) {
      const int64_t t = j * tc + tl;
      T rows[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
      if (active) {
        const T* x0 = (tl == 0 ? c0 : scratch + (tl - 1) * plane) + a;
        const Trig<T> g = spgr::trig(coef, nTR, t, b1, has_b1);
        if constexpr (VARTR) e = load_prop(pkt + t * 14 * nA, nA, a);
        ring_shift2_T(h, op, om, kshift);
        // the sums over the orders, one order at a time
        T kE[12], km[8];
        for (int i = 0; i < 12; ++i) kE[i] = T(0);
        for (int i = 0; i < 8; ++i) km[i] = T(0);
        T d_ra = 0, d_rb = 0, d_c1e = 0, d_s1e = 0;
        int ip = op, im = om;
        for (int k = 0; k < K; ++k) {
          T xa[6], xb[6];
          for (int p = 0; p < 6; ++p) {
            xa[p] = x0[((int64_t)p * K + k) * nA];
            xb[p] = x0[pool + ((int64_t)p * K + k) * nA];
          }
          T s1a[6], s1b[6];
          spgr::mix(g, xa, s1a);
          spgr::mix(g, xb, s1b);
          T ha[6] = {h(0, ip), h(1, ip), h(2, im), h(3, im), h(4, k), h(5, k)};
          T hv[6] = {hb(0, ip), hb(1, ip), hb(2, im),
                     hb(3, im), hb(4, k),  hb(5, k)};
          // the exchange-relaxation's transpose
          xrelax_T(e, k, s1a, s1b, ha, hv, kE, d_ra, d_rb);
          if (k == 0) {
            // the echo's cotangent (the echo reads the mixed state)
            const T gyr = gy[(a * nTR + t) * 2],
                    gyi = gy[(a * nTR + t) * 2 + 1];
            const T fr = s1a[0] + s1b[0], fi = s1a[1] + s1b[1];
            const T er = g.c1 * gyr - g.s1 * gyi;
            const T ei = g.s1 * gyr + g.c1 * gyi;
            ha[0] = ha[0] + er;
            ha[1] = ha[1] + ei;
            hv[0] = hv[0] + er;
            hv[1] = hv[1] + ei;
            d_c1e = gyr * fr + gyi * fi;
            d_s1e = gyr * fi - gyi * fr;
          }
          // the RF mix's coefficients, against the pre-RF state
          T ta[8], tb[8];
          mix_terms(ha, xa, ta);
          mix_terms(hv, xb, tb);
          for (int i = 0; i < 8; ++i) km[i] += ta[i] + tb[i];
          T oa[6], ob[6];
          spgr::mix_T(g, ha, oa);
          spgr::mix_T(g, hv, ob);
          h(0, ip) = oa[0];
          h(1, ip) = oa[1];
          h(2, im) = oa[2];
          h(3, im) = oa[3];
          h(4, k) = oa[4];
          h(5, k) = oa[5];
          hb(0, ip) = ob[0];
          hb(1, ip) = ob[1];
          hb(2, im) = ob[2];
          hb(3, im) = ob[3];
          hb(4, k) = ob[4];
          hb(5, k) = ob[5];
          ip = spgr::wrap_inc(ip, K);
          im = spgr::wrap_inc(im, K);
        }
        if constexpr (VARTR) {
          // this step's entry gradients, as they are
          T* dp = dpkt + t * 14 * nA + a;
          for (int i = 0; i < 12; ++i) dp[i * nA] = kE[i];
          dp[12 * nA] = d_ra;
          dp[13 * nA] = d_rb;
        } else {
          for (int i = 0; i < 12; ++i) acc[i] = acc[i] + kE[i];
          acc[12] = acc[12] + d_ra;
          acc[13] = acc[13] + d_rb;
        }
        // km: [ca2, sc2, ss2, ss, sc, hs, hc, ca]
        const T d_sa2 = g.c2 * km[1] + g.s2 * km[2];
        const T d_sa = g.s1 * (km[3] + T(0.5) * km[5]) +
                       g.c1 * (km[4] + T(0.5) * km[6]);
        rows[4] = g.sa * (km[4] + T(0.5) * km[6]) + d_c1e;
        rows[5] = g.sa * (km[3] + T(0.5) * km[5]) + d_s1e;
        rows[6] = g.sa2 * km[1];
        rows[7] = g.sa2 * km[2];
        if (has_b1) {
          // α = flip·b1 through the half-angle trig
          const T d_al = ((T(0.5) * g.sa) * (d_sa2 - km[0]) + g.ca * d_sa) -
                         g.sa * km[7];
          ab1 = ab1 + d_al * coef[8 * nTR + t];
          rows[8] = d_al * b1;
        } else {
          rows[0] = km[0];
          rows[1] = d_sa2;
          rows[2] = d_sa;
          rows[3] = km[7];
        }
      }
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        const T v = warp_sum(rows[c]);
        if (writer) dcf[(warp * nTR + t) * 9 + c] = v;
      }
    }
  }
  if (active) {
    T* dm = dpar;  // [dM0a, dM0b, db1]
    if constexpr (!VARTR) {
      for (int i = 0; i < 14; ++i) dpar[i * nA + a] = acc[i];
      dm += 14 * nA;
    }
    // the initial state: M0a on Za(0)'s real part, M0b on Zb(0)'s
    dm[a] = h(4, 0);
    dm[nA + a] = hb(4, 0);
    dm[2 * nA + a] = ab1;
  }
}

template <typename T, bool VARTR>
int launch_xspgr_bwd(const T* coef, const T* par, const T* pkt, const T* chk,
                     const T* gy, T* scratch, T* hstate, T* dpar, T* dcf,
                     T* dpkt, int64_t nA, int64_t nTR, int64_t K,
                     int64_t kshift, int64_t flags, int64_t tc,
                     int64_t threads, void* stream) {
  if (nA <= 0 || nTR <= 0 || K <= 0 || kshift == 0 || tc <= 0 ||
      nTR % tc != 0 || !spgr::valid_threads((int)threads) ||
      (VARTR && (pkt == nullptr || dpkt == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      hstate ? 0 : (size_t)threads * kPlanes * (size_t)K * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        xspgr_bwd_kernel<T, VARTR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + threads - 1) / threads);
  xspgr_bwd_kernel<T, VARTR><<<grid, (unsigned)threads, smem,
                               (cudaStream_t)stream>>>(
      coef, par, pkt, chk, gy, scratch, hstate, dpar, dcf, dpkt, nA, nTR,
      (int)K, (int)kshift, (int)flags, tc);
  return (int)cudaGetLastError();
}

}  // namespace epgx
}  // namespace mrphy

// Inputs (coef (9, nTR), par (17, nA), chk (nTR / tc, 12, K, nA), g (nA,
// nTR, 2)), the scratch (max(tc − 1, 1), 12, K, nA), the adjoint state in
// device memory hstate (12, K, nA) or NULL to keep it in shared memory,
// the outputs dpar (17, nA) and dcf (ceil(nA/32), nTR, 9); sizes, kshift,
// flags (1 b1), tc, threads per block. Returns the cudaError_t of the
// launch (0 = success).
#define MRPHY_XSPGR_BWD_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* coef, const void* par, const void* chk,   \
                      const void* g, void* scratch, void* hstate,           \
                      void* dpar, void* dcf, int64_t nA, int64_t nTR,       \
                      int64_t K, int64_t kshift, int64_t flags, int64_t tc, \
                      int64_t threads, void* stream) {                       \
    return mrphy::epgx::launch_xspgr_bwd<T, false>(                          \
        (const T*)coef, (const T*)par, nullptr, (const T*)chk, (const T*)g,  \
        (T*)scratch, (T*)hstate, (T*)dpar, (T*)dcf, nullptr, nA, nTR, K,     \
        kshift, flags, tc, threads, stream);                                 \
  }

MRPHY_XSPGR_BWD_ENTRY(mrphy_xspgr_bwd_f32, float)
MRPHY_XSPGR_BWD_ENTRY(mrphy_xspgr_bwd_f64, double)

// The variable-TR train: inputs coef (9, nTR), pk (3, nA) = [M0a, M0b, b1],
// the planes pkt (nTR, 14, nA), chk and g as above; the outputs dpar (3,
// nA) = [dM0a, dM0b, db1], dcf as above and dpkt (nTR, 14, nA).
#define MRPHY_XSPGR_V_BWD_ENTRY(NAME, T)                                     \
  extern "C" int NAME(const void* coef, const void* pk, const void* pkt,    \
                      const void* chk, const void* g, void* scratch,        \
                      void* hstate, void* dpar, void* dcf, void* dpkt,      \
                      int64_t nA, int64_t nTR, int64_t K, int64_t kshift,   \
                      int64_t flags, int64_t tc, int64_t threads,           \
                      void* stream) {                                        \
    return mrphy::epgx::launch_xspgr_bwd<T, true>(                           \
        (const T*)coef, (const T*)pk, (const T*)pkt, (const T*)chk,          \
        (const T*)g, (T*)scratch, (T*)hstate, (T*)dpar, (T*)dcf, (T*)dpkt,   \
        nA, nTR, K, kshift, flags, tc, threads, stream);                     \
  }

MRPHY_XSPGR_V_BWD_ENTRY(mrphy_xspgr_v_bwd_f32, float)
MRPHY_XSPGR_V_BWD_ENTRY(mrphy_xspgr_v_bwd_f64, double)
