// xmt_bwd: the two-phase chunk adjoint of the EPG-X(MT) gradient-spoiled
// train on Hopper (sm_90a) at a fixed TR and over a variable-TR train.
//
// Replaces two TPU kernels of mrphy_tpu/ops/epg_pallas.py: `_mt_bwd_kernel`
// (launched by `_mt_core_bwd`), as the entry points mrphy_xmt_bwd_*, and
// its variable-TR form `_mtv_bwd_kernel` (launched by `_mt_core_v_bwd`), as
// mrphy_xmt_v_bwd_*, which reads TR t's 7 entries from the per-TR planes
// pkt (nTR, 7, nA) and writes their 7 contractions per atom and TR into
// dpkt (nTR, 7, nA) instead of summing them over the train. Chunks
// of tc TRs are visited newest first. Phase 1 re-runs the forward from the
// chunk's start state (chk, written by xmt_fwd_chk) and stores every pre-RF
// state; phase 2 walks them backwards, per TR: the shift's transpose (pool
// a's F), the exchange-relaxation transpose at the mixed state (E2a on F,
// Zᵀ on the Z pair) with its 7 row contractions, the echo's cotangent into
// pool a's F+(0), the saturation's transpose (Zb1 = sat·Zb: ∂wt_t =
// −wscale·sat·Σ_k h·Zb, and ∂wscale adds −wt_t·sat·Σ_k h·Zb), pool a's RF
// mix coefficient terms and transpose. Outputs: dpk (11, nA) = [dZ00, dZ01,
// dZ10, dZ11, dra, drb, dE2a, dM0a, dM0b, db1, dwscale] (dM0a and dM0b the
// final cotangents of Za(0) and Zb(0)); over a variable-TR train dpar (4,
// nA) = [dM0a, dM0b, db1, dwscale] and dpkt, M0a and M0b reaching the
// echoes through the recovery rows of dpkt as well (autograd of the planes
// adds both); both: dcf (ceil(nA/32), nTR, 10), each
// warp's per-TR coefficient rows (the per-TR ∂wt the last) summed over its
// atoms, which the wrapper sums over warps in a fixed order (no atomics).
// With b1 the angle's chain to d/dα happens here, as in the TPU kernel:
// rows 0-3 stay zero, row 8 carries d/dα·b1 and db1 gathers d/dα·α_t.
//
// What bounds it on the H100: arithmetic and device memory. Phase 1 writes
// and phase 2 reads every pre-RF state, 8·K values per atom and TR (~80 GB
// at 65,536 atoms × 400 TRs × K 48 in float32, ~24 ms at the card's rate),
// beside ~4× the forward's arithmetic; over a variable-TR train pkt is read
// twice (phase 1 and phase 2) and dpkt written once, 734 MB each there.
//
// Design. One thread per atom, as xmt_fwd. Phase 1 runs from chk into a
// device-memory scratch (tc − 1, 8, K, nA), orders in logical order, pool
// a's shift written as an index offset (epgx_common.cuh `store_shifted`),
// as xspgr_bwd does for each of its pools. The adjoint state h (8·K
// values) lives in shared memory, pool a's F planes as ring buffers over
// the orders, as the forward's state does (in device memory where the
// forward's would). The 9 per-atom accumulators (7 entries, b1 and wscale)
// sit in registers (over a variable-TR train the 7 entries' sums of one TR
// go to dpkt, coalesced over the atoms). Every sum over the orders is taken
// one order at a time in the plain version's order (kernels/epgx.py
// `xmt_bwd_torch`, `xmt_v_bwd_torch`), so
// per-atom results agree bit for bit (built without FMA contraction); the
// per-TR rows are reduced over a warp's atoms by shuffles, lanes past nA
// adding zeros, in the order the plain version's `_warp_sums` takes. No
// fallback: every instance the forward with checkpoints takes, this kernel
// takes, with the chunk length the wrapper chose for the scratch
// (kernels/epg.py `pick_tc` with 8 planes).
#include "xmt_common.cuh"

namespace mrphy {
namespace xmt {

// One TR of the forward from the pre-RF state src into the next one, dst,
// both in logical order (element (p, k) at [(p·K + k)·nA]).
template <typename T>
__device__ void xmt_fwd_direct(const T* __restrict__ src,
                               T* __restrict__ dst, const Trig<T>& g, T sat,
                               const Prop<T>& e, int64_t nA, int K,
                               int kshift) {
  const int s = kshift > 0 ? kshift : -kshift;
  const int P = kshift > 0 ? 0 : 2, M = kshift > 0 ? 2 : 0;
  for (int k = 0; k < K; ++k) {
    T x[8];
    for (int p = 0; p < kPlanes; ++p) x[p] = src[((int64_t)p * K + k) * nA];
    T n[8];
    mt_mix(g, sat, x, n);
    mt_relax(e, k, n);
    const T na[6] = {n[0], n[1], n[2], n[3], n[4], n[5]};
    epgx::store_shifted(dst, nA, K, s, P, M, na, k);
    dst[((int64_t)6 * K + k) * nA] = n[6];
    dst[((int64_t)7 * K + k) * nA] = n[7];
  }
  epgx::zero_shifted_in(dst, nA, K, s, P, M);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// pk: (11, nA) at a fixed TR; over a variable-TR train (VARTR) the rows
// [M0a, M0b, b1, wscale] (4, nA), the entries of TR t at pkt + t·7·nA and
// their contractions at dpkt + t·7·nA; dpk likewise (11 or 4 rows).
template <typename T, bool VARTR>
__global__ void xmt_bwd_kernel(const T* __restrict__ coef,
                               const T* __restrict__ pk,
                               const T* __restrict__ pkt,
                               const T* __restrict__ chk,
                               const T* __restrict__ gy,
                               T* __restrict__ scratch,
                               T* __restrict__ hstate, T* __restrict__ dpk,
                               T* __restrict__ dcf, T* __restrict__ dpkt,
                               int64_t nA, int64_t nTR, int K, int kshift,
                               int flags, int64_t tc) {
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
  Prop<T> e{};
  T b1 = 0, wsc = 0;
  if (active) {
    if constexpr (!VARTR) e = load_prop(pk, nA, a);
    const T* pm = VARTR ? pk : pk + 7 * nA;  // [M0a, M0b, b1, wscale]
    b1 = pm[2 * nA + a];
    wsc = pm[3 * nA + a];
    for (int p = 0; p < kPlanes; ++p)
      for (int k = 0; k < K; ++k) h(p, k) = T(0);
  }
  T acc[7];
  for (int i = 0; i < 7; ++i) acc[i] = T(0);
  T ab1 = 0, awsc = 0;
  int op = 0, om = 0;  // the adjoint's ring offsets of pool a's F+ and F−
  const int64_t plane = (int64_t)kPlanes * K * nA;
  const int64_t ntc = nTR / tc;
  const int ns = kshift > 0 ? kshift : -kshift;
  for (int64_t j = ntc - 1; j >= 0; --j) {
    const T* c0 = chk + j * plane;
    // phase 1: the forward from the chunk's start state, every state
    if (active)
      for (int64_t tl = 0; tl + 1 < tc; ++tl) {
        const int64_t t = j * tc + tl;
        if constexpr (VARTR) e = load_prop(pkt + t * 7 * nA, nA, a);
        const Trig<T> g = spgr::trig(coef, nTR, t, b1, has_b1);
        const T sat = saturation(coef, nTR, t, wsc);
        xmt_fwd_direct((tl == 0 ? c0 : scratch + (tl - 1) * plane) + a,
                       scratch + tl * plane + a, g, sat, e, nA, K, kshift);
      }
    // phase 2: the cotangent, backwards through the stored states
    for (int64_t tl = tc - 1; tl >= 0; --tl) {
      const int64_t t = j * tc + tl;
      T rows[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
      if (active) {
        const T* x0 = (tl == 0 ? c0 : scratch + (tl - 1) * plane) + a;
        if constexpr (VARTR) e = load_prop(pkt + t * 7 * nA, nA, a);
        const Trig<T> g = spgr::trig(coef, nTR, t, b1, has_b1);
        const T wtt = coef[9 * nTR + t];
        const T sat = saturation(coef, nTR, t, wsc);
        for (int u = 0; u < ns; ++u) spgr::ring_shift_T(h, op, om, kshift > 0);
        // the sums over the orders, one order at a time
        T kE[5] = {0, 0, 0, 0, 0}, km[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        T ksat = 0, d_ra = 0, d_rb = 0, d_c1e = 0, d_s1e = 0;
        int ip = op, im = om;
        for (int k = 0; k < K; ++k) {
          T x[8];
          for (int p = 0; p < kPlanes; ++p)
            x[p] = x0[((int64_t)p * K + k) * nA];
          T s1[8];
          mt_mix(g, sat, x, s1);
          T hv[8] = {h(0, ip), h(1, ip), h(2, im), h(3, im),
                     h(4, k),  h(5, k),  h(6, k),  h(7, k)};
          // the exchange-relaxation's transpose at the mixed state
          mt_relax_T(e, k, s1, hv, kE, d_ra, d_rb);
          if (k == 0) {
            // the echo's cotangent (the echo reads the mixed state)
            const T gyr = gy[(a * nTR + t) * 2],
                    gyi = gy[(a * nTR + t) * 2 + 1];
            hv[0] = hv[0] + (g.c1 * gyr - g.s1 * gyi);
            hv[1] = hv[1] + (g.s1 * gyr + g.c1 * gyi);
            d_c1e = gyr * s1[0] + gyi * s1[1];
            d_s1e = gyr * s1[1] - gyi * s1[0];
          }
          // the saturation's term, then pool a's mix coefficients against
          // the pre-RF state
          ksat += hv[6] * x[6] + hv[7] * x[7];
          const T ha[6] = {hv[0], hv[1], hv[2], hv[3], hv[4], hv[5]};
          const T xa[6] = {x[0], x[1], x[2], x[3], x[4], x[5]};
          T ta[8];
          epgx::mix_terms(ha, xa, ta);
          for (int i = 0; i < 8; ++i) km[i] += ta[i];
          T o[6];
          spgr::mix_T(g, ha, o);
          h(0, ip) = o[0];
          h(1, ip) = o[1];
          h(2, im) = o[2];
          h(3, im) = o[3];
          h(4, k) = o[4];
          h(5, k) = o[5];
          h(6, k) = sat * hv[6];
          h(7, k) = sat * hv[7];
          ip = spgr::wrap_inc(ip, K);
          im = spgr::wrap_inc(im, K);
        }
        if constexpr (VARTR) {
          // this TR's entry gradients, as they are
          T* dp = dpkt + t * 7 * nA + a;
          for (int i = 0; i < 4; ++i) dp[i * nA] = kE[i];
          dp[4 * nA] = d_ra;
          dp[5 * nA] = d_rb;
          dp[6 * nA] = kE[4];
        } else {
          for (int i = 0; i < 4; ++i) acc[i] = acc[i] + kE[i];
          acc[4] = acc[4] + d_ra;
          acc[5] = acc[5] + d_rb;
          acc[6] = acc[6] + kE[4];
        }
        awsc = awsc + (-wtt * sat) * ksat;
        // km: [ca2, sc2, ss2, ss, sc, hs, hc, ca]
        const T d_sa2 = g.c2 * km[1] + g.s2 * km[2];
        const T d_sa = g.s1 * (km[3] + T(0.5) * km[5]) +
                       g.c1 * (km[4] + T(0.5) * km[6]);
        rows[4] = g.sa * (km[4] + T(0.5) * km[6]) + d_c1e;
        rows[5] = g.sa * (km[3] + T(0.5) * km[5]) + d_s1e;
        rows[6] = g.sa2 * km[1];
        rows[7] = g.sa2 * km[2];
        rows[9] = (-wsc * sat) * ksat;
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
      for (int c = 0; c < 10; ++c) {
        const T v = warp_sum(rows[c]);
        if (writer) dcf[(warp * nTR + t) * 10 + c] = v;
      }
    }
  }
  if (active) {
    T* dm = dpk;  // [dM0a, dM0b, db1, dwscale]
    if constexpr (!VARTR) {
      for (int i = 0; i < 7; ++i) dpk[i * nA + a] = acc[i];
      dm += 7 * nA;
    }
    // the initial state: M0a on Za(0)'s real part, M0b on Zb(0)'s
    dm[a] = h(4, 0);
    dm[nA + a] = h(6, 0);
    dm[2 * nA + a] = ab1;
    dm[3 * nA + a] = awsc;
  }
}

template <typename T, bool VARTR>
int launch_xmt_bwd(const T* coef, const T* pk, const T* pkt, const T* chk,
                   const T* gy, T* scratch, T* hstate, T* dpk, T* dcf,
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
        xmt_bwd_kernel<T, VARTR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + threads - 1) / threads);
  xmt_bwd_kernel<T, VARTR><<<grid, (unsigned)threads, smem,
                              (cudaStream_t)stream>>>(
      coef, pk, pkt, chk, gy, scratch, hstate, dpk, dcf, dpkt, nA, nTR,
      (int)K, (int)kshift, (int)flags, tc);
  return (int)cudaGetLastError();
}

}  // namespace xmt
}  // namespace mrphy

// Inputs (coef (10, nTR), pk (11, nA), chk (nTR / tc, 8, K, nA), g (nA,
// nTR, 2)), the scratch (max(tc − 1, 1), 8, K, nA), the adjoint state in
// device memory hstate (8, K, nA) or NULL to keep it in shared memory, the
// outputs dpk (11, nA) and dcf (ceil(nA/32), nTR, 10); sizes, kshift, flags
// (1 b1), tc, threads per block. Returns the cudaError_t of the launch (0 =
// success).
#define MRPHY_XMT_BWD_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* coef, const void* pk, const void* chk,    \
                      const void* g, void* scratch, void* hstate, void* dpk, \
                      void* dcf, int64_t nA, int64_t nTR, int64_t K,        \
                      int64_t kshift, int64_t flags, int64_t tc,            \
                      int64_t threads, void* stream) {                       \
    return mrphy::xmt::launch_xmt_bwd<T, false>(                             \
        (const T*)coef, (const T*)pk, nullptr, (const T*)chk, (const T*)g,   \
        (T*)scratch, (T*)hstate, (T*)dpk, (T*)dcf, nullptr, nA, nTR, K,      \
        kshift, flags, tc, threads, stream);                                 \
  }

MRPHY_XMT_BWD_ENTRY(mrphy_xmt_bwd_f32, float)
MRPHY_XMT_BWD_ENTRY(mrphy_xmt_bwd_f64, double)

// The variable-TR instances: pk (4, nA) = [M0a, M0b, b1, wscale], the
// planes pkt (nTR, 7, nA), chk and g as above; the outputs dpk (4, nA) =
// [dM0a, dM0b, db1, dwscale], dcf as above and dpkt (nTR, 7, nA).
#define MRPHY_XMT_V_BWD_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* coef, const void* pk, const void* pkt,    \
                      const void* chk, const void* g, void* scratch,        \
                      void* hstate, void* dpk, void* dcf, void* dpkt,       \
                      int64_t nA, int64_t nTR, int64_t K, int64_t kshift,   \
                      int64_t flags, int64_t tc, int64_t threads,           \
                      void* stream) {                                        \
    return mrphy::xmt::launch_xmt_bwd<T, true>(                              \
        (const T*)coef, (const T*)pk, (const T*)pkt, (const T*)chk,          \
        (const T*)g, (T*)scratch, (T*)hstate, (T*)dpk, (T*)dcf, (T*)dpkt,    \
        nA, nTR, K, kshift, flags, tc, threads, stream);                     \
  }

MRPHY_XMT_V_BWD_ENTRY(mrphy_xmt_v_bwd_f32, float)
MRPHY_XMT_V_BWD_ENTRY(mrphy_xmt_v_bwd_f64, double)
