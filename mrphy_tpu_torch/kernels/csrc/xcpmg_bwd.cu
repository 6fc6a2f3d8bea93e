// xcpmg_bwd: the two-phase chunk adjoint of the two-pool EPG-X CPMG echo
// train on Hopper (sm_90a), at a fixed echo spacing or over an echo-spacing
// train.
//
// Replaces two TPU kernels of mrphy_tpu/ops/epg_pallas.py:
// `_xcpmg_bwd_kernel` (launched by `_xcpmg_core_bwd`), as the entry points
// mrphy_xcpmg_bwd_*, and its echo-spacing-train counterpart
// `_xcv_bwd_kernel` (launched by `_xcpmg_core_v_bwd`), as
// mrphy_xcpmg_v_bwd_*. Chunks of tc echoes are visited newest first.
// Phase 1 re-runs the forward from the chunk's start state (chk, written
// by xcpmg_fwd_chk or xcpmg_v_fwd_chk) and stores every pre-echo state;
// phase 2 walks them backwards, per echo: the echo's cotangent into both
// pools' F+(0), the shift's transpose, the exchange-relaxation's transpose
// at the mixed state (conj(E)ᵀ on F+, Eᵀ on F−, Zᵀ on Z, with the 14
// propagator entries' contractions), the refocusing mix's coefficient terms
// (both pools, order by order) and transpose, the shift's transpose, the
// exchange-relaxation's transpose at the stored pre-echo state. Outputs:
// dpar (19, nA) = [dE00r, dE00i, dE01r, dE01i, dE10r, dE10i, dE11r, dE11i,
// dZ00, dZ01, dZ10, dZ11, dra, drb] (both halves of every echo), then the
// initial state's [d cos φ_ex, d sin φ_ex, dM0a, dM0b] in closed form from
// the final cotangent at order 0, and db1; dcf (ceil(nA/32), nE, 5), each
// warp's per-echo coefficient rows summed over its atoms, which the wrapper
// sums over warps in a fixed order (no atomics). Under b1 the angle's
// gradient goes to db1 and to the flip row (rows 0-3 stay 0). Over an
// echo-spacing train the entries differ per echo, so each echo's 14
// contractions, its second half's and its first's added, are written per
// echo, dpkt (nE, 14, nA), and dpar (5, nA) = [d cos φ_ex, d sin φ_ex,
// dM0a, dM0b, db1] (the initial state's: the recovery's share of M0a and
// M0b comes back through dpkt's ra and rb rows).
//
// What bounds it on the H100: arithmetic and device memory. Phase 1 writes
// and phase 2 reads the pre-echo states, 12·K values per atom and echo (36
// GB at 262,144 atoms × 32 echoes × K 33 in float32, ~11 ms at the card's
// rate; the state after the first half is formed again from them), beside
// ~3× the forward's arithmetic. Over an echo-spacing train both phases
// also read each echo's 14 entries and phase 2 writes its 14 contractions
// (470 MB each way at 262,144 atoms × 32 echoes in float32).
//
// Design. One thread per atom, as xcpmg_fwd. Phase 1 runs from chk into a
// device-memory scratch (tc − 1, 12, K, nA), orders in logical order: each
// order of the state after the first half is read from its neighbours
// (`xhalf_at`), mixed and relaxed, and written with the second unit shift
// as an index offset. The adjoint state h (12·K values) lives in shared
// memory as ring buffers over the orders, as the forward's state does (in
// device memory where the forward's would), so each unit shift's transpose
// is two offsets and three slots a pool. Per echo two passes over the
// orders: the second half's and the mix's transposes together (the mix's
// input formed again by `xhalf_at`), then the first half's. The 15 per-atom
// accumulators (14 entries and b1) sit in registers; over a train the 14
// entries of the echo's second half wait there for its first half's. Every
// sum over the orders is taken one order at a time in the plain version's
// order (kernels/epgx.py `_xcpmg_bwd`), so per-atom results agree bit for
// bit (built without FMA contraction). The per-echo rows are reduced over a
// warp's atoms by shuffles, lanes past nA adding zeros, in the order the
// plain version sums them (`_warp_sums`). No fallback: every
// instance xcpmg_fwd_chk takes, this kernel takes, with the chunk length
// the wrapper chose for the scratch (kernels/epg.py `pick_tc` with 12
// planes).
#include "cpmg_common.cuh"
#include "epgx_common.cuh"

namespace mrphy {
namespace xcpmg {

using epgx::kPlanes;
using epgx::Prop;
using spgr::Planes;

// Order k of both pools of a logical state src (element (p, q) of pool a at
// [(p·K + q)·nA], pool b's planes 6-11) after one half echo: the
// exchange-relaxation, then the unit shift up, so F+(k) comes from F+(k −
// 1), F−(k) from F−(k + 1) (F−(K − 1) from beyond: 0), F+(0) = conj(the new
// F−(0)) and Z stays. The expressions are xrelax's.
template <typename T>
__device__ __forceinline__ void xhalf_at(const T* __restrict__ src,
                                         int64_t nA, int K, int k,
                                         const Prop<T>& e, T (&na)[6],
                                         T (&nb)[6]) {
  auto at = [&](int p, int q) -> T { return src[((int64_t)p * K + q) * nA]; };
  if (k >= 1) {
    const T Par = at(0, k - 1), Pai = at(1, k - 1), Pbr = at(6, k - 1),
            Pbi = at(7, k - 1);
    na[0] = (e.E00r * Par - e.E00i * Pai) + (e.E01r * Pbr - e.E01i * Pbi);
    na[1] = (e.E00r * Pai + e.E00i * Par) + (e.E01r * Pbi + e.E01i * Pbr);
    nb[0] = (e.E10r * Par - e.E10i * Pai) + (e.E11r * Pbr - e.E11i * Pbi);
    nb[1] = (e.E10r * Pai + e.E10i * Par) + (e.E11r * Pbi + e.E11i * Pbr);
  } else {
    const T Mar = at(2, 1), Mai = at(3, 1), Mbr = at(8, 1), Mbi = at(9, 1);
    na[0] = (e.E00r * Mar + e.E00i * Mai) + (e.E01r * Mbr + e.E01i * Mbi);
    na[1] = -((e.E00r * Mai - e.E00i * Mar) + (e.E01r * Mbi - e.E01i * Mbr));
    nb[0] = (e.E10r * Mar + e.E10i * Mai) + (e.E11r * Mbr + e.E11i * Mbi);
    nb[1] = -((e.E10r * Mai - e.E10i * Mar) + (e.E11r * Mbi - e.E11i * Mbr));
  }
  if (k + 1 < K) {
    const T Mar = at(2, k + 1), Mai = at(3, k + 1), Mbr = at(8, k + 1),
            Mbi = at(9, k + 1);
    na[2] = (e.E00r * Mar + e.E00i * Mai) + (e.E01r * Mbr + e.E01i * Mbi);
    na[3] = (e.E00r * Mai - e.E00i * Mar) + (e.E01r * Mbi - e.E01i * Mbr);
    nb[2] = (e.E10r * Mar + e.E10i * Mai) + (e.E11r * Mbr + e.E11i * Mbi);
    nb[3] = (e.E10r * Mai - e.E10i * Mar) + (e.E11r * Mbi - e.E11i * Mbr);
  } else {
    na[2] = na[3] = nb[2] = nb[3] = T(0);
  }
  const T Zar = at(4, k), Zai = at(5, k), Zbr = at(10, k), Zbi = at(11, k);
  na[4] = e.Z00 * Zar + e.Z01 * Zbr;
  if (k == 0) na[4] = na[4] + e.ra;
  na[5] = e.Z00 * Zai + e.Z01 * Zbi;
  nb[4] = e.Z10 * Zar + e.Z11 * Zbr;
  if (k == 0) nb[4] = nb[4] + e.rb;
  nb[5] = e.Z10 * Zai + e.Z11 * Zbi;
}

// One pool's relaxed order k (n) written into dst with the unit shift up:
// F+(k) → F+(k + 1), F−(k) → F−(k − 1), F−(1) → conj into F+(0).
template <typename T>
__device__ __forceinline__ void store_up(T* __restrict__ dst, int64_t nA,
                                         int K, const T (&n)[6], int k) {
  auto at = [&](int p, int q) -> int64_t { return ((int64_t)p * K + q) * nA; };
  dst[at(4, k)] = n[4];
  dst[at(5, k)] = n[5];
  if (k + 1 < K) {
    dst[at(0, k + 1)] = n[0];
    dst[at(1, k + 1)] = n[1];
  }
  if (k >= 1) {
    dst[at(2, k - 1)] = n[2];
    dst[at(3, k - 1)] = n[3];
  }
  if (k == 1) {
    dst[at(0, 0)] = n[2];
    dst[at(1, 0)] = -n[3];
  }
}

// One echo of the forward from the pre-echo state src into the next one,
// dst, both in logical order.
template <typename T>
__device__ void xecho_direct(const T* __restrict__ src, T* __restrict__ dst,
                             const cpmg::Trig<T>& g, const Prop<T>& e,
                             int64_t nA, int K) {
  const int64_t pool = (int64_t)6 * K * nA;
  for (int k = 0; k < K; ++k) {
    T sha[6], shb[6];
    xhalf_at(src, nA, K, k, e, sha, shb);
    T na[6], nb[6];
    cpmg::mix0(g, sha, na);
    cpmg::mix0(g, shb, nb);
    epgx::xrelax(e, k, na, nb);
    store_up(dst, nA, K, na, k);
    store_up(dst + pool, nA, K, nb, k);
  }
  for (int q = 0; q < 2; ++q) {
    T* d = dst + q * pool;
    d[(2 * (int64_t)K + K - 1) * nA] = T(0);
    d[(3 * (int64_t)K + K - 1) * nA] = T(0);
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// pk: (19, nA) at a fixed echo spacing; over an echo-spacing train
// (VARESP) the rows [cos φ_ex, sin φ_ex, M0a, M0b, b1] (5, nA), the entries
// of echo t at pkt + t·14·nA and their contractions at dpkt + t·14·nA.
template <typename T, bool VARESP>
__global__ void xcpmg_bwd_kernel(const T* __restrict__ coef,
                                 const T* __restrict__ pk,
                                 const T* __restrict__ pkt,
                                 const T* __restrict__ chk,
                                 const T* __restrict__ gr,
                                 const T* __restrict__ gi,
                                 T* __restrict__ scratch,
                                 T* __restrict__ hstate,
                                 T* __restrict__ dpar, T* __restrict__ dcf,
                                 T* __restrict__ dpkt, int64_t nA,
                                 int64_t nE, int K, int flags, int64_t tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t a = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // threads past nA take part in the warps' sums with zeros
  const bool active = a < nA;
  const int64_t warp = a >> 5;
  const bool writer = (threadIdx.x & 31) == 0 && warp * 32 < nA;
  const bool has_b1 = flags & cpmg::kB1;
  const Planes<T> h =
      hstate ? Planes<T>{hstate + a, nA, K}
             : Planes<T>{reinterpret_cast<T*>(smem_raw) + threadIdx.x,
                         (int64_t)blockDim.x, K};
  const Planes<T> hb = epgx::pool_b(h);
  // [cos φ_ex, sin φ_ex, M0a, M0b, b1]
  const T* pm = VARESP ? pk : pk + 14 * nA;
  Prop<T> e{};
  T b1 = 0;
  if (active) {
    if constexpr (!VARESP) e = epgx::load_prop(pk, nA, a);
    b1 = pm[4 * nA + a];
    for (int p = 0; p < kPlanes; ++p)
      for (int k = 0; k < K; ++k) h(p, k) = T(0);
  }
  T acc[14];
  for (int i = 0; i < 14; ++i) acc[i] = T(0);
  T ab1 = 0;
  int op = 0, om = 0;  // the adjoint's ring offsets of F+ and F−
  const int64_t plane = (int64_t)kPlanes * K * nA;
  const int64_t pool = (int64_t)6 * K * nA;
  const int64_t ntc = nE / tc;
  for (int64_t j = ntc - 1; j >= 0; --j) {
    const T* c0 = chk + j * plane;
    // phase 1: the forward from the chunk's start state, every state
    if (active)
      for (int64_t tl = 0; tl + 1 < tc; ++tl) {
        const int64_t t = j * tc + tl;
        const cpmg::Trig<T> g = cpmg::trig(coef, nE, t, b1, has_b1);
        if constexpr (VARESP) e = epgx::load_prop(pkt + t * 14 * nA, nA, a);
        xecho_direct((tl == 0 ? c0 : scratch + (tl - 1) * plane) + a,
                     scratch + tl * plane + a, g, e, nA, K);
      }
    // phase 2: the cotangent, backwards through the stored states
    for (int64_t tl = tc - 1; tl >= 0; --tl) {
      const int64_t t = j * tc + tl;
      T rows[5] = {0, 0, 0, 0, 0};
      if (active) {
        const T* x0 = (tl == 0 ? c0 : scratch + (tl - 1) * plane) + a;
        const cpmg::Trig<T> g = cpmg::trig(coef, nE, t, b1, has_b1);
        if constexpr (VARESP) e = epgx::load_prop(pkt + t * 14 * nA, nA, a);
        // the echo reads both pools' F+(0) after the second half
        const T gyr = gr[t * nA + a], gyi = gi[t * nA + a];
        h(0, op) = h(0, op) + gyr;
        h(1, op) = h(1, op) + gyi;
        hb(0, op) = hb(0, op) + gyr;
        hb(1, op) = hb(1, op) + gyi;
        epgx::ring_shift2_T(h, op, om, 1);
        // the second half's transpose at the mix's output s1, then the
        // mix's coefficients (against its input sh) and its transpose
        T kE[12], km[5] = {0, 0, 0, 0, 0};
        for (int i = 0; i < 12; ++i) kE[i] = T(0);
        T dra = 0, drb = 0;
        int ip = op, im = om;
        for (int k = 0; k < K; ++k) {
          T sha[6], shb[6];
          xhalf_at(x0, nA, K, k, e, sha, shb);
          T s1a[6], s1b[6];
          cpmg::mix0(g, sha, s1a);
          cpmg::mix0(g, shb, s1b);
          T ha[6] = {h(0, ip), h(1, ip), h(2, im), h(3, im), h(4, k), h(5, k)};
          T hv[6] = {hb(0, ip), hb(1, ip), hb(2, im),
                     hb(3, im), hb(4, k),  hb(5, k)};
          epgx::xrelax_T(e, k, s1a, s1b, ha, hv, kE, dra, drb);
          T ta[5], tb[5];
          cpmg::mix0_terms(ha, sha, ta);
          cpmg::mix0_terms(hv, shb, tb);
          for (int i = 0; i < 5; ++i) km[i] += ta[i] + tb[i];
          T oa[6], ob[6];
          cpmg::mix0_T(g, ha, oa);
          cpmg::mix0_T(g, hv, ob);
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
        // the entries' gradients: the second half's, then (below) the
        // first's; over a train the second half's wait in d2
        T d2[14];
        if constexpr (VARESP) {
          for (int i = 0; i < 12; ++i) d2[i] = kE[i];
          d2[12] = dra;
          d2[13] = drb;
        } else {
          for (int i = 0; i < 12; ++i) acc[i] = acc[i] + kE[i];
          acc[12] = acc[12] + dra;
          acc[13] = acc[13] + drb;
        }
        for (int i = 0; i < 12; ++i) kE[i] = T(0);
        dra = drb = T(0);
        // the first half's transpose at the stored pre-echo state
        epgx::ring_shift2_T(h, op, om, 1);
        ip = op;
        im = om;
        for (int k = 0; k < K; ++k) {
          T xa[6], xb[6];
          for (int p = 0; p < 6; ++p) {
            xa[p] = x0[((int64_t)p * K + k) * nA];
            xb[p] = x0[pool + ((int64_t)p * K + k) * nA];
          }
          T ha[6] = {h(0, ip), h(1, ip), h(2, im), h(3, im), h(4, k), h(5, k)};
          T hv[6] = {hb(0, ip), hb(1, ip), hb(2, im),
                     hb(3, im), hb(4, k),  hb(5, k)};
          epgx::xrelax_T(e, k, xa, xb, ha, hv, kE, dra, drb);
          h(0, ip) = ha[0];
          h(1, ip) = ha[1];
          h(2, im) = ha[2];
          h(3, im) = ha[3];
          h(4, k) = ha[4];
          h(5, k) = ha[5];
          hb(0, ip) = hv[0];
          hb(1, ip) = hv[1];
          hb(2, im) = hv[2];
          hb(3, im) = hv[3];
          hb(4, k) = hv[4];
          hb(5, k) = hv[5];
          ip = spgr::wrap_inc(ip, K);
          im = spgr::wrap_inc(im, K);
        }
        if constexpr (VARESP) {
          // this echo's entry gradients, both halves added
          T* dp = dpkt + t * 14 * nA + a;
          for (int i = 0; i < 12; ++i) dp[i * nA] = d2[i] + kE[i];
          dp[12 * nA] = d2[12] + dra;
          dp[13 * nA] = d2[13] + drb;
        } else {
          for (int i = 0; i < 12; ++i) acc[i] = acc[i] + kE[i];
          acc[12] = acc[12] + dra;
          acc[13] = acc[13] + drb;
        }
        // km: [ca2, sa2, sc, hc, ca] of the refocusing about +x
        const T d_sa = km[2] + T(0.5) * km[3];
        if (has_b1) {
          // α = flip·b1 through the half-angle trig
          const T d_al = ((T(0.5) * g.sa) * (km[1] - km[0]) + g.ca * d_sa) -
                         g.sa * km[4];
          ab1 = ab1 + d_al * coef[4 * nE + t];
          rows[4] = d_al * b1;
        } else {
          rows[0] = km[0];
          rows[1] = km[1];
          rows[2] = d_sa;
          rows[3] = km[4];
        }
      }
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        const T v = warp_sum(rows[c]);
        if (writer) dcf[(warp * nE + t) * 5 + c] = v;
      }
    }
  }
  if (active) {
    T* dm = dpar;  // [d cos φ_ex, d sin φ_ex, dM0a, dM0b, db1]
    if constexpr (!VARESP) {
      for (int i = 0; i < 14; ++i) dpar[i * nA + a] = acc[i];
      dm += 14 * nA;
    }
    // the excitation's state: per pool F+(0) = (exs, −exc)·M0p, F−(0) =
    // (exs, exc)·M0p
    const T exc = pm[a], exs = pm[nA + a], M0a = pm[2 * nA + a],
            M0b = pm[3 * nA + a];
    const T ra_ = h(0, op) + h(2, om), ia_ = -h(1, op) + h(3, om);
    const T rb_ = hb(0, op) + hb(2, om), ib_ = -hb(1, op) + hb(3, om);
    dm[a] = M0a * ia_ + M0b * ib_;
    dm[nA + a] = M0a * ra_ + M0b * rb_;
    dm[2 * nA + a] = exs * ra_ + exc * ia_;
    dm[3 * nA + a] = exs * rb_ + exc * ib_;
    dm[4 * nA + a] = ab1;
  }
}

template <typename T, bool VARESP>
int launch_xcpmg_bwd(const T* coef, const T* pk, const T* pkt, const T* chk,
                     const T* gr, const T* gi, T* scratch, T* hstate,
                     T* dpar, T* dcf, T* dpkt, int64_t nA, int64_t nE,
                     int64_t K, int64_t flags, int64_t tc, int64_t threads,
                     void* stream) {
  if (nA <= 0 || nE <= 0 || K < 2 || tc <= 0 || nE % tc != 0 ||
      (flags & ~(int64_t)cpmg::kB1) != 0 ||
      !spgr::valid_threads((int)threads) ||
      (VARESP && (pkt == nullptr || dpkt == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      hstate ? 0 : (size_t)threads * kPlanes * (size_t)K * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        xcpmg_bwd_kernel<T, VARESP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + threads - 1) / threads);
  xcpmg_bwd_kernel<T, VARESP><<<grid, (unsigned)threads, smem,
                                (cudaStream_t)stream>>>(
      coef, pk, pkt, chk, gr, gi, scratch, hstate, dpar, dcf, dpkt, nA, nE,
      (int)K, (int)flags, tc);
  return (int)cudaGetLastError();
}

}  // namespace xcpmg
}  // namespace mrphy

// Inputs (coef (5, nE), pk (19, nA), chk (nE / tc, 12, K, nA), gr, gi (nE,
// nA)), the scratch (max(tc − 1, 1), 12, K, nA), the adjoint state in
// device memory hstate (12, K, nA) or NULL to keep it in shared memory, the
// outputs dpar (19, nA) and dcf (ceil(nA/32), nE, 5); sizes, flags (1 b1),
// tc, threads per block. Returns the cudaError_t of the launch (0 =
// success).
#define MRPHY_XCPMG_BWD_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* coef, const void* pk, const void* chk,     \
                      const void* gr, const void* gi, void* scratch,         \
                      void* hstate, void* dpar, void* dcf, int64_t nA,       \
                      int64_t nE, int64_t K, int64_t flags, int64_t tc,      \
                      int64_t threads, void* stream) {                        \
    return mrphy::xcpmg::launch_xcpmg_bwd<T, false>(                          \
        (const T*)coef, (const T*)pk, nullptr, (const T*)chk, (const T*)gr,   \
        (const T*)gi, (T*)scratch, (T*)hstate, (T*)dpar, (T*)dcf, nullptr,    \
        nA, nE, K, flags, tc, threads, stream);                               \
  }

MRPHY_XCPMG_BWD_ENTRY(mrphy_xcpmg_bwd_f32, float)
MRPHY_XCPMG_BWD_ENTRY(mrphy_xcpmg_bwd_f64, double)

// The echo-spacing train: inputs coef (5, nE), pk (5, nA) = [cos φ_ex,
// sin φ_ex, M0a, M0b, b1], the planes pkt (nE, 14, nA), chk, gr and gi as
// above; the outputs dpar (5, nA) = [d cos φ_ex, d sin φ_ex, dM0a, dM0b,
// db1], dcf as above and dpkt (nE, 14, nA).
#define MRPHY_XCPMG_V_BWD_ENTRY(NAME, T)                                      \
  extern "C" int NAME(const void* coef, const void* pk, const void* pkt,     \
                      const void* chk, const void* gr, const void* gi,       \
                      void* scratch, void* hstate, void* dpar, void* dcf,    \
                      void* dpkt, int64_t nA, int64_t nE, int64_t K,         \
                      int64_t flags, int64_t tc, int64_t threads,            \
                      void* stream) {                                         \
    return mrphy::xcpmg::launch_xcpmg_bwd<T, true>(                           \
        (const T*)coef, (const T*)pk, (const T*)pkt, (const T*)chk,           \
        (const T*)gr, (const T*)gi, (T*)scratch, (T*)hstate, (T*)dpar,        \
        (T*)dcf, (T*)dpkt, nA, nE, K, flags, tc, threads, stream);            \
  }

MRPHY_XCPMG_V_BWD_ENTRY(mrphy_xcpmg_v_bwd_f32, float)
MRPHY_XCPMG_V_BWD_ENTRY(mrphy_xcpmg_v_bwd_f64, double)
