// bssfp_bwd: the two-phase chunk adjoint of the transient balanced-SSFP
// train on Hopper (sm_90a).
//
// Replaces the TPU kernel `_bssfp_bwd_kernel` of
// mrphy_tpu/ops/ssfp_pallas.py (launched by `_bssfp_bwd_call`), as the entry
// points mrphy_bssfp_bwd_*. Chunks of tc TRs are visited newest first.
// Phase 1 re-runs the forward from the chunk's start state (chk, written by
// bssfp_fwd_chk) and stores every pre-RF state; phase 2 walks them
// backwards, per TR: the remainder's transpose (the gradients of its four
// factors and of M0), the echo's cotangent into the TE state (and into
// cos φ, sin φ), the TE interval's transpose, the RF rotation's transpose
// (the gradients of its coefficients). Outputs: dpk (nP, nA), the per-atom
// rows' gradients (at a constant TR/TE the eight factors', M0's, b1's;
// under a variable TR/TE those of 1/T1, 1/T2, ω, M0 and b1, the factors'
// chained to the rates inside the kernel), with the initial state's
// cotangent added to M0's row; dcf (ceil(nA/32), nTR, nC), each warp's
// per-TR coefficient rows summed over its atoms, which the wrapper sums over
// warps in a fixed order (no atomics). Under b1 the angle α·b1 is per atom:
// its gradient goes to db1 and to the flip row, and rows 0-4 stay 0. Under
// a variable TR/TE the last two rows are d/dte and d/d(tr − te).
//
// What bounds it on the H100: arithmetic. A TR is the step twice (phase 1
// and its recomputation) and its transpose, ~150 multiplies and adds, and
// under a variable TR sixteen precise transcendentals; device memory sees
// the cotangent once (1.68 GB at 1,048,576 atoms × 200 TRs in float32),
// the pre-RF states written and read once (2.5 GB), and the warps' rows
// (32,768 warps × nC 10 in float32: 1.3 MB a TR, 262 MB in all).
//
// Design. One thread per atom, its state, adjoint state and nP accumulators
// in registers. Phase 1 runs from chk into a device-memory scratch (tc, 3,
// nA), atoms fastest (coalesced), sized by the wrapper (kernels/epg.py
// `pick_tc` with 3 planes: tc 100 at 1,048,576 atoms × 200 TRs, 1.26 GB).
// Every per-atom sum is taken in the plain version's order (kernels/ssfp.py
// `bssfp_bwd_torch`), so per-atom results agree bit for bit (built without
// FMA contraction). The per-TR rows are reduced over a warp's atoms by
// shuffles, lanes past nA adding zeros, in the order the plain version sums
// them (`_warp_sums`); threads past nA run the loop with zeros for the
// shuffles' sake. No fallback: every instance bssfp_fwd_chk takes, this
// kernel takes.
#include "bssfp_common.cuh"

namespace mrphy {
namespace bssfp {

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool VARTR, bool B1>
__global__ void bssfp_bwd_kernel(const T* __restrict__ coef,
                                 const T* __restrict__ pk,
                                 const T* __restrict__ chk,
                                 const T* __restrict__ gr,
                                 const T* __restrict__ gi,
                                 T* __restrict__ scratch, T* __restrict__ dpk,
                                 T* __restrict__ dcf, int64_t nA, int64_t nTR,
                                 int64_t tc) {
  using R = Rows<VARTR>;
  constexpr int nP = R::kP, nC = R::kC;
  const int64_t a = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // threads past nA take part in the warps' sums with zeros
  const bool valid = a < nA;
  const int64_t warp = a >> 5;
  const bool writer = (threadIdx.x & 31) == 0 && warp * 32 < nA;
  T p[nP];
#pragma unroll
  for (int i = 0; i < nP; ++i) p[i] = valid ? pk[i * nA + a] : T(0);
  const T M0 = p[R::kM0], b1 = p[nP - 1];
  T acc[nP];
#pragma unroll
  for (int i = 0; i < nP; ++i) acc[i] = T(0);
  T hx2 = T(0), hy2 = T(0), hz2 = T(0);
  const int64_t ntc = nTR / tc;
  for (int64_t j = ntc - 1; j >= 0; --j) {
    const int64_t t0 = j * tc;
    // phase 1: the forward from the chunk's start state, every state
    {
      const T* c = chk + j * 3 * nA + a;
      T Mx = valid ? c[0] : T(0), My = valid ? c[nA] : T(0),
        Mz = valid ? c[2 * nA] : T(0);
      for (int64_t tl = 0; tl < tc; ++tl) {
        if (valid) {
          T* s = scratch + tl * 3 * nA + a;
          s[0] = Mx;
          s[nA] = My;
          s[2 * nA] = Mz;
        }
        if (tl + 1 == tc) break;  // the chunk's end state is not needed
        const int64_t t = t0 + tl;
        T r, i;
        step(rf<T, B1>(coef, nTR, t, b1), relax<T, VARTR>(coef, nTR, t, p),
             M0, Mx, My, Mz, r, i);
      }
    }
    // phase 2: the cotangent, backwards through the stored states
    for (int64_t tl = tc - 1; tl >= 0; --tl) {
      const int64_t t = t0 + tl;
      T Mx = T(0), My = T(0), Mz = T(0), gyr = T(0), gyi = T(0);
      if (valid) {
        const T* s = scratch + tl * 3 * nA + a;
        Mx = s[0];
        My = s[nA];
        Mz = s[2 * nA];
        gyr = gr[t * nA + a];
        gyi = gi[t * nA + a];
      }
      const Rf<T> g = rf<T, B1>(coef, nTR, t, b1);
      const Relax<T> x = relax<T, VARTR>(coef, nTR, t, p);
      const T ca = g.ca, sa = g.sa, A = g.A, B = g.B, vc = g.vc, vs = g.vs,
              cphi = g.cphi, sphi = g.sphi;
      // the step's intermediates
      const T dot = cphi * Mx + sphi * My;
      const T Mx1 = ca * Mx - A * Mz + vc * dot;
      const T My1 = ca * My + B * Mz + vs * dot;
      const T Mz1 = ca * Mz + A * Mx - B * My;
      const T MxE = x.E2te * (x.cte * Mx1 - x.ste * My1);
      const T MyE = x.E2te * (x.ste * Mx1 + x.cte * My1);
      const T MzE = (T(1) - x.a1te) * Mz1 + x.a1te * M0;
      // the remainder's transpose and its factors' gradients
      const T d_E2rem = hx2 * (x.crem * MxE - x.srem * MyE) +
                        hy2 * (x.srem * MxE + x.crem * MyE);
      const T d_crem = x.E2rem * (hx2 * MxE + hy2 * MyE);
      const T d_srem = x.E2rem * (hy2 * MxE - hx2 * MyE);
      const T d_a1rem = hz2 * (M0 - MzE);
      T d_M0 = x.a1rem * hz2;
      T hxE = x.E2rem * (x.crem * hx2 + x.srem * hy2);
      T hyE = x.E2rem * (x.crem * hy2 - x.srem * hx2);
      const T hzE = (T(1) - x.a1rem) * hz2;
      // the echo's cotangent (the echo reads the TE state)
      T d_cphi = gyr * MxE + gyi * MyE;
      T d_sphi = gyr * MyE - gyi * MxE;
      hxE = hxE + cphi * gyr - sphi * gyi;
      hyE = hyE + sphi * gyr + cphi * gyi;
      // the TE transpose and its factors' gradients
      const T d_E2te = hxE * (x.cte * Mx1 - x.ste * My1) +
                       hyE * (x.ste * Mx1 + x.cte * My1);
      const T d_cte = x.E2te * (hxE * Mx1 + hyE * My1);
      const T d_ste = x.E2te * (hyE * Mx1 - hxE * My1);
      const T d_a1te = hzE * (M0 - Mz1);
      d_M0 = d_M0 + x.a1te * hzE;
      const T hx1 = x.E2te * (x.cte * hxE + x.ste * hyE);
      const T hy1 = x.E2te * (x.cte * hyE - x.ste * hxE);
      const T hz1 = (T(1) - x.a1te) * hzE;
      // the RF rotation's transpose and its coefficients' gradients
      const T d_ca = hx1 * Mx + hy1 * My + hz1 * Mz;
      const T d_A = hz1 * Mx - hx1 * Mz;
      const T d_B = hy1 * Mz - hz1 * My;
      const T d_vc = hx1 * dot;
      const T d_vs = hy1 * dot;
      const T hdot = vc * hx1 + vs * hy1;
      d_cphi = d_cphi + hdot * Mx;
      d_sphi = d_sphi + hdot * My;
      hx2 = ca * hx1 + A * hz1 + cphi * hdot;
      hy2 = ca * hy1 - B * hz1 + sphi * hdot;
      hz2 = -A * hx1 + B * hy1 + ca * hz1;
      T rows[nC];
      if constexpr (B1) {
        // α = flip·b1: A, B, vc, vs chained back to (α, φ) here
        const T d_sa = sphi * d_A + cphi * d_B;
        const T d_catot = d_ca - cphi * d_vc - sphi * d_vs;
        const T d_al = ca * d_sa - sa * d_catot;
        acc[nP - 1] = acc[nP - 1] + d_al * __ldg(coef + 7 * nTR + t);
        d_cphi = d_cphi + sa * d_B + (T(1) - ca) * d_vc;
        d_sphi = d_sphi + sa * d_A + (T(1) - ca) * d_vs;
        rows[0] = rows[1] = rows[2] = rows[3] = rows[4] = T(0);
        rows[5] = d_cphi;
        rows[6] = d_sphi;
        rows[7] = d_al * b1;
      } else {
        rows[0] = d_ca;
        rows[1] = d_A;
        rows[2] = d_B;
        rows[3] = d_vc;
        rows[4] = d_vs;
        rows[5] = d_cphi;
        rows[6] = d_sphi;
        rows[7] = T(0);
      }
      if constexpr (VARTR) {
        const T R1 = p[0], R2 = p[1], om = p[2];
        const T ten = __ldg(coef + 8 * nTR + t);
        const T remn = __ldg(coef + 9 * nTR + t);
        const T d_pte = x.cte * d_ste - x.ste * d_cte;
        const T d_prem = x.crem * d_srem - x.srem * d_crem;
        acc[2] = acc[2] + d_pte * ten + d_prem * remn;
        acc[1] = acc[1] - ten * x.E2te * d_E2te - remn * x.E2rem * d_E2rem;
        acc[0] = acc[0] + ten * (T(1) - x.a1te) * d_a1te +
                 remn * (T(1) - x.a1rem) * d_a1rem;
        acc[3] = acc[3] + d_M0;
        rows[8] = om * d_pte - R2 * x.E2te * d_E2te +
                  R1 * (T(1) - x.a1te) * d_a1te;
        rows[9] = om * d_prem - R2 * x.E2rem * d_E2rem +
                  R1 * (T(1) - x.a1rem) * d_a1rem;
      } else {
        acc[0] = acc[0] + d_cte;
        acc[1] = acc[1] + d_ste;
        acc[2] = acc[2] + d_E2te;
        acc[3] = acc[3] + d_a1te;
        acc[4] = acc[4] + d_crem;
        acc[5] = acc[5] + d_srem;
        acc[6] = acc[6] + d_E2rem;
        acc[7] = acc[7] + d_a1rem;
        acc[8] = acc[8] + d_M0;
      }
#pragma unroll
      for (int c = 0; c < nC; ++c) {
        const T v = warp_sum(valid ? rows[c] : T(0));
        if (writer) dcf[(warp * nTR + t) * nC + c] = v;
      }
    }
  }
  if (!valid) return;
  // the initial state (0, 0, M0)
  acc[R::kM0] = acc[R::kM0] + hz2;
#pragma unroll
  for (int i = 0; i < nP; ++i) dpk[i * nA + a] = acc[i];
}

template <typename T, bool VARTR, bool B1>
int launch_one(const T* coef, const T* pk, const T* chk, const T* gr,
               const T* gi, T* scratch, T* dpk, T* dcf, int64_t nA,
               int64_t nTR, int64_t tc, void* stream) {
  constexpr unsigned kThreads = 128;
  const unsigned grid = (unsigned)((nA + kThreads - 1) / kThreads);
  bssfp_bwd_kernel<T, VARTR, B1><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      coef, pk, chk, gr, gi, scratch, dpk, dcf, nA, nTR, tc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bssfp_bwd(const T* coef, const T* pk, const T* chk, const T* gr,
                     const T* gi, T* scratch, T* dpk, T* dcf, int64_t nA,
                     int64_t nTR, int64_t flags, int64_t tc, void* stream) {
  if (nA <= 0 || nTR <= 0 || tc <= 0 || nTR % tc != 0 ||
      (flags & ~(int64_t)(kB1 | kVarTR)) != 0)
    return (int)cudaErrorInvalidValue;
  const bool b1 = flags & kB1, vartr = flags & kVarTR;
  if (vartr)
    return b1 ? launch_one<T, true, true>(coef, pk, chk, gr, gi, scratch, dpk,
                                          dcf, nA, nTR, tc, stream)
              : launch_one<T, true, false>(coef, pk, chk, gr, gi, scratch,
                                           dpk, dcf, nA, nTR, tc, stream);
  return b1 ? launch_one<T, false, true>(coef, pk, chk, gr, gi, scratch, dpk,
                                         dcf, nA, nTR, tc, stream)
            : launch_one<T, false, false>(coef, pk, chk, gr, gi, scratch, dpk,
                                          dcf, nA, nTR, tc, stream);
}

}  // namespace bssfp
}  // namespace mrphy

// Inputs coef (nC, nTR), pk (nP, nA), the checkpoints chk (nTR / tc, 3, nA)
// of bssfp_fwd_chk at the same tc and the echoes' cotangent gr, gi (nTR,
// nA); the scratch (tc, 3, nA); outputs dpk (nP, nA) and dcf (ceil(nA/32),
// nTR, nC); sizes, flags (1 b1, 2 variable TR/TE), tc. Returns the
// cudaError_t of the launch (0 = success).
#define MRPHY_BSSFP_BWD_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* coef, const void* pk, const void* chk,     \
                      const void* gr, const void* gi, void* scratch,         \
                      void* dpk, void* dcf, int64_t nA, int64_t nTR,         \
                      int64_t flags, int64_t tc, void* stream) {             \
    return mrphy::bssfp::launch_bssfp_bwd<T>(                                \
        (const T*)coef, (const T*)pk, (const T*)chk, (const T*)gr,           \
        (const T*)gi, (T*)scratch, (T*)dpk, (T*)dcf, nA, nTR, flags, tc,     \
        stream);                                                             \
  }

MRPHY_BSSFP_BWD_ENTRY(mrphy_bssfp_bwd_f32, float)
MRPHY_BSSFP_BWD_ENTRY(mrphy_bssfp_bwd_f64, double)
