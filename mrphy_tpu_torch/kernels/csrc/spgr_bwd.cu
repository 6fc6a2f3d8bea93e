// spgr_bwd: the two-phase chunk adjoint of the SPGR / MRF-FISP EPG train
// on Hopper (sm_90a).
//
// Replaces the TPU kernel `_spgr_bwd_kernel` (launched by `_spgr_bwd`,
// mrphy_tpu/ops/epg_pallas.py). Chunks of tc TRs are visited newest first.
// Phase 1 re-runs the forward from the chunk's start state (chk, written by
// spgr_fwd_chk) and stores every pre-RF state; phase 2 walks them backwards:
// the shift's transpose, the diffusion transpose (its ∂dq contraction), the
// relaxation transpose (∂E1, ∂E2, ∂rec), the echo's cotangent injected at
// F+(0) (∂E2te and the phase coefficients' echo terms), and the RF mix's
// transpose with the per-TR coefficient gradients. Outputs: dpar (7, nA) =
// [dE1, dE2, dE2te, drec, dz0, db1, ddq] (under variable TR/TE the factor
// chains run here too: [dR1, dR2, dM0, 0, dz0, db1, ddq], and the tr/te
// rows of dcoef); dcf (ceil(nA/32), nTR, nC), each warp's per-TR
// coefficient rows summed over its atoms, which the wrapper sums over warps
// in a fixed order (no atomics).
//
// What bounds it on the H100: device memory. Phase 1 writes and phase 2
// reads every pre-RF state, 6·K values per atom and TR (60 GB at 65,536
// atoms × 400 TRs × K 48 in float32), beside ~2.5× the forward's
// arithmetic.
//
// Design. One thread per atom, as spgr_fwd. Phase 1 runs from chk into a
// device-memory scratch (tc − 1, 6, K, nA), orders in logical order, the
// shift written as an index offset (F+(k) → F+(k + s), F−(k) → F−(k − s),
// the k = 0 crossing conjugated into F+(s − k)). The adjoint state h (6·K
// values) lives in shared memory as a ring buffer over the orders, as the
// forward's state does (in device memory where the forward's would), so the
// shift's transpose is two offsets and three slots. Every sum over the
// orders is taken one order at a time in the plain version's order
// (kernels/epg.py `spgr_bwd_torch`), so per-atom results agree bit for bit
// (built without FMA contraction). The per-TR rows are reduced over a
// warp's atoms by shuffles; lanes past nA add zeros. No fallback: every
// instance spgr_fwd_chk takes, this kernel takes, at any K, with the
// chunk length the wrapper chose for the scratch (kernels/epg.py
// `pick_tc`).
#include "spgr_common.cuh"

namespace mrphy {
namespace spgr {

// One TR of the forward from the pre-RF state src into the next one, dst,
// both in logical order (element (p, k) at [(p·K + k)·nA]).
template <typename T>
__device__ void fwd_direct(const T* __restrict__ src, T* __restrict__ dst,
                           const Trig<T>& g, const Factors<T>& f, T dqt,
                           const T* __restrict__ cdiff, int64_t nA, int K,
                           int kshift, bool has_d) {
  const int s = kshift > 0 ? kshift : -kshift;
  // up: F+ moves up by s and F− down; the mirror otherwise
  const int P = kshift > 0 ? 0 : 2, M = kshift > 0 ? 2 : 0;
  auto at = [&](int p, int k) -> int64_t { return ((int64_t)p * K + k) * nA; };
  for (int k = 0; k < K; ++k) {
    const T x[6] = {src[at(0, k)], src[at(1, k)], src[at(2, k)],
                    src[at(3, k)], src[at(4, k)], src[at(5, k)]};
    T n[6];
    mix(g, x, n);
    T A[3] = {T(1), T(1), T(1)};
    if (has_d) attenuation(cdiff, K, k, dqt, A);
    relax(f, k, has_d, A, n);
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
  // orders shifted in from beyond K − 1
  for (int k = K - s > 0 ? K - s : 0; k < K; ++k) {
    dst[at(M, k)] = T(0);
    dst[at(M + 1, k)] = T(0);
  }
  for (int k = 0; k < s - K + 1 && k < K; ++k) {
    dst[at(P, k)] = T(0);
    dst[at(P + 1, k)] = T(0);
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void spgr_bwd_kernel(const T* __restrict__ coef,
                                const T* __restrict__ par,
                                const T* __restrict__ cdiff,
                                const T* __restrict__ chk,
                                const T* __restrict__ gy,
                                T* __restrict__ scratch,
                                T* __restrict__ hstate, T* __restrict__ dpar,
                                T* __restrict__ dcf, int64_t nA, int64_t nTR,
                                int nC, int K, int kshift, int flags,
                                int64_t tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t a = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // threads past nA take part in the warps' sums with zeros
  const bool active = a < nA;
  const int64_t warp = a >> 5;
  const bool writer = (threadIdx.x & 31) == 0 && warp * 32 < nA;
  const bool has_b1 = flags & kB1, vartr = flags & kVarTR,
             has_d = flags & kDiff;
  const Planes<T> h =
      hstate ? Planes<T>{hstate + a, nA, K}
             : Planes<T>{reinterpret_cast<T*>(smem_raw) + threadIdx.x,
                         (int64_t)blockDim.x, K};
  T p0 = 0, p1 = 0, p2 = 0, p3 = 0, b1 = 0, dq = 0;
  if (active) {
    p0 = par[a];
    p1 = par[nA + a];
    p2 = par[2 * nA + a];
    p3 = par[3 * nA + a];
    b1 = par[5 * nA + a];
    dq = par[6 * nA + a];
    for (int p = 0; p < 6; ++p)
      for (int k = 0; k < K; ++k) h(p, k) = T(0);
  }
  T aE1 = 0, aE2 = 0, aE2te = 0, arec = 0, ab1 = 0, aDq = 0;
  const int nshift = kshift > 0 ? kshift : -kshift;
  int op = 0, om = 0;  // the adjoint's ring offsets of F+ and F−
  const int64_t plane = (int64_t)6 * K * nA;
  const int64_t ntc = nTR / tc;
  for (int64_t j = ntc - 1; j >= 0; --j) {
    const T* c0 = chk + j * plane;
    // phase 1: the forward from the chunk's start state, every state
    if (active)
      for (int64_t tl = 0; tl + 1 < tc; ++tl) {
        const int64_t t = j * tc + tl;
        const Trig<T> g = trig(coef, nTR, t, b1, has_b1);
        const Factors<T> f = factors(coef, nTR, t, p0, p1, p2, p3, vartr);
        const T dqt = vartr ? dq * coef[9 * nTR + t] : dq;
        fwd_direct((tl == 0 ? c0 : scratch + (tl - 1) * plane) + a,
                   scratch + tl * plane + a, g, f, dqt, cdiff, nA, K, kshift,
                   has_d);
      }
    // phase 2: the cotangent, backwards through the stored states
    for (int64_t tl = tc - 1; tl >= 0; --tl) {
      const int64_t t = j * tc + tl;
      T rows[11] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
      if (active) {
        const T* x0 = (tl == 0 ? c0 : scratch + (tl - 1) * plane) + a;
        const Trig<T> g = trig(coef, nTR, t, b1, has_b1);
        const Factors<T> f = factors(coef, nTR, t, p0, p1, p2, p3, vartr);
        const T dqt = vartr ? dq * coef[9 * nTR + t] : dq;
        for (int u = 0; u < nshift; ++u) ring_shift_T(h, op, om, kshift > 0);
        // the sums over the orders, one order at a time
        T kcontr = 0, kE2 = 0, kE1 = 0, kca2 = 0, ksc2 = 0, kss2 = 0,
          kss = 0, ksc = 0, khs = 0, khc = 0, kca = 0;
        T d_rec = 0, d_E2te = 0, d_c1e = 0, d_s1e = 0;
        int ip = op, im = om;
        for (int k = 0; k < K; ++k) {
          const T x[6] = {x0[((int64_t)0 * K + k) * nA],
                          x0[((int64_t)1 * K + k) * nA],
                          x0[((int64_t)2 * K + k) * nA],
                          x0[((int64_t)3 * K + k) * nA],
                          x0[((int64_t)4 * K + k) * nA],
                          x0[((int64_t)5 * K + k) * nA]};
          T s1[6];
          mix(g, x, s1);
          T hv[6] = {h(0, ip), h(1, ip), h(2, im), h(3, im), h(4, k), h(5, k)};
          // the diffusion and relaxation transposes
          relax_T(f, K, k, has_d, cdiff, dqt, s1, hv, kcontr, kE2, kE1, d_rec);
          if (k == 0) {
            // the echo's cotangent (the echo reads the mixed state)
            const T gyr = gy[(a * nTR + t) * 2], gyi = gy[(a * nTR + t) * 2 + 1];
            const T fr = s1[0], fi = s1[1];
            d_E2te = gyr * (g.c1 * fr + g.s1 * fi) +
                     gyi * (g.c1 * fi - g.s1 * fr);
            hv[0] = hv[0] + f.E2te * (g.c1 * gyr - g.s1 * gyi);
            hv[1] = hv[1] + f.E2te * (g.s1 * gyr + g.c1 * gyi);
            d_c1e = f.E2te * (gyr * fr + gyi * fi);
            d_s1e = f.E2te * (gyr * fi - gyi * fr);
          }
          // the RF mix's coefficients, against the pre-RF state
          kca2 += ((hv[0] * x[0] + hv[1] * x[1]) + hv[2] * x[2]) +
                  hv[3] * x[3];
          ksc2 += ((hv[0] * x[2] + hv[1] * x[3]) + hv[2] * x[0]) +
                  hv[3] * x[1];
          kss2 += ((-hv[0] * x[3] + hv[1] * x[2]) + hv[2] * x[1]) -
                  hv[3] * x[0];
          kss += (hv[0] + hv[2]) * x[4] + (hv[1] + hv[3]) * x[5];
          ksc += (hv[0] - hv[2]) * x[5] - (hv[1] - hv[3]) * x[4];
          khs += -hv[4] * (x[0] + x[2]) - hv[5] * (x[1] + x[3]);
          khc += hv[4] * (x[1] - x[3]) + hv[5] * (x[2] - x[0]);
          kca += hv[4] * x[4] + hv[5] * x[5];
          T o[6];
          mix_T(g, hv, o);
          h(0, ip) = o[0];
          h(1, ip) = o[1];
          h(2, im) = o[2];
          h(3, im) = o[3];
          h(4, k) = o[4];
          h(5, k) = o[5];
          ip = wrap_inc(ip, K);
          im = wrap_inc(im, K);
        }
        const T contr = -kcontr;
        if (vartr) {
          // the slots hold (R1, R2, M0): chain the per-TR factors back to
          // them and to the tr/te rows; rec = M0·(1 − E1)
          const T trn = coef[9 * nTR + t], ten = coef[10 * nTR + t];
          const T d_E1tot = kE1 - p2 * d_rec;
          aE2te = aE2te + (T(1) - f.E1) * d_rec;
          aE1 = aE1 - (trn * f.E1) * d_E1tot;
          aE2 = (aE2 - (trn * f.E2) * kE2) - (ten * f.E2te) * d_E2te;
          T d_tr = ((-p0) * f.E1) * d_E1tot - (p1 * f.E2) * kE2;
          if (has_d) {
            aDq = aDq + trn * contr;
            d_tr = d_tr + dq * contr;
          }
          rows[9] = d_tr;
          rows[10] = ((-p1) * f.E2te) * d_E2te;
        } else {
          aE1 = aE1 + kE1;
          aE2 = aE2 + kE2;
          arec = arec + d_rec;
          aE2te = aE2te + d_E2te;
          if (has_d) aDq = aDq + contr;
        }
        const T d_sa2 = g.c2 * ksc2 + g.s2 * kss2;
        const T d_sa = g.s1 * (kss + T(0.5) * khs) + g.c1 * (ksc + T(0.5) * khc);
        rows[4] = g.sa * (ksc + T(0.5) * khc) + d_c1e;
        rows[5] = g.sa * (kss + T(0.5) * khs) + d_s1e;
        rows[6] = g.sa2 * ksc2;
        rows[7] = g.sa2 * kss2;
        if (has_b1) {
          // α = flip·b1 through the half-angle trig
          const T d_al = ((T(0.5) * g.sa) * (d_sa2 - kca2) + g.ca * d_sa) -
                         g.sa * kca;
          ab1 = ab1 + d_al * coef[8 * nTR + t];
          rows[8] = d_al * b1;
        } else {
          rows[0] = kca2;
          rows[1] = d_sa2;
          rows[2] = d_sa;
          rows[3] = kca;
        }
      }
#pragma unroll
      for (int c = 0; c < 11; ++c) {
        if (c >= nC) break;
        const T v = warp_sum(rows[c]);
        if (writer) dcf[(warp * nTR + t) * nC + c] = v;
      }
    }
  }
  if (active) {
    // the initial state is z0 on Z(0)'s real part
    const T out[7] = {aE1, aE2, aE2te, arec, h(4, 0), ab1, aDq};
    for (int i = 0; i < 7; ++i) dpar[i * nA + a] = out[i];
  }
}

template <typename T>
int launch_spgr_bwd(const T* coef, const T* par, const T* cdiff, const T* chk,
                    const T* gy, T* scratch, T* hstate, T* dpar, T* dcf,
                    int64_t nA, int64_t nTR, int64_t nC, int64_t K,
                    int64_t kshift, int64_t flags, int64_t tc,
                    int64_t threads, void* stream) {
  if (nA <= 0 || nTR <= 0 || K <= 0 || kshift == 0 || tc <= 0 ||
      nTR % tc != 0 || nC != ((flags & kVarTR) ? 11 : 9) ||
      !valid_threads((int)threads))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      hstate ? 0 : (size_t)threads * 6 * (size_t)K * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spgr_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + threads - 1) / threads);
  spgr_bwd_kernel<T><<<grid, (unsigned)threads, smem, (cudaStream_t)stream>>>(
      coef, par, cdiff, chk, gy, scratch, hstate, dpar, dcf, nA, nTR, (int)nC,
      (int)K, (int)kshift, (int)flags, tc);
  return (int)cudaGetLastError();
}

}  // namespace spgr
}  // namespace mrphy

// Inputs (coef, par, cdiff, chk (nTR / tc, 6, K, nA), g (nA, nTR, 2)), the
// scratch (max(tc − 1, 1), 6, K, nA), the adjoint state in device memory
// hstate (6, K, nA) or NULL to keep it in shared memory, the outputs dpar
// (7, nA) and dcf (ceil(nA/32), nTR, nC); sizes, kshift, flags (1 b1, 2
// variable TR/TE, 4 diffusion), tc, threads per block. Returns the
// cudaError_t of the launch (0 = success).
#define MRPHY_SPGR_BWD_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* coef, const void* par, const void* cdiff,  \
                      const void* chk, const void* g, void* scratch,         \
                      void* hstate, void* dpar, void* dcf, int64_t nA,       \
                      int64_t nTR, int64_t nC, int64_t K, int64_t kshift,    \
                      int64_t flags, int64_t tc, int64_t threads,            \
                      void* stream) {                                         \
    return mrphy::spgr::launch_spgr_bwd<T>(                                   \
        (const T*)coef, (const T*)par, (const T*)cdiff, (const T*)chk,        \
        (const T*)g, (T*)scratch, (T*)hstate, (T*)dpar, (T*)dcf, nA, nTR, nC, \
        K, kshift, flags, tc, threads, stream);                               \
  }

MRPHY_SPGR_BWD_ENTRY(mrphy_spgr_bwd_f32, float)
MRPHY_SPGR_BWD_ENTRY(mrphy_spgr_bwd_f64, double)
