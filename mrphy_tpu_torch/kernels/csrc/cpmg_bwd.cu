// cpmg_bwd: the two-phase chunk adjoint of the CPMG echo train on Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_cpmg_bwd_kernel` (launched by `_cpmg_core_bwd`,
// mrphy_tpu/ops/epg_pallas.py). Chunks of tc echoes are visited newest
// first. Phase 1 re-runs the forward from the chunk's start state (chk,
// written by cpmg_fwd_chk) and stores every pre-echo state; phase 2 walks
// them backwards: per echo the cotangent injected at F+(0), the second
// half's transpose (unit shift, diffusion with its ∂dq contraction,
// relaxation with ∂E1h, ∂E2h, ∂rech), the refocusing mix's coefficient
// gradients and transpose, the first half's transpose. Outputs: dpar (8, nA)
// = [dE1h, dE2h, drech, d_ss, d_sc, d_ca, db1, ddq] (under a spacing train
// the factor chains run here too: [dR1, dR2, dM0, …], and the esp row of
// dcoef); dcf (ceil(nA/32), nE, nC), each warp's per-echo coefficient rows
// summed over its atoms, which the wrapper sums over warps in a fixed order
// (no atomics).
//
// What bounds it on the H100: arithmetic and device memory. Phase 1 writes
// and phase 2 reads the pre-echo states, 6·K values per atom and echo (27
// GB at 1,048,576 atoms × 32 echoes × K 33 in float32; the states after the
// first half are formed again from them), beside ~3× the forward's
// arithmetic.
//
// Design. One thread per atom, as cpmg_fwd. Phase 1 runs from chk into a
// device-memory scratch (tc − 1, 6, K, nA), orders in logical order: each
// order of the state after the first half is read from its neighbours
// (`half_at`), mixed and relaxed, and written with the second unit shift as
// an index offset. The adjoint state h (6·K values) lives in shared memory
// as a ring buffer over the orders (in device memory where the forward's
// state would), so each unit shift's transpose is two offsets and three
// slots. Per echo two passes over the orders: the second half's and the
// mix's transposes together (the mix's input formed again by `half_at`),
// then the first half's. Every sum over the orders is taken one order at a
// time in the plain version's order (kernels/epg.py `cpmg_bwd_torch`), so
// per-atom results agree bit for bit (built without FMA contraction). The
// per-echo rows are reduced over a warp's atoms by shuffles; lanes past nA
// add zeros. No fallback: every instance cpmg_fwd_chk takes, this kernel
// takes, with the chunk length the wrapper chose for the scratch
// (kernels/epg.py `pick_tc`).
#include "cpmg_common.cuh"

namespace mrphy {
namespace cpmg {

using spgr::Planes;

// One echo of the forward from the pre-echo state src into the next one,
// dst, both in logical order (element (p, k) at [(p·K + k)·nA]).
template <typename T>
__device__ void echo_direct(const T* __restrict__ src, T* __restrict__ dst,
                            const Trig<T>& g, const Factors<T>& f, T dqt,
                            const T* __restrict__ cdiff, int64_t nA, int K,
                            bool has_d) {
  auto at = [&](int p, int k) -> int64_t { return ((int64_t)p * K + k) * nA; };
  for (int k = 0; k < K; ++k) {
    T sh[6];
    half_at(src, nA, K, k, f, has_d, cdiff, dqt, sh);
    T n[6];
    mix0(g, sh, n);
    T A[3] = {T(1), T(1), T(1)};
    if (has_d) spgr::attenuation(cdiff, K, k, dqt, A);
    spgr::relax(f, k, has_d, A, n);
    // the second unit shift: F+ up, F− down, F+(0) = conj(new F−(0))
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
  dst[at(2, K - 1)] = T(0);
  dst[at(3, K - 1)] = T(0);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void cpmg_bwd_kernel(const T* __restrict__ coef,
                                const T* __restrict__ par,
                                const T* __restrict__ dqr,
                                const T* __restrict__ cdiff,
                                const T* __restrict__ chk,
                                const T* __restrict__ gr,
                                const T* __restrict__ gi,
                                T* __restrict__ scratch,
                                T* __restrict__ hstate, T* __restrict__ dpar,
                                T* __restrict__ dcf, int64_t nA, int64_t nE,
                                int nC, int flags, int64_t tc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t a = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // threads past nA take part in the warps' sums with zeros
  const bool active = a < nA;
  const int64_t warp = a >> 5;
  const bool writer = (threadIdx.x & 31) == 0 && warp * 32 < nA;
  const bool has_b1 = flags & kB1, varesp = flags & kVarEsp,
             has_d = flags & kDiff;
  const int K = (int)nE + 1;
  const Planes<T> h =
      hstate ? Planes<T>{hstate + a, nA, K}
             : Planes<T>{reinterpret_cast<T*>(smem_raw) + threadIdx.x,
                         (int64_t)blockDim.x, K};
  T p0 = 0, p1 = 0, p2 = 0, b1 = 0, dq = 0;
  if (active) {
    p0 = par[a];
    p1 = par[nA + a];
    p2 = par[2 * nA + a];
    b1 = par[6 * nA + a];
    dq = dqr[a];
    for (int p = 0; p < 6; ++p)
      for (int k = 0; k < K; ++k) h(p, k) = T(0);
  }
  T aE1 = 0, aE2 = 0, arec = 0, ab1 = 0, aDq = 0;
  int op = 0, om = 0;  // the adjoint's ring offsets of F+ and F−
  const int64_t plane = (int64_t)6 * K * nA;
  const int64_t ntc = nE / tc;
  for (int64_t j = ntc - 1; j >= 0; --j) {
    const T* c0 = chk + j * plane;
    // phase 1: the forward from the chunk's start state, every state
    if (active)
      for (int64_t tl = 0; tl + 1 < tc; ++tl) {
        const int64_t t = j * tc + tl;
        const Trig<T> g = trig(coef, nE, t, b1, has_b1);
        const Factors<T> f = factors(coef, nE, t, p0, p1, p2, varesp);
        const T dqt = varesp ? dq * (T(0.5) * coef[5 * nE + t]) : dq;
        echo_direct((tl == 0 ? c0 : scratch + (tl - 1) * plane) + a,
                    scratch + tl * plane + a, g, f, dqt, cdiff, nA, K, has_d);
      }
    // phase 2: the cotangent, backwards through the stored states
    for (int64_t tl = tc - 1; tl >= 0; --tl) {
      const int64_t t = j * tc + tl;
      T rows[6] = {0, 0, 0, 0, 0, 0};
      if (active) {
        const T* x0 = (tl == 0 ? c0 : scratch + (tl - 1) * plane) + a;
        const Trig<T> g = trig(coef, nE, t, b1, has_b1);
        const Factors<T> f = factors(coef, nE, t, p0, p1, p2, varesp);
        const T dqt = varesp ? dq * (T(0.5) * coef[5 * nE + t]) : dq;
        // the echo reads F+(0) after the second half
        h(0, op) = h(0, op) + gr[t * nA + a];
        h(1, op) = h(1, op) + gi[t * nA + a];
        spgr::ring_shift_T(h, op, om, true);
        // the second half's transpose at the mix's output s1, then the
        // mix's coefficients (against its input sh) and its transpose
        T c2 = 0, e2_2 = 0, e1_2 = 0, r2 = 0;
        T kca2 = 0, ksc2 = 0, ksc = 0, khc = 0, kca = 0;
        int ip = op, im = om;
        for (int k = 0; k < K; ++k) {
          T sh[6], s1[6];
          half_at(x0, nA, K, k, f, has_d, cdiff, dqt, sh);
          mix0(g, sh, s1);
          T hv[6] = {h(0, ip), h(1, ip), h(2, im), h(3, im), h(4, k), h(5, k)};
          spgr::relax_T(f, K, k, has_d, cdiff, dqt, s1, hv, c2, e2_2, e1_2,
                        r2);
          T tm[5];
          mix0_terms(hv, sh, tm);
          kca2 += tm[0];
          ksc2 += tm[1];
          ksc += tm[2];
          khc += tm[3];
          kca += tm[4];
          T o[6];
          mix0_T(g, hv, o);
          h(0, ip) = o[0];
          h(1, ip) = o[1];
          h(2, im) = o[2];
          h(3, im) = o[3];
          h(4, k) = o[4];
          h(5, k) = o[5];
          ip = spgr::wrap_inc(ip, K);
          im = spgr::wrap_inc(im, K);
        }
        // the first half's transpose at the pre-echo state
        spgr::ring_shift_T(h, op, om, true);
        T c1 = 0, e2_1 = 0, e1_1 = 0, r1 = 0;
        ip = op;
        im = om;
        for (int k = 0; k < K; ++k) {
          const T x[6] = {x0[((int64_t)0 * K + k) * nA],
                          x0[((int64_t)1 * K + k) * nA],
                          x0[((int64_t)2 * K + k) * nA],
                          x0[((int64_t)3 * K + k) * nA],
                          x0[((int64_t)4 * K + k) * nA],
                          x0[((int64_t)5 * K + k) * nA]};
          T hv[6] = {h(0, ip), h(1, ip), h(2, im), h(3, im), h(4, k), h(5, k)};
          spgr::relax_T(f, K, k, has_d, cdiff, dqt, x, hv, c1, e2_1, e1_1,
                        r1);
          h(0, ip) = hv[0];
          h(1, ip) = hv[1];
          h(2, im) = hv[2];
          h(3, im) = hv[3];
          h(4, k) = hv[4];
          h(5, k) = hv[5];
          ip = spgr::wrap_inc(ip, K);
          im = spgr::wrap_inc(im, K);
        }
        // each half's factors (and diffusion), the second half first
        T d_esp = 0;
        const T hn = varesp ? T(0.5) * coef[5 * nE + t] : T(0);
        const T kc[2] = {c2, c1}, kE2[2] = {e2_2, e2_1}, kE1[2] = {e1_2, e1_1},
                d_rec[2] = {r2, r1};
        for (int u = 0; u < 2; ++u) {
          if (has_d) {
            const T contr = -kc[u];
            if (varesp) {
              aDq = aDq + hn * contr;
              d_esp = d_esp + (T(0.5) * dq) * contr;
            } else {
              aDq = aDq + contr;
            }
          }
          if (varesp) {
            // the slots hold (R1, R2, M0); rech = M0·(1 − E1h)
            const T d_E1tot = kE1[u] - p2 * d_rec[u];
            arec = arec + (T(1) - f.E1) * d_rec[u];
            aE1 = aE1 - (hn * f.E1) * d_E1tot;
            aE2 = aE2 - (hn * f.E2) * kE2[u];
            d_esp = d_esp - T(0.5) * ((p0 * f.E1) * d_E1tot +
                                      (p1 * f.E2) * kE2[u]);
          } else {
            aE1 = aE1 + kE1[u];
            aE2 = aE2 + kE2[u];
            arec = arec + d_rec[u];
          }
        }
        const T d_sa = ksc + T(0.5) * khc;
        if (has_b1) {
          // α = flip·b1 through the half-angle trig
          const T d_al = ((T(0.5) * g.sa) * (ksc2 - kca2) + g.ca * d_sa) -
                         g.sa * kca;
          ab1 = ab1 + d_al * coef[4 * nE + t];
          rows[4] = d_al * b1;
        } else {
          rows[0] = kca2;
          rows[1] = ksc2;
          rows[2] = d_sa;
          rows[3] = kca;
        }
        rows[5] = d_esp;
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        if (c >= nC) break;
        const T v = warp_sum(rows[c]);
        if (writer) dcf[(warp * nE + t) * nC + c] = v;
      }
    }
  }
  if (active) {
    // the excitation's state: F+(0) = (e_ss, −e_sc), F−(0) = (e_ss, e_sc),
    // Z(0) = e_ca
    const T out[8] = {aE1, aE2, arec, h(0, op) + h(2, om),
                      -h(1, op) + h(3, om), h(4, 0), ab1, aDq};
    for (int i = 0; i < 8; ++i) dpar[i * nA + a] = out[i];
  }
}

template <typename T>
int launch_cpmg_bwd(const T* coef, const T* par, const T* dq, const T* cdiff,
                    const T* chk, const T* gr, const T* gi, T* scratch,
                    T* hstate, T* dpar, T* dcf, int64_t nA, int64_t nE,
                    int64_t nC, int64_t flags, int64_t tc, int64_t threads,
                    void* stream) {
  if (!valid_args(nA, nE, nC, flags, tc, threads))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      hstate ? 0 : (size_t)threads * 6 * (size_t)(nE + 1) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cpmg_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((nA + threads - 1) / threads);
  cpmg_bwd_kernel<T><<<grid, (unsigned)threads, smem, (cudaStream_t)stream>>>(
      coef, par, dq, cdiff, chk, gr, gi, scratch, hstate, dpar, dcf, nA, nE,
      (int)nC, (int)flags, tc);
  return (int)cudaGetLastError();
}

}  // namespace cpmg
}  // namespace mrphy

// Inputs (coef, par, dq, cdiff, chk (nE / tc, 6, K, nA), gr, gi (nE, nA)),
// the scratch (max(tc − 1, 1), 6, K, nA), the adjoint state in device
// memory hstate (6, K, nA) or NULL to keep it in shared memory, the outputs
// dpar (8, nA) and dcf (ceil(nA/32), nE, nC); sizes, flags (1 b1, 2 spacing
// train, 4 diffusion), tc, threads per block. Returns the cudaError_t of
// the launch (0 = success).
#define MRPHY_CPMG_BWD_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* coef, const void* par, const void* dq,     \
                      const void* cdiff, const void* chk, const void* gr,    \
                      const void* gi, void* scratch, void* hstate,           \
                      void* dpar, void* dcf, int64_t nA, int64_t nE,         \
                      int64_t nC, int64_t flags, int64_t tc,                 \
                      int64_t threads, void* stream) {                        \
    return mrphy::cpmg::launch_cpmg_bwd<T>(                                   \
        (const T*)coef, (const T*)par, (const T*)dq, (const T*)cdiff,         \
        (const T*)chk, (const T*)gr, (const T*)gi, (T*)scratch, (T*)hstate,   \
        (T*)dpar, (T*)dcf, nA, nE, nC, flags, tc, threads, stream);           \
  }

MRPHY_CPMG_BWD_ENTRY(mrphy_cpmg_bwd_f32, float)
MRPHY_CPMG_BWD_ENTRY(mrphy_cpmg_bwd_f64, double)
