// bssfp_fwd: the transient balanced-SSFP train (bSSFP-MRF dictionaries,
// direct bSSFP parameter fits) on Hopper (sm_90a), with and without chunk
// checkpoints.
//
// Replaces two TPU kernels of mrphy_tpu/ops/ssfp_pallas.py: `_bssfp_kernel`
// (launched by `_bssfp_fast`), the forward of a train, as the entry points
// mrphy_bssfp_fwd_*; and `_bssfp_fwd_chk_kernel` (launched by
// `_bssfp_fwd_chk`), the same train writing the pre-RF state at the start
// of every chunk of tc TRs for the adjoint bssfp_bwd, as
// mrphy_bssfp_fwd_chk_*. Per atom and TR, from the equilibrium (0, 0, M0):
// the RF rotation about (cos φ, sin φ, 0) by −α (Rodrigues), precession and
// relaxation to TE, the echo (Mx + iMy)·e^{−iφ}, precession and relaxation
// over the TR remainder. At a constant TR/TE the eight relaxation and
// precession factors are per-atom rows and a TR runs no transcendental
// (unless b1); under a variable TR or TE the kernel forms them per atom
// and TR from the rates (two cos, two sin, two exp, two expm1). Options:
// per-atom b1 (the angle's cos and sin per atom and TR).
//
// What bounds it on the H100: device memory, then arithmetic. The echoes
// are written once, 8 bytes an atom and TR in float32 (1.68 GB at
// 1,048,576 atoms × 200 TRs, 0.50 ms at the card's 3.35 TB/s); a TR is ~30
// multiplies and adds, and under a variable TR eight precise
// transcendentals, of a few tens of instructions each.
//
// Design: one thread per atom walks the whole train with (Mx, My, Mz) and
// its per-atom rows in registers; the per-TR rows are the same for every
// thread (read-only cache, one transaction a warp). The echoes are written
// (nTR, nA), atoms fastest (coalesced); the public (nA, nTR, 2) is formed
// outside the kernel. Built without FMA contraction, in the plain
// version's order of operations (kernels/ssfp.py `bssfp_fwd_torch`): the
// two agree bit for bit. Templated on the scalar type, the checkpoints, the
// variable TR and b1. No padding of the train: any nTR runs.
#include "bssfp_common.cuh"

namespace mrphy {
namespace bssfp {

template <typename T, bool CHK, bool VARTR, bool B1>
__global__ void bssfp_fwd_kernel(const T* __restrict__ coef,
                                 const T* __restrict__ pk,
                                 T* __restrict__ er, T* __restrict__ ei,
                                 T* __restrict__ chk, int64_t nA, int64_t nTR,
                                 int64_t tc) {
  using R = Rows<VARTR>;
  const int64_t a = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= nA) return;
  T p[R::kP];
#pragma unroll
  for (int i = 0; i < R::kP; ++i) p[i] = pk[i * nA + a];
  const T M0 = p[R::kM0], b1 = p[R::kP - 1];
  T Mx = T(0), My = T(0), Mz = M0;
  for (int64_t t = 0; t < nTR; ++t) {
    if (CHK && t % tc == 0) {
      T* c = chk + (t / tc) * 3 * nA + a;
      c[0] = Mx;
      c[nA] = My;
      c[2 * nA] = Mz;
    }
    const Rf<T> g = rf<T, B1>(coef, nTR, t, b1);
    const Relax<T> x = relax<T, VARTR>(coef, nTR, t, p);
    T r, i;
    step(g, x, M0, Mx, My, Mz, r, i);
    er[t * nA + a] = r;
    ei[t * nA + a] = i;
  }
}

template <typename T, bool CHK, bool VARTR, bool B1>
int launch_one(const T* coef, const T* pk, T* er, T* ei, T* chk, int64_t nA,
               int64_t nTR, int64_t tc, void* stream) {
  constexpr unsigned kThreads = 128;
  const unsigned grid = (unsigned)((nA + kThreads - 1) / kThreads);
  bssfp_fwd_kernel<T, CHK, VARTR, B1>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(coef, pk, er, ei, chk, nA,
                                                    nTR, tc);
  return (int)cudaGetLastError();
}

template <typename T, bool CHK>
int launch_bssfp_fwd(const T* coef, const T* pk, T* er, T* ei, T* chk,
                     int64_t nA, int64_t nTR, int64_t flags, int64_t tc,
                     void* stream) {
  if (nA <= 0 || nTR <= 0 || tc <= 0 || nTR % tc != 0 ||
      (flags & ~(int64_t)(kB1 | kVarTR)) != 0 || (CHK && chk == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool b1 = flags & kB1, vartr = flags & kVarTR;
  if (vartr)
    return b1 ? launch_one<T, CHK, true, true>(coef, pk, er, ei, chk, nA, nTR,
                                               tc, stream)
              : launch_one<T, CHK, true, false>(coef, pk, er, ei, chk, nA,
                                                nTR, tc, stream);
  return b1 ? launch_one<T, CHK, false, true>(coef, pk, er, ei, chk, nA, nTR,
                                              tc, stream)
            : launch_one<T, CHK, false, false>(coef, pk, er, ei, chk, nA, nTR,
                                               tc, stream);
}

}  // namespace bssfp
}  // namespace mrphy

// Inputs coef (nC, nTR) and pk (nP, nA); the echoes er, ei (nTR, nA); the
// checkpoints chk (nTR / tc, 3, nA) (the _chk entries only, else NULL);
// sizes, flags (1 b1, 2 variable TR/TE), tc. Returns the cudaError_t of the
// launch (0 = success).
#define MRPHY_BSSFP_FWD_ENTRY(NAME, T, CHK)                                  \
  extern "C" int NAME(const void* coef, const void* pk, void* er, void* ei, \
                      void* chk, int64_t nA, int64_t nTR, int64_t flags,    \
                      int64_t tc, void* stream) {                            \
    return mrphy::bssfp::launch_bssfp_fwd<T, CHK>(                           \
        (const T*)coef, (const T*)pk, (T*)er, (T*)ei, (T*)chk, nA, nTR,      \
        flags, tc, stream);                                                  \
  }

MRPHY_BSSFP_FWD_ENTRY(mrphy_bssfp_fwd_f32, float, false)
MRPHY_BSSFP_FWD_ENTRY(mrphy_bssfp_fwd_f64, double, false)
MRPHY_BSSFP_FWD_ENTRY(mrphy_bssfp_fwd_chk_f32, float, true)
MRPHY_BSSFP_FWD_ENTRY(mrphy_bssfp_fwd_chk_f64, double, true)
