// beff_bwd: the reconstruction adjoint of beff_fwd on Hopper (sm_90a).
//
// Replaces the TPU kernel `_beff_bwd_kernel` (launched by
// `blochsim_bwd_planes`, mrphy_tpu/ops/pallas_kernels.py). One thread per
// spin of the (3, B) planes walks the pulse backwards, newest time chunk
// first: at the start of chunk j the state restarts from beff_fwd's
// chunk-end state chk[j] and the cotangent of chk[j] is added to the
// carried cotangent h. Every step reads Beff[t] in its storage dtype
// (widened at load, as beff_fwd does), undoes the step (bloch_step.cuh
// `rot_relax_bwd`) and writes dBeff[t] = γ2πdt·∂L/∂b in Beff's storage
// dtype (bf16 when Beff is bf16, rounded to nearest even, as the plain
// version's `.to(torch.bfloat16)` rounds). dMi is written after chunk 0.
//
// What bounds it on the H100: device-memory bandwidth, with the adjoint
// step's arithmetic (~2.5× beff_fwd's per spin-step) close behind. It
// reads Beff and writes dBeff, 2 × 12 bytes per spin-step in f32
// (2 × 3.1 GB at 64³ spins × 1000 steps), and nothing else leaves
// registers inside the time loop. Neighbouring threads touch neighbouring
// addresses of the (nT, 3, B) layout, so every load and store coalesces.
//
// Built, like beff_fwd, without FMA contraction and in the plain version's
// order of operations (kernels/bloch.py `beff_bwd_torch`). `nvcc -Xptxas
// -v` (CUDA 12.9, sm_90a): 39 registers (f32), 40 (bf16), 70 (f64), no
// spills.
#include <cuda_bf16.h>

#include "bloch_step.cuh"

namespace mrphy {

template <typename T, typename S> struct Cast;
template <> struct Cast<float, float> {
  __device__ static float widen(float x) { return x; }
  __device__ static float narrow(float x) { return x; }
};
template <> struct Cast<double, double> {
  __device__ static double widen(double x) { return x; }
  __device__ static double narrow(double x) { return x; }
};
template <> struct Cast<float, __nv_bfloat16> {
  __device__ static float widen(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __nv_bfloat16 narrow(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
beff_bwd_kernel(const T* __restrict__ chk, const T* __restrict__ g,
                const S* __restrict__ beff, const T* __restrict__ E,
                const T* __restrict__ e1_1, const T* __restrict__ g2pd,
                T* __restrict__ dmi, S* __restrict__ dbeff, int64_t B,
                int64_t nT, int64_t tc) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= B) return;
  const bool relax = E != nullptr;
  const T gg = g2pd[s];
  T E2 = 1, E1 = 1, e1 = 0, iE2 = 1, iE1 = 1;
  if (relax) {
    E2 = E[s];
    E1 = E[2 * B + s];
    e1 = e1_1[s];
    iE2 = T(1) / E2;
    iE1 = T(1) / E1;
  }
  const int64_t ntc = nT / tc;
  T hx = 0, hy = 0, hz = 0;
  for (int64_t j = ntc - 1; j >= 0; --j) {
    const int64_t o = j * 3 * B + s;
    T mx = chk[o], my = chk[o + B], mz = chk[o + 2 * B];
    hx = hx + g[o];
    hy = hy + g[o + B];
    hz = hz + g[o + 2 * B];
    for (int64_t t = (j + 1) * tc - 1; t >= j * tc; --t) {
      const S* p = beff + t * 3 * B + s;
      const T bx = gg * Cast<T, S>::widen(p[0]);
      const T by = gg * Cast<T, S>::widen(p[B]);
      const T bz = gg * Cast<T, S>::widen(p[2 * B]);
      T dbx, dby, dbz;
      rot_relax_bwd(mx, my, mz, hx, hy, hz, bx, by, bz, relax, E2, E1, e1,
                    iE2, iE1, dbx, dby, dbz);
      S* q = dbeff + t * 3 * B + s;
      q[0] = Cast<T, S>::narrow(gg * dbx);
      q[B] = Cast<T, S>::narrow(gg * dby);
      q[2 * B] = Cast<T, S>::narrow(gg * dbz);
    }
  }
  dmi[s] = hx;
  dmi[B + s] = hy;
  dmi[2 * B + s] = hz;
}

template <typename T, typename S>
int launch_beff_bwd(const void* chk, const void* g, const void* beff,
                    const void* E, const void* e1_1, const void* g2pd,
                    void* dmi, void* dbeff, int64_t B, int64_t nT,
                    int64_t tc, void* stream) {
  if (B <= 0 || nT <= 0 || tc <= 0 || nT % tc != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  beff_bwd_kernel<T, S><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)chk, (const T*)g, (const S*)beff, (const T*)E,
      (const T*)e1_1, (const T*)g2pd, (T*)dmi, (S*)dbeff, B, nT, tc);
  return (int)cudaGetLastError();
}

}  // namespace mrphy

// E and e1_1 are NULL without relaxation. Returns the cudaError_t of the
// launch (0 = success).
#define MRPHY_BEFF_BWD_ENTRY(NAME, T, S)                                     \
  extern "C" int NAME(const void* chk, const void* g, const void* beff,     \
                      const void* E, const void* e1_1, const void* g2pd,    \
                      void* dmi, void* dbeff, int64_t B, int64_t nT,        \
                      int64_t tc, void* stream) {                           \
    return mrphy::launch_beff_bwd<T, S>(chk, g, beff, E, e1_1, g2pd, dmi,   \
                                        dbeff, B, nT, tc, stream);          \
  }

MRPHY_BEFF_BWD_ENTRY(mrphy_beff_bwd_f32, float, float)
MRPHY_BEFF_BWD_ENTRY(mrphy_beff_bwd_f32_bf16, float, __nv_bfloat16)
MRPHY_BEFF_BWD_ENTRY(mrphy_beff_bwd_f64, double, double)
