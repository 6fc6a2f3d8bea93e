// beff_fwd: the B-effective-streaming Bloch forward on Hopper (sm_90a).
//
// Replaces the TPU kernel `_beff_fwd_kernel` (launched by
// `blochsim_fwd_planes`, mrphy_tpu/ops/pallas_kernels.py). Per spin and
// step: b = γ2πdt·Beff[t], the same rotation and relaxation as rfgr_fwd
// (bloch_step.cuh); the state at the end of every chunk of tc steps is
// written to chk (ntc, 3, B), the final state being chk[-1].
//
// What bounds it on the H100: device-memory bandwidth. Beff is read once,
// 3 values per spin-step (12 bytes in f32, 6 in bf16), against ~65 flops
// and one sincos per spin-step of rotation math — below the card's flop/byte
// balance, so the time is ~nT·B·bytes / (3.35 TB/s).
//
// Design: one thread per spin over the (3, B) planes, batch folded into
// spins by the caller; Beff arrives as (nT, 3, B), so at every step the
// threads of a warp read 3 × 32 neighbouring values (coalesced), and
// nothing else leaves registers inside the time loop. The loads of a step
// do not depend on the state, so the compiler and the warp scheduler
// overlap them with the previous step's arithmetic. Storage is templated
// apart from compute: a bf16 Beff streams at half the bytes and is
// widened to f32 at load (__bfloat162float), as mrphy_tpu does.
#include <cuda_bf16.h>

#include "bloch_step.cuh"

namespace mrphy {

template <typename T, typename S> struct Widen;
template <> struct Widen<float, float> {
  __device__ static float f(float x) { return x; }
};
template <> struct Widen<double, double> {
  __device__ static double f(double x) { return x; }
};
template <> struct Widen<float, __nv_bfloat16> {
  __device__ static float f(__nv_bfloat16 x) { return __bfloat162float(x); }
};

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
beff_fwd_kernel(const T* __restrict__ mi, const S* __restrict__ beff,
                const T* __restrict__ E, const T* __restrict__ e1_1,
                const T* __restrict__ g2pd, T* __restrict__ chk, int64_t B,
                int64_t nT, int64_t tc) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= B) return;
  const bool relax = E != nullptr;
  T mx = mi[s], my = mi[B + s], mz = mi[2 * B + s];
  const T g = g2pd[s];
  T E2 = 1, E1 = 1, e1 = 0;
  if (relax) {
    E2 = E[s];
    E1 = E[2 * B + s];
    e1 = e1_1[s];
  }
  const S* p = beff + s;
  const int64_t ntc = nT / tc;
  for (int64_t j = 0; j < ntc; ++j) {
    for (int64_t t = 0; t < tc; ++t, p += 3 * B) {
      const T bx = g * Widen<T, S>::f(p[0]);
      const T by = g * Widen<T, S>::f(p[B]);
      const T bz = g * Widen<T, S>::f(p[2 * B]);
      rot_relax(mx, my, mz, bx, by, bz, relax, E2, E1, e1);
    }
    T* o = chk + j * 3 * B + s;
    o[0] = mx;
    o[B] = my;
    o[2 * B] = mz;
  }
}

template <typename T, typename S>
int launch_beff_fwd(const void* mi, const void* beff, const void* E,
                    const void* e1_1, const void* g2pd, void* chk, int64_t B,
                    int64_t nT, int64_t tc, void* stream) {
  if (B <= 0 || nT <= 0 || tc <= 0 || nT % tc != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  beff_fwd_kernel<T, S><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)mi, (const S*)beff, (const T*)E, (const T*)e1_1,
      (const T*)g2pd, (T*)chk, B, nT, tc);
  return (int)cudaGetLastError();
}

}  // namespace mrphy

// E and e1_1 are NULL without relaxation. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int mrphy_beff_fwd_f32(const void* mi, const void* beff,
                                  const void* E, const void* e1_1,
                                  const void* g2pd, void* chk, int64_t B,
                                  int64_t nT, int64_t tc, void* stream) {
  return mrphy::launch_beff_fwd<float, float>(mi, beff, E, e1_1, g2pd, chk,
                                              B, nT, tc, stream);
}

extern "C" int mrphy_beff_fwd_f32_bf16(const void* mi, const void* beff,
                                       const void* E, const void* e1_1,
                                       const void* g2pd, void* chk,
                                       int64_t B, int64_t nT, int64_t tc,
                                       void* stream) {
  return mrphy::launch_beff_fwd<float, __nv_bfloat16>(
      mi, beff, E, e1_1, g2pd, chk, B, nT, tc, stream);
}

extern "C" int mrphy_beff_fwd_f64(const void* mi, const void* beff,
                                  const void* E, const void* e1_1,
                                  const void* g2pd, void* chk, int64_t B,
                                  int64_t nT, int64_t tc, void* stream) {
  return mrphy::launch_beff_fwd<double, double>(mi, beff, E, e1_1, g2pd,
                                                chk, B, nT, tc, stream);
}
