// Shared by the k-space signal kernels (sig_fwd.cu, sig_adj.cu,
// sig_vjp.cu): the encoding phase, its exact half-cycle reduction, the
// sin/cos and the T2* decay, and the coil-group layout of the rows. sig_fwd
// and sig_adj take the tensor-core kernels of sig_mma.cuh, which use
// `phase`, `factors` (float64) and `IntC` from here (float32 forms the
// same factors with its own sign step); the coil groups serve sig_vjp.
//
// Phase: φ = ((x·k_x + y·k_y) + z·k_z) + Δf·t_t in cycles, t_t = (t+1)·dt,
// written in the order of the plain versions (kernels/signal.py
// `_factors`), so with -fmad=false (kernels/_build.py) φ is bit for bit
// the plain version's. ψ = −2πφ is never formed: j = rint(2φ) and r = φ −
// j/2 are exact in the working type (|r| ≤ 1/4; |φ| < 2^22 cycles), and
// sin/cos ψ = (−1)^j · sincospi(−2r). So no radian argument is ever rounded
// at |ψ| ~ 600 rad (|φ| reaches ~100 cycles at 64³ spins over 24 cm), and
// the library's sincospi is accurate to an ulp or two on |−2r| ≤ 1/2. This
// is the reduction of mrphy_tpu's `_sincos_m2pi` without its polynomials.
// Decay E = exp(−t_t·(1/T2*)), the library exp.
//
// Coil groups: a block accumulates the rows of at most R/2 coils (R = 2,
// 8 or 16, a template parameter; the wrappers take R = 16 with groups of
// 8 coils beyond 4 coils), so per-thread accumulators stay in registers
// for any coil count; more coils take more groups (gridDim), each
// recomputing the phase. Local row j < R/2 is w_re (or s_re, g_re) of coil
// c0 + j, row R/2 + j its w_im; rows of coils past nC are zero.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mrphy_sig {

constexpr int kThreads = 256;  // threads per block
constexpr int kGroup = 8;      // coils per group of the R = 16 instance

__device__ __forceinline__ float rint_(float x) { return rintf(x); }
__device__ __forceinline__ double rint_(double x) { return rint(x); }
__device__ __forceinline__ void sincospi_(float x, float* s, float* c) {
  sincospif(x, s, c);
}
__device__ __forceinline__ void sincospi_(double x, double* s, double* c) {
  sincospi(x, s, c);
}
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}

// The phase of one spin at one sample, in cycles.
template <typename T>
__device__ __forceinline__ T phase(T x, T y, T z, T d, bool has_df, T kx,
                                   T ky, T kz, T tt) {
  T phi = x * kx + y * ky + z * kz;
  if (has_df) phi = phi + d * tt;
  return phi;
}

// The factors C = E·cos ψ, S = E·sin ψ of phase φ (cycles) at time tt.
template <typename T>
__device__ __forceinline__ void factors(T phi, T tt, T it2, bool relax,
                                        T& C, T& S) {
  const T j = rint_(phi + phi);  // nearest half cycle
  const T r = phi - T(0.5) * j;  // exact
  T s, c;
  sincospi_(T(-2) * r, &s, &c);
  T E = (static_cast<long long>(j) & 1) ? T(-1) : T(1);
  if (relax) E = E * exp_(-(tt * it2));
  C = E * c;
  S = E * s;
}

// The group geometry of blockIdx-derived group g: first coil c0 and the
// number of coils nc in it (≤ R/2).
struct Group {
  int64_t c0;
  int nc;
};

template <int R>
__device__ __forceinline__ Group group_of(int64_t g, int64_t nC) {
  const int64_t c0 = g * (R / 2);
  const int64_t left = nC - c0;
  return {c0, (int)(left < R / 2 ? left : R / 2)};
}

// Global row of local row j in group gr, or −1 for a padding row.
template <int R>
__device__ __forceinline__ int64_t row_of(int j, Group gr, int64_t nC) {
  const int cj = j < R / 2 ? j : j - R / 2;
  if (cj >= gr.nc) return -1;
  return (j < R / 2 ? 0 : nC) + gr.c0 + cj;
}

// Calls f(std::integral_constant<int, R>) with the register width R for
// nC coils: 2 for one coil, 8 for up to 4, else 16 (groups of 8 coils).
template <int V>
struct IntC {
  static constexpr int value = V;
};

template <typename F>
__host__ int dispatch_rows(int64_t nC, F&& f) {
  if (nC == 1) return f(IntC<2>{});
  if (nC <= 4) return f(IntC<8>{});
  return f(IntC<16>{});
}

template <int R>
__host__ __forceinline__ int64_t groups_of(int64_t nC) {
  return (nC + R / 2 - 1) / (R / 2);
}

}  // namespace mrphy_sig
