// One Bloch step shared by the forward kernels: rotation by the field
// impulse b (radians) about u = b/|b|, then T1/T2 relaxation.
//
// Same arithmetic as mrphy_tpu's `_rot_relax_planes`
// (mrphy_tpu/ops/pallas_kernels.py), except that sin/cos come from the
// CUDA math library (sincosf / sincos, full range reduction; no fast-math
// intrinsics) instead of the TPU's polynomial `_fast_sincos`.
//
// Rounding: the kernels are built with -fmad=false (kernels/_build.py)
// and write every operation in the order of the plain PyTorch version
// (kernels/bloch.py, `_rot_relax`), whose CUDA kernels call the same
// sinf/cosf/rsqrtf. So a kernel reproduces its plain version bit for bit
// on the card. With FMA contraction the two drift apart by up to ~nT·ε:
// a spin's field, and mz under a mostly-z field, change slowly, so a
// rounding difference there recurs at every step and adds up coherently
// (measured on an H100: 4.7e-5 in float32 at 64³ spins × 1000 steps, ϕ
// up to 9 rad, with no gain in accuracy against float64). Contraction is
// left to a later, measured change.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mrphy {

constexpr int kThreads = 256;  // threads per block, one spin per thread

// |b|² is clamped at (1e-12)², as in mrphy_tpu (`_PHI_EPS`): the axis of
// a zero field is arbitrary and the rotation is the identity to O(ϕ²).
template <typename T> __device__ __forceinline__ T phi_eps2() {
  return T(1e-24);
}

__device__ __forceinline__ void sin_cos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) {
  sincos(x, s, c);
}
__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }

// m₁ = m − s·(u×m) + (c−1)·(m − (uᵀm)·u);  relaxed: (E2·m₁x, E2·m₁y,
// E1·m₁z − (E1−1)).  Updates (mx, my, mz) in place.
template <typename T>
__device__ __forceinline__ void rot_relax(T& mx, T& my, T& mz, T bx, T by,
                                          T bz, bool relax, T E2, T E1,
                                          T e1_1) {
  T n2 = bx * bx + by * by + bz * bz;
  n2 = n2 > phi_eps2<T>() ? n2 : phi_eps2<T>();
  const T inv = rsqrt_(n2);
  const T phi = n2 * inv;
  const T ux = bx * inv, uy = by * inv, uz = bz * inv;
  T s, c;
  sin_cos(phi, &s, &c);
  const T c1 = c - T(1);
  const T utm = ux * mx + uy * my + uz * mz;
  T m1x = mx - s * (uy * mz - uz * my) + c1 * (mx - utm * ux);
  T m1y = my - s * (uz * mx - ux * mz) + c1 * (my - utm * uy);
  T m1z = mz - s * (ux * my - uy * mx) + c1 * (mz - utm * uz);
  if (relax) {
    m1x *= E2;
    m1y *= E2;
    m1z = m1z * E1 - e1_1;
  }
  mx = m1x;
  my = m1y;
  mz = m1z;
}

}  // namespace mrphy
