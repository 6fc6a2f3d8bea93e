// One Bloch step shared by the kernels: rotation by the field impulse b
// (radians) about u = b/|b|, then T1/T2 relaxation (`rot_relax`, the
// forward kernels), and the same step run backwards for the
// reconstruction adjoints (`rot_relax_bwd`).
//
// Same arithmetic as mrphy_tpu's `_rot_relax_planes` and the step of
// `_rfgr_bwd_kernel` / `_beff_bwd_kernel` (mrphy_tpu/ops/pallas_kernels.py),
// except that sin/cos come from the CUDA math library (sincosf / sincos,
// full range reduction; no fast-math intrinsics) instead of the TPU's
// polynomial `_fast_sincos`.
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

// One reverse step of the reconstruction adjoint. In: the state m₁ after
// the step, the cotangent h₁ = ∂L/∂m₁, the field b, and the hoisted
// inverses iE2 = 1/E2, iE1 = 1/E1. Out: m₀ (the state before the step) in
// (mx, my, mz), h₀ = ∂L/∂m₀ in (hx, hy, hz), and ∂L/∂b in (dbx, dby, dbz):
//   m̃ = ((m₁x, m₁y)·iE2, (m₁z + e1_1)·iE1)   (undo relaxation), h̃ = E∘h₁;
//   m₀ = Rᵀm̃, h₀ = Rᵀh̃ (rotation by +ϕ; uᵀm̃ == uᵀm₀);
//   ∂L/∂b = −s/ϕ·(m₀×h̃) − (c−1)/ϕ·((uᵀh̃)m₀ + (uᵀm₀)h̃) + K·u,
//   K = (s/ϕ − c)·uᵀ(m₀×h̃) + (2(c−1)/ϕ + s)(uᵀm₀)(uᵀh̃) − s·h̃ᵀm₀.
// The order of operations is that of the plain version
// (kernels/bloch.py, `_rot_relax_bwd`).
template <typename T>
__device__ __forceinline__ void rot_relax_bwd(T& mx, T& my, T& mz, T& hx,
                                              T& hy, T& hz, T bx, T by, T bz,
                                              bool relax, T E2, T E1, T e1_1,
                                              T iE2, T iE1, T& dbx, T& dby,
                                              T& dbz) {
  T n2 = bx * bx + by * by + bz * bz;
  n2 = n2 > phi_eps2<T>() ? n2 : phi_eps2<T>();
  const T inv = rsqrt_(n2);
  const T phi = n2 * inv;
  const T ux = bx * inv, uy = by * inv, uz = bz * inv;
  T s, c;
  sin_cos(phi, &s, &c);
  const T c1 = c - T(1);
  T mtx = mx, mty = my, mtz = mz, htx = hx, hty = hy, htz = hz;
  if (relax) {
    mtx = mx * iE2;
    mty = my * iE2;
    mtz = (mz + e1_1) * iE1;
    htx = hx * E2;
    hty = hy * E2;
    htz = hz * E1;
  }
  const T utm = ux * mtx + uy * mty + uz * mtz;
  const T m0x = mtx + s * (uy * mtz - uz * mty) + c1 * (mtx - utm * ux);
  const T m0y = mty + s * (uz * mtx - ux * mtz) + c1 * (mty - utm * uy);
  const T m0z = mtz + s * (ux * mty - uy * mtx) + c1 * (mtz - utm * uz);
  const T uth = ux * htx + uy * hty + uz * htz;
  const T uxhx = uy * htz - uz * hty;
  const T uxhy = uz * htx - ux * htz;
  const T uxhz = ux * hty - uy * htx;
  hx = htx + s * uxhx + c1 * (htx - uth * ux);
  hy = hty + s * uxhy + c1 * (hty - uth * uy);
  hz = htz + s * uxhz + c1 * (htz - uth * uz);
  const T sp = s * inv, c1p = c1 * inv;
  const T mxhx = m0y * htz - m0z * hty;
  const T mxhy = m0z * htx - m0x * htz;
  const T mxhz = m0x * hty - m0y * htx;
  const T tt = ux * mxhx + uy * mxhy + uz * mxhz;
  const T hm = htx * m0x + hty * m0y + htz * m0z;
  const T k = (sp - c) * tt + (T(2) * c1p + s) * utm * uth - s * hm;
  dbx = -sp * mxhx - c1p * (uth * m0x + utm * htx) + k * ux;
  dby = -sp * mxhy - c1p * (uth * m0y + utm * hty) + k * uy;
  dbz = -sp * mxhz - c1p * (uth * m0z + utm * htz) + k * uz;
  mx = m0x;
  my = m0y;
  mz = m0z;
}

// Sum over the 32 lanes of a warp; every lane must call it. The result is
// valid in lane 0.
template <typename T> __device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace mrphy
