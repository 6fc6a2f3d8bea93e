// One Bloch step shared by the kernels: rotation by the field impulse b
// (radians) about u = b/|b|, then T1/T2 relaxation (`rot_relax`, the
// forward kernels), the same step run backwards for the reconstruction
// adjoints (`rot_relax_bwd`), and a rotation's adjoint from its stored
// input (`rot_adj`, the two-pool adjoint); the last two share
// `rot_adj_tail`.
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

// The rotation by the field impulse b (radians): axis u = b/|b|,
// inv = 1/ϕ, s, c = sin ϕ, cos ϕ, c1 = c − 1.
template <typename T>
struct Rotation {
  T ux, uy, uz, inv, s, c, c1;
};

template <typename T>
__device__ __forceinline__ Rotation<T> rotation_of(T bx, T by, T bz) {
  T n2 = bx * bx + by * by + bz * bz;
  n2 = n2 > phi_eps2<T>() ? n2 : phi_eps2<T>();
  Rotation<T> r;
  r.inv = rsqrt_(n2);
  const T phi = n2 * r.inv;
  r.ux = bx * r.inv;
  r.uy = by * r.inv;
  r.uz = bz * r.inv;
  sin_cos(phi, &r.s, &r.c);
  r.c1 = r.c - T(1);
  return r;
}

// m ← m − s·(u×m) + (c−1)·(m − (uᵀm)·u), in place; returns uᵀm (which
// the rotation keeps). With s = −sin ϕ it rotates back: a − (−s)·x rounds
// exactly as a + s·x.
template <typename T>
__device__ __forceinline__ T rodrigues(const Rotation<T>& r, T s, T& mx,
                                       T& my, T& mz) {
  const T utm = r.ux * mx + r.uy * my + r.uz * mz;
  const T m1x = mx - s * (r.uy * mz - r.uz * my) + r.c1 * (mx - utm * r.ux);
  const T m1y = my - s * (r.uz * mx - r.ux * mz) + r.c1 * (my - utm * r.uy);
  const T m1z = mz - s * (r.ux * my - r.uy * mx) + r.c1 * (mz - utm * r.uz);
  mx = m1x;
  my = m1y;
  mz = m1z;
  return utm;
}

// m₁ = m − s·(u×m) + (c−1)·(m − (uᵀm)·u);  relaxed: (E2·m₁x, E2·m₁y,
// E1·m₁z − (E1−1)).  Updates (mx, my, mz) in place.
template <typename T>
__device__ __forceinline__ void rot_relax(T& mx, T& my, T& mz, T bx, T by,
                                          T bz, bool relax, T E2, T E1,
                                          T e1_1) {
  const Rotation<T> r = rotation_of(bx, by, bz);
  rodrigues(r, r.s, mx, my, mz);
  if (relax) {
    mx *= E2;
    my *= E2;
    mz = mz * E1 - e1_1;
  }
}

// The adjoint of the rotation r, given its input m₀, utm = uᵀm₀ and the
// cotangent h at its output: h becomes h₀ = Rᵀh (rotation by +ϕ) in
// place, and
//   ∂L/∂b = −s/ϕ·(m₀×h) − (c−1)/ϕ·((uᵀh)m₀ + (uᵀm₀)h) + K·u,
//   K = (s/ϕ − c)·uᵀ(m₀×h) + (2(c−1)/ϕ + s)(uᵀm₀)(uᵀh) − s·hᵀm₀.
// The order of operations is that of the plain version (kernels/bloch.py,
// `_adj_tail`).
template <typename T>
__device__ __forceinline__ void rot_adj_tail(const Rotation<T>& r, T utm,
                                             T m0x, T m0y, T m0z, T& hx,
                                             T& hy, T& hz, T& dbx, T& dby,
                                             T& dbz) {
  const T ux = r.ux, uy = r.uy, uz = r.uz, s = r.s, c = r.c, c1 = r.c1;
  const T htx = hx, hty = hy, htz = hz;
  const T uth = ux * htx + uy * hty + uz * htz;
  const T uxhx = uy * htz - uz * hty;
  const T uxhy = uz * htx - ux * htz;
  const T uxhz = ux * hty - uy * htx;
  hx = htx + s * uxhx + c1 * (htx - uth * ux);
  hy = hty + s * uxhy + c1 * (hty - uth * uy);
  hz = htz + s * uxhz + c1 * (htz - uth * uz);
  const T sp = s * r.inv, c1p = c1 * r.inv;
  const T mxhx = m0y * htz - m0z * hty;
  const T mxhy = m0z * htx - m0x * htz;
  const T mxhz = m0x * hty - m0y * htx;
  const T tt = ux * mxhx + uy * mxhy + uz * mxhz;
  const T hm = htx * m0x + hty * m0y + htz * m0z;
  const T k = (sp - c) * tt + (T(2) * c1p + s) * utm * uth - s * hm;
  dbx = -sp * mxhx - c1p * (uth * m0x + utm * htx) + k * ux;
  dby = -sp * mxhy - c1p * (uth * m0y + utm * hty) + k * uy;
  dbz = -sp * mxhz - c1p * (uth * m0z + utm * htz) + k * uz;
}

// One reverse step of the reconstruction adjoint. In: the state m₁ after
// the step, the cotangent h₁ = ∂L/∂m₁, the field b, and the hoisted
// inverses iE2 = 1/E2, iE1 = 1/E1. Out: m₀ (the state before the step) in
// (mx, my, mz), h₀ = ∂L/∂m₀ in (hx, hy, hz), and ∂L/∂b in (dbx, dby, dbz):
//   m̃ = ((m₁x, m₁y)·iE2, (m₁z + e1_1)·iE1)   (undo relaxation), h̃ = E∘h₁;
//   m₀ = Rᵀm̃ (rotation by +ϕ; uᵀm̃ == uᵀm₀), then `rot_adj_tail` on h̃.
// The order of operations is that of the plain version
// (kernels/bloch.py, `_rot_relax_bwd`).
template <typename T>
__device__ __forceinline__ void rot_relax_bwd(T& mx, T& my, T& mz, T& hx,
                                              T& hy, T& hz, T bx, T by, T bz,
                                              bool relax, T E2, T E1, T e1_1,
                                              T iE2, T iE1, T& dbx, T& dby,
                                              T& dbz) {
  const Rotation<T> r = rotation_of(bx, by, bz);
  if (relax) {
    mx = mx * iE2;
    my = my * iE2;
    mz = (mz + e1_1) * iE1;
    hx = hx * E2;
    hy = hy * E2;
    hz = hz * E1;
  }
  const T utm = rodrigues(r, -r.s, mx, my, mz);
  rot_adj_tail(r, utm, mx, my, mz, hx, hy, hz, dbx, dby, dbz);
}

// One rotation's adjoint from its INPUT state m₀ (no inversion; the
// two-pool adjoint stores its states): rotates (mx, my, mz) = m₀ to m₁ in
// place, turns the cotangent (hx, hy, hz) at the output into h₀ = Rᵀh,
// and returns ∂L/∂b. The order of operations is that of the plain version
// (kernels/bloch.py, `_rot_adj`).
template <typename T>
__device__ __forceinline__ void rot_adj(T& mx, T& my, T& mz, T& hx, T& hy,
                                        T& hz, T bx, T by, T bz, T& dbx,
                                        T& dby, T& dbz) {
  const Rotation<T> r = rotation_of(bx, by, bz);
  const T m0x = mx, m0y = my, m0z = mz;
  const T utm = rodrigues(r, r.s, mx, my, mz);
  rot_adj_tail(r, utm, m0x, m0y, m0z, hx, hy, hz, dbx, dby, dbz);
}

// Sum over the 32 lanes of a warp; every lane must call it. The result is
// valid in lane 0.
template <typename T> __device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace mrphy
