// One two-pool Bloch–McConnell step, shared by mc_fwd and the forward
// recompute of mc_bwd (so the adjoint's stored states are exactly the
// forward's): the field of the step from the staged waveforms and the
// voxel's fields, pool a rotated about it, pool b about it plus ẑ·sb, then
// the exact exchange/relaxation mix
//   [a⊥, b⊥] ← X·[a⊥, b⊥],  [az, bz] ← Z·[az, bz] + (ca, cb).
// The order of operations is that of the plain version
// (kernels/mc.py, `_mc_step` and bloch.py `_rfgr_field`).
#pragma once

#include <type_traits>

#include "bloch_step.cuh"

namespace mrphy {

// Stage steps [t0, t0 + len) of one batch's waveforms into shared memory
// `wf`, rows [rf x coils…, rf y coils…, gx, gy, gz] of `stride` values:
// the whole block, coalesced. The caller brackets it with barriers.
template <typename T>
__device__ __forceinline__ void stage_waveforms(T* wf, int stride,
                                                const T* rf_n, const T* gr_n,
                                                int nR, int64_t nT,
                                                int64_t t0, int len) {
  for (int i = threadIdx.x; i < (nR + 3) * len; i += blockDim.x) {
    const int k = i / len, tt = i - k * len;
    wf[k * stride + tt] =
        k < nR ? rf_n[k * nT + t0 + tt] : gr_n[(k - nR) * nT + t0 + tt];
  }
}

// A voxel's constants for the whole pulse: location, Δf and γ2πdt (all
// pre-scaled to radians), pool b's offset sb, the ten propagator planes,
// and its B1 row: for MAXC > 0 (C ≤ MAXC coils) in registers, for
// MAXC == 0 (any C) read from device memory at every step.
template <typename T, int MAXC>
struct McVoxel {
  static constexpr int kRegC = MAXC > 0 ? MAXC : 1;
  T lx = 0, ly = 0, lz = 0, d = 0, g = 0, sb = 0;
  T X00 = 0, X01 = 0, X10 = 0, X11 = 0;
  T Z00 = 0, Z01 = 0, Z10 = 0, Z11 = 0, ca = 0, cb = 0;
  T b1x[kRegC] = {}, b1y[kRegC] = {};  // 0 past the edge (rows add 0)
  const T* b1_s = nullptr;  // MAXC == 0: row r at b1_s[r * nS]
  int64_t nS = 0;
  int nC = 1;
  bool has_dfg = false, has_b1 = false;

  // Inputs as in the entry points; (n, s) is the voxel, which must exist.
  __device__ __forceinline__ void load(const T* loc, const T* dfg,
                                       const T* b1, const T* g2pd,
                                       const T* sbp, const T* X, const T* Z,
                                       int64_t n, int64_t s, int64_t nS_,
                                       int nC_) {
    nS = nS_;
    nC = nC_;
    has_dfg = dfg != nullptr;
    has_b1 = b1 != nullptr;
    const int64_t p1 = n * nS + s;
    const int64_t p3 = n * 3 * nS + s;
    lx = loc[p3];
    ly = loc[p3 + nS];
    lz = loc[p3 + 2 * nS];
    if (has_dfg) d = dfg[p1];
    g = g2pd[p1];
    sb = sbp[p1];
    const T* x = X + n * 4 * nS + s;
    X00 = x[0];
    X01 = x[nS];
    X10 = x[2 * nS];
    X11 = x[3 * nS];
    const T* z = Z + n * 6 * nS + s;
    Z00 = z[0];
    Z01 = z[nS];
    Z10 = z[2 * nS];
    Z11 = z[3 * nS];
    ca = z[4 * nS];
    cb = z[5 * nS];
    if (has_b1) {
      b1_s = b1 + n * 2 * nC * nS + s;
      if constexpr (MAXC > 0) {
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (c < nC) {
            b1x[c] = b1_s[c * nS];
            b1y[c] = b1_s[(nC + c) * nS];
          }
      }
    }
  }

  // Coil c's term of the transverse field: B1 (qx, qy) times rf.
  __device__ __forceinline__ void add_coil(const T* wf, int stride, int tt,
                                           int c, T qx, T qy, T& bx,
                                           T& by) const {
    const T rx = wf[c * stride + tt], ry = wf[(nC + c) * stride + tt];
    bx = bx + (qx * rx - qy * ry);
    by = by + (qx * ry + qy * rx);
  }

  // The field of staged step tt (waveform rows of `stride` values in wf).
  __device__ __forceinline__ void field(const T* wf, int stride, int tt,
                                        T& bx, T& by, T& bz) const {
    const T* w_gr = wf + 2 * nC * stride;
    bz = w_gr[tt] * lx + w_gr[stride + tt] * ly + w_gr[2 * stride + tt] * lz;
    if (has_dfg) bz = bz + d;
    if (has_b1) {
      bx = 0;
      by = 0;
      if constexpr (MAXC > 0) {
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (c < nC) add_coil(wf, stride, tt, c, b1x[c], b1y[c], bx, by);
      } else {
        for (int c = 0; c < nC; ++c)
          add_coil(wf, stride, tt, c, b1_s[c * nS], b1_s[(nC + c) * nS], bx,
                   by);
      }
    } else {
      T rx = wf[tt], ry = wf[nC * stride + tt];
      for (int c = 1; c < nC; ++c) {
        rx = rx + wf[c * stride + tt];
        ry = ry + wf[(nC + c) * stride + tt];
      }
      bx = g * rx;
      by = g * ry;
    }
  }

  // One step of the state m = [ax, ay, az, bx, by, bz] in the field b.
  __device__ __forceinline__ void step(T (&m)[6], T bx, T by, T bz) const {
    T ax = m[0], ay = m[1], az = m[2], qx = m[3], qy = m[4], qz = m[5];
    rot_relax(ax, ay, az, bx, by, bz, false, T(1), T(1), T(0));
    rot_relax(qx, qy, qz, bx, by, bz + sb, false, T(1), T(1), T(0));
    m[0] = X00 * ax + X01 * qx;
    m[1] = X00 * ay + X01 * qy;
    m[2] = Z00 * az + Z01 * qz + ca;
    m[3] = X10 * ax + X11 * qx;
    m[4] = X10 * ay + X11 * qy;
    m[5] = Z10 * az + Z11 * qz + cb;
  }
};

// Launch `launch<MAXC>()` with the smallest register instance MAXC ∈ {1,
// 2, 4, 8} that holds C coils of B1 (without B1 any C takes 1), else the
// device-memory instance MAXC = 0.
template <typename F>
int dispatch_coils(bool has_b1, int64_t nC, F&& launch) {
  const int64_t c = has_b1 ? nC : 1;
  if (c <= 1) return launch(std::integral_constant<int, 1>{});
  if (c <= 2) return launch(std::integral_constant<int, 2>{});
  if (c <= 4) return launch(std::integral_constant<int, 4>{});
  if (c <= 8) return launch(std::integral_constant<int, 8>{});
  return launch(std::integral_constant<int, 0>{});
}

}  // namespace mrphy
