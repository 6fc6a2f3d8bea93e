// Shared by the gridding NUFFT kernels (nufft_sample.cu, nufft_spread.cu,
// nufft_dk.cu): the geometry, the Kaiser–Bessel taps of one sample, the
// walk over its W^D taps, and the dispatch over (D, W).
//
// Widths: W = 4, 5 and 6 (those of every caller in the repo) each have an
// instance of their own, whose walk over the taps is unrolled; every other
// width in 2..kMaxW runs through one instance (KW = 0) that takes W at run
// time over arrays of kMaxW taps, with the same operations in the same
// order, so the same results.
//
// Taps (kernels/nufft.py `_axis`, JAX's `_coords`): per axis a the sample
// sits at v = (k·fov_a)·(G_a/n_a) grid units; its taps are base + j, j < W,
// with base = floor(v − W/2) + 1, wrapped mod G_a, and weights
// φ(v − tap) = I₀(β√(1 − q²))·(1/I₀(β)), q = (v − tap)·(2/W), zero where
// 1 − q² ≤ 0. I₀ is the Abramowitz–Stegun 9.8.1/9.8.2 polynomial pair (the
// JAX package's, not the library's); its derivative is written out (Horner
// in the coefficients j·c_j). dφ/dk = (I₀'(x)·β)·((v − tap)·(−4/W²))/√(1 −
// q²)·(1/I₀(β))·(fov·G/n), zero where 1 − q² ≤ 1e-12. Separable weights
// multiply as (w_0·w_1)·w_2, axis 0 outermost. Every operation is written
// in the order of the plain versions, every division by a constant as a
// product with its reciprocal; built with -fmad=false (kernels/_build.py),
// a kernel's weights, products and tap sums round exactly as its plain
// version's.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace mrphy_nufft {

constexpr int kThreads = 256;  // threads per block: one sample each
constexpr int kMaxW = 8;       // the widest kernel taken

__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

// One re/im grid point (8 or 16 bytes, one load).
__device__ __forceinline__ float2 ld2(const float* p, int64_t i) {
  return __ldg(reinterpret_cast<const float2*>(p) + i);
}
__device__ __forceinline__ double2 ld2(const double* p, int64_t i) {
  return __ldg(reinterpret_cast<const double2*>(p) + i);
}

// The geometry in the working type (from the 17 doubles of kernels/nufft.py
// `Geom.consts`): per axis G, fov, G/n, fov·G/n; W/2, 2/W, −4/W², β,
// 1/I₀(β).
template <typename T>
struct Geo {
  int64_t G[3];
  T fov[3], scl[3], chain[3];
  T half, two_w, dk_c, beta, inv;
};

template <typename T>
__host__ Geo<T> geo_of(const double* c) {
  Geo<T> g;
  for (int a = 0; a < 3; ++a) {
    g.G[a] = (int64_t)c[a];
    g.fov[a] = (T)c[3 + a];
    g.scl[a] = (T)c[6 + a];
    g.chain[a] = (T)c[9 + a];
  }
  g.half = (T)c[12];
  g.two_w = (T)c[13];
  g.dk_c = (T)c[14];
  g.beta = (T)c[15];
  g.inv = (T)c[16];
  return g;
}

// c0 + x·(c1 + x·(… + x·cn)), innermost first (kernels/nufft.py `_horner`).
template <typename T>
__device__ __forceinline__ T horner_tail(T x, double c) {
  return x * T(c);
}
template <typename T, typename... R>
__device__ __forceinline__ T horner_tail(T x, double c, R... r) {
  return (horner_tail(x, r...) + T(c)) * x;
}
template <typename T, typename... R>
__device__ __forceinline__ T horner(T x, double c0, R... r) {
  return horner_tail(x, r...) + T(c0);
}

// I₀(x) and (kDeriv) dI₀/dx for x ≥ 0 (kernels/nufft.py `_i0`).
template <typename T, bool kDeriv>
__device__ __forceinline__ void i0_parts(T x, T& v, T& dv) {
  if (x < T(3.75)) {
    const T q = x * T(1.0 / 3.75);
    const T t = q * q;
    v = horner(t, 1.0, 3.5156229, 3.0899424, 1.2067492, 0.2659732,
               0.0360768, 0.0045813);
    if (kDeriv)
      dv = horner(t, 1 * 3.5156229, 2 * 3.0899424, 3 * 1.2067492,
                  4 * 0.2659732, 5 * 0.0360768, 6 * 0.0045813) *
           (q * T(2.0 / 3.75));
  } else {
    const T r = T(1) / x;
    const T u = r * T(3.75);
    const T E = exp_(x) / sqrt_(x);
    const T Q = horner(u, 0.39894228, 0.01328592, 0.00225319, -0.00157565,
                       0.00916281, -0.02057706, 0.02635537, -0.01647633,
                       0.00392377);
    v = E * Q;
    if (kDeriv)
      dv = E * ((T(1) - r * T(0.5)) * Q -
                (u * r) * horner(u, 1 * 0.01328592, 2 * 0.00225319,
                                 3 * -0.00157565, 4 * 0.00916281,
                                 5 * -0.02057706, 6 * 0.02635537,
                                 7 * -0.01647633, 8 * 0.00392377));
  }
}

// The taps of one sample: per axis the wrapped indices, weights and
// (kDeriv) weight derivatives w.r.t. k_a, and the width. KW > 0: the
// width, a constant; KW = 0: the width W ≤ kMaxW given at run time.
template <typename T, int D, int KW>
struct Taps {
  static constexpr int kCap = KW > 0 ? KW : kMaxW;
  int32_t idx[D][kCap];
  T w[D][kCap];
  T wd[D][kCap];
  int W;
};

template <typename T, int D, int KW, bool kDeriv>
__device__ __forceinline__ void taps_of(Taps<T, D, KW>& tp, const T* k,
                                        int64_t t, int64_t nT, int width,
                                        const Geo<T>& g) {
  const int W = KW > 0 ? KW : width;
  tp.W = W;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const T v = (k[a * nT + t] * g.fov[a]) * g.scl[a];
    const T base = floor_(v - g.half) + T(1);
    const int64_t G = g.G[a];
    int64_t m = (int64_t)base % G;
    if (m < 0) m += G;
#pragma unroll (KW > 0 ? KW : 1)
    for (int j = 0; j < W; ++j) {
      const T delta = v - (base + T(j));
      tp.idx[a][j] = (int32_t)((m + j) % G);
      const T q = delta * g.two_w;
      const T arg = T(1) - q * q;
      T w = T(0), wd = T(0);
      if (arg > T(0)) {
        const T s = sqrt_(arg);
        T i0, i0p;
        i0_parts<T, kDeriv>(s * g.beta, i0, i0p);
        w = i0 * g.inv;
        if (kDeriv && arg > T(1e-12)) {
          const T d = ((i0p * g.beta) * (delta * g.dk_c)) / s;
          wd = (d * g.inv) * g.chain[a];
        }
      }
      tp.w[a][j] = w;
      if (kDeriv) tp.wd[a][j] = wd;
    }
  }
}

// Calls f(flat grid index, a, b, c) for every tap in the plain versions'
// order (axis 0 outermost; a, b, c the tap numbers on axes 0, 1, 2, −1
// past D), the flat index ((i_0·G_1) + i_1)·G_2 + i_2.
template <typename T, int D, int KW, typename F>
__device__ __forceinline__ void for_taps(const Taps<T, D, KW>& tp,
                                         const Geo<T>& g, F&& f) {
  const int W = KW > 0 ? KW : tp.W;
  if constexpr (D == 1) {
#pragma unroll (KW > 0 ? KW : 1)
    for (int a = 0; a < W; ++a) f((int64_t)tp.idx[0][a], a, -1, -1);
  } else if constexpr (D == 2) {
#pragma unroll (KW > 0 ? KW : 1)
    for (int a = 0; a < W; ++a) {
      const int64_t ra = (int64_t)tp.idx[0][a] * g.G[1];
#pragma unroll (KW > 0 ? KW : 1)
      for (int b = 0; b < W; ++b) f(ra + tp.idx[1][b], a, b, -1);
    }
  } else {
#pragma unroll (KW > 0 ? KW : 1)
    for (int a = 0; a < W; ++a) {
      const int64_t ra = (int64_t)tp.idx[0][a] * g.G[1];
#pragma unroll (KW > 0 ? KW : 1)
      for (int b = 0; b < W; ++b) {
        const int64_t rb = (ra + tp.idx[1][b]) * g.G[2];
#pragma unroll (KW > 0 ? KW : 1)
        for (int c = 0; c < W; ++c) f(rb + tp.idx[2][c], a, b, c);
      }
    }
  }
}

// The product weight of tap (a, b, c) with axis `da`'s table replaced by
// its derivative (da < 0: the weights themselves): (w_0·w_1)·w_2.
template <typename T, int D, int KW>
__device__ __forceinline__ T weight(const Taps<T, D, KW>& tp, int a, int b,
                                    int c, int da) {
  const T w0 = da == 0 ? tp.wd[0][a] : tp.w[0][a];
  if constexpr (D == 1) {
    return w0;
  } else {
    const T w1 = da == 1 ? tp.wd[1][b] : tp.w[1][b];
    if constexpr (D == 2) {
      return w0 * w1;
    } else {
      const T w2 = da == 2 ? tp.wd[2][c] : tp.w[2][c];
      return (w0 * w1) * w2;
    }
  }
}

// Calls f(IntC<D>, IntC<KW>) for run-time (D, W): KW = W for W in 4..6,
// KW = 0 for the other widths in 2..kMaxW; anything else is refused.
template <int V>
struct IntC {
  static constexpr int value = V;
};

template <int D, typename F>
__host__ int dispatch_w(int W, F&& f) {
  switch (W) {
    case 4: return f(IntC<D>{}, IntC<4>{});
    case 5: return f(IntC<D>{}, IntC<5>{});
    case 6: return f(IntC<D>{}, IntC<6>{});
    default:
      if (W < 2 || W > kMaxW) return (int)cudaErrorInvalidValue;
      return f(IntC<D>{}, IntC<0>{});
  }
}

template <typename F>
__host__ int dispatch(int64_t D, int64_t W, F&& f) {
  switch (D) {
    case 1: return dispatch_w<1>((int)W, f);
    case 2: return dispatch_w<2>((int)W, f);
    case 3: return dispatch_w<3>((int)W, f);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch grid: one thread per sample, blockIdx.y the batch entry.
__host__ inline bool grid_of(int64_t N, int64_t nT, dim3& grid) {
  if (N <= 0 || N > 65535 || nT <= 0) return false;
  const int64_t nb = (nT + kThreads - 1) / kThreads;
  if (nb > 2147483647LL) return false;
  grid = dim3((unsigned)nb, (unsigned)N);
  return true;
}

}  // namespace mrphy_nufft
