// nufft_sample: the type-2 interpolation of the gridding NUFFT on Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_fwd3d_kernel` (launched by `sample3d`,
// mrphy_tpu/ops/nufft_pallas.py), and serves D = 1, 2 and 3. For every
// sample t of batch entry n:
//   out[n, t] = Σ_taps ((w_0·w_1)·w_2)(k_t) · grid[n, tap]
// over the W^D Kaiser–Bessel taps of nufft_common.cuh, re and im.
//
// What bounds it on the H100: the gather. Each sample reads W^D grid points
// of 8 (16) bytes, W^(D−1) rows of W contiguous points; a sample's taps
// overlap its neighbours' on the trajectory, so most reads hit L1/L2 (at a
// 192³ grid the spectrum, 57 MB in float32, is just above the 50 MB L2).
// The arithmetic is D·W weights (a polynomial, and exp and sqrt past the
// I₀ branch point) and 2·W^D multiply-adds.
//
// Design: one thread per sample, grid (ceil(nT/256), N). The TPU kernel's
// wrap-padding of the grid, its one-hot lane rows and its SMEM layout
// answer TPU limits (no dynamic lane offsets, no vector gather) and are not
// carried: the thread computes its taps' wrapped indices and weights in
// registers and loads each grid point as one float2/double2 through the
// read-only cache. Taps are summed one by one in the plain version's order
// (separate multiply and add under -fmad=false). Templated on the
// scalar type, D and the width (nufft_common.cuh).
#include "nufft_common.cuh"

namespace mrphy_nufft {

template <typename T, int D, int KW>
__global__ void __launch_bounds__(kThreads)
nufft_sample_kernel(const T* __restrict__ grid, const T* __restrict__ k,
                    int64_t k_bs, T* __restrict__ out, int64_t nT,
                    int64_t nG, int width, Geo<T> g) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= nT) return;
  const int64_t n = blockIdx.y;
  Taps<T, D, KW> tp;
  taps_of<T, D, KW, false>(tp, k + n * k_bs, t, nT, width, g);
  const T* gr = grid + n * nG * 2;
  T ar = T(0), ai = T(0);
  for_taps<T, D, KW>(tp, g, [&](int64_t i, int a, int b, int c) {
    const T w = weight<T, D, KW>(tp, a, b, c, -1);
    const auto v = ld2(gr, i);
    ar = ar + v.x * w;
    ai = ai + v.y * w;
  });
  out[(n * nT + t) * 2] = ar;
  out[(n * nT + t) * 2 + 1] = ai;
}

template <typename T>
int launch_sample(const void* grid, const void* k, void* out,
                  const double* geo, int64_t k_bs, int64_t N, int64_t nT,
                  int64_t D, int64_t W, void* stream) {
  dim3 blocks;
  if (!grid_of(N, nT, blocks)) return (int)cudaErrorInvalidValue;
  const Geo<T> g = geo_of<T>(geo);
  int64_t nG = 1;
  for (int a = 0; a < D && a < 3; ++a) nG *= g.G[a];
  return dispatch(D, W, [&](auto d, auto w) {
    constexpr int DD = decltype(d)::value, KW = decltype(w)::value;
    nufft_sample_kernel<T, DD, KW>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            (const T*)grid, (const T*)k, k_bs, (T*)out, nT, nG, (int)W, g);
    return (int)cudaGetLastError();
  });
}

}  // namespace mrphy_nufft

// grid (N, ΠG, 2), k (Nk, D, nT), out (N, nT, 2); geo: the 17 doubles of
// kernels/nufft.py `Geom.consts` (host memory); k_bs: k's batch stride (0:
// shared). Returns the cudaError_t of the launch.
#define MRPHY_NUFFT_SAMPLE_ENTRY(NAME, T)                                   \
  extern "C" int NAME(const void* grid, const void* k, void* out,          \
                      const void* geo, int64_t k_bs, int64_t N,            \
                      int64_t nT, int64_t D, int64_t W, void* stream) {    \
    return mrphy_nufft::launch_sample<T>(grid, k, out, (const double*)geo, \
                                         k_bs, N, nT, D, W, stream);       \
  }

MRPHY_NUFFT_SAMPLE_ENTRY(mrphy_nufft_sample_f32, float)
MRPHY_NUFFT_SAMPLE_ENTRY(mrphy_nufft_sample_f64, double)
