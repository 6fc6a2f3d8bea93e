// nufft_dk: the trajectory cotangent of the gridding NUFFT's interpolation
// on Hopper (sm_90a).
//
// Replaces the TPU kernel `_dk3d_kernel` (launched by `dk3d`,
// mrphy_tpu/ops/nufft_pallas.py), and serves D = 1, 2 and 3. For every
// sample t of batch entry n:
//   Gv = g_re[n, t]·B_re[n, tap] + g_im[n, t]·B_im[n, tap]
//   dk[n, a, t] = Σ_taps (∂((w_0·w_1)·w_2)/∂k_a)(k_t) · Gv
// all D axes from one walk over the taps. By the symmetry of
// Σ_t w(k_t)·s_t ↔ Σ_g w·B it is the k-cotangent of both stages: for the
// sample stage B is the spectrum and g the sample cotangent; for the
// spread stage B is the grid cotangent and g the spread samples.
//
// What bounds it on the H100: as nufft_sample, the gather of W^D grid
// points per sample; it adds D·W weight derivatives and 3 products per
// tap and axis.
//
// Design: one thread per sample, grid (ceil(nT/256), N), the taps, weights
// and their derivatives (the chain factor fov·G/n included) in registers;
// Gv is formed once per tap and reduced against the D derivative products
// (axis a's weight table replaced by its derivative). The sums run in the
// plain version's tap order. Weights that vanish at the tap edge give 0,
// not NaN. Templated on the scalar type, D and the width
// (nufft_common.cuh).
#include "nufft_common.cuh"

namespace mrphy_nufft {

template <typename T, int D, int KW>
__global__ void __launch_bounds__(kThreads)
nufft_dk_kernel(const T* __restrict__ grid, const T* __restrict__ k,
                int64_t k_bs, const T* __restrict__ cot, T* __restrict__ dk,
                int64_t nT, int64_t nG, int width, Geo<T> g) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= nT) return;
  const int64_t n = blockIdx.y;
  Taps<T, D, KW> tp;
  taps_of<T, D, KW, true>(tp, k + n * k_bs, t, nT, width, g);
  const T cr = cot[(n * nT + t) * 2], ci = cot[(n * nT + t) * 2 + 1];
  const T* gr = grid + n * nG * 2;
  T acc[D];
#pragma unroll
  for (int a = 0; a < D; ++a) acc[a] = T(0);
  for_taps<T, D, KW>(tp, g, [&](int64_t i, int a, int b, int c) {
    const auto v = ld2(gr, i);
    const T Gv = cr * v.x + ci * v.y;
#pragma unroll
    for (int da = 0; da < D; ++da)
      acc[da] = acc[da] + weight<T, D, KW>(tp, a, b, c, da) * Gv;
  });
#pragma unroll
  for (int a = 0; a < D; ++a) dk[(n * D + a) * nT + t] = acc[a];
}

template <typename T>
int launch_dk(const void* grid, const void* k, const void* cot, void* dk,
              const double* geo, int64_t k_bs, int64_t N, int64_t nT,
              int64_t D, int64_t W, void* stream) {
  dim3 blocks;
  if (!grid_of(N, nT, blocks)) return (int)cudaErrorInvalidValue;
  const Geo<T> g = geo_of<T>(geo);
  int64_t nG = 1;
  for (int a = 0; a < D && a < 3; ++a) nG *= g.G[a];
  return dispatch(D, W, [&](auto d, auto w) {
    constexpr int DD = decltype(d)::value, KW = decltype(w)::value;
    nufft_dk_kernel<T, DD, KW>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            (const T*)grid, (const T*)k, k_bs, (const T*)cot, (T*)dk, nT,
            nG, (int)W, g);
    return (int)cudaGetLastError();
  });
}

}  // namespace mrphy_nufft

// grid (N, ΠG, 2), k (Nk, D, nT), cot (N, nT, 2), dk (N, D, nT); geo and
// k_bs as nufft_sample's. Returns the cudaError_t of the launch.
#define MRPHY_NUFFT_DK_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* grid, const void* k, const void* cot,    \
                      void* dk, const void* geo, int64_t k_bs, int64_t N,  \
                      int64_t nT, int64_t D, int64_t W, void* stream) {    \
    return mrphy_nufft::launch_dk<T>(grid, k, cot, dk, (const double*)geo, \
                                     k_bs, N, nT, D, W, stream);           \
  }

MRPHY_NUFFT_DK_ENTRY(mrphy_nufft_dk_f32, float)
MRPHY_NUFFT_DK_ENTRY(mrphy_nufft_dk_f64, double)
