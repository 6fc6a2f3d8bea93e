// nufft_spread: the spread (type-1 interpolation) of the gridding NUFFT on
// Hopper (sm_90a), the exact transpose of nufft_sample.
//
// Replaces the TPU kernel `_adj3d_kernel` (launched by `scatter3d`,
// mrphy_tpu/ops/nufft_pallas.py; its wrap-pad folding `fold_grid3d` is not
// needed: the taps are wrapped here), and serves D = 1, 2 and 3. For every
// sample t of batch entry n and each of its W^D taps:
//   grid[n, tap] += ((w_0·w_1)·w_2)(k_t) · s[n, t]        (re and im)
// into a grid the wrapper zeroes.
//
// What bounds it on the H100: the atomics. Each sample issues 2·W^D
// atomic adds to device memory (resolved in L2). Where many samples meet
// the same grid points they serialise: every spoke of a koosh-ball
// trajectory passes through k = 0, so thousands of samples add into the
// few dozen points around the centre.
//
// Design: the simplest correct one. One thread per sample, grid
// (ceil(nT/256), N); the thread computes its taps and weights as
// nufft_sample does and adds w·s_re, w·s_im with atomicAdd (float and
// double both exist on sm_90). The order of the sums changes from run to
// run, so the grid matches the plain version (`index_add_`) to rounding,
// not bit for bit. A deterministic or shared-memory-binned spread (samples
// sorted into tiles, each tile spread in shared memory and added once) is
// later work. Templated on the scalar type, D and the width
// (nufft_common.cuh).
#include "nufft_common.cuh"

namespace mrphy_nufft {

template <typename T, int D, int KW>
__global__ void __launch_bounds__(kThreads)
nufft_spread_kernel(const T* __restrict__ s, const T* __restrict__ k,
                    int64_t k_bs, T* __restrict__ grid, int64_t nT,
                    int64_t nG, int width, Geo<T> g) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= nT) return;
  const int64_t n = blockIdx.y;
  Taps<T, D, KW> tp;
  taps_of<T, D, KW, false>(tp, k + n * k_bs, t, nT, width, g);
  const T sr = s[(n * nT + t) * 2], si = s[(n * nT + t) * 2 + 1];
  T* gr = grid + n * nG * 2;
  for_taps<T, D, KW>(tp, g, [&](int64_t i, int a, int b, int c) {
    const T w = weight<T, D, KW>(tp, a, b, c, -1);
    atomicAdd(gr + 2 * i, w * sr);
    atomicAdd(gr + 2 * i + 1, w * si);
  });
}

template <typename T>
int launch_spread(const void* s, const void* k, void* grid,
                  const double* geo, int64_t k_bs, int64_t N, int64_t nT,
                  int64_t D, int64_t W, void* stream) {
  dim3 blocks;
  if (!grid_of(N, nT, blocks)) return (int)cudaErrorInvalidValue;
  const Geo<T> g = geo_of<T>(geo);
  int64_t nG = 1;
  for (int a = 0; a < D && a < 3; ++a) nG *= g.G[a];
  return dispatch(D, W, [&](auto d, auto w) {
    constexpr int DD = decltype(d)::value, KW = decltype(w)::value;
    nufft_spread_kernel<T, DD, KW>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            (const T*)s, (const T*)k, k_bs, (T*)grid, nT, nG, (int)W, g);
    return (int)cudaGetLastError();
  });
}

}  // namespace mrphy_nufft

// s (N, nT, 2), k (Nk, D, nT), grid (N, ΠG, 2) zeroed by the caller; geo
// and k_bs as nufft_sample's. Returns the cudaError_t of the launch.
#define MRPHY_NUFFT_SPREAD_ENTRY(NAME, T)                                   \
  extern "C" int NAME(const void* s, const void* k, void* grid,            \
                      const void* geo, int64_t k_bs, int64_t N,            \
                      int64_t nT, int64_t D, int64_t W, void* stream) {    \
    return mrphy_nufft::launch_spread<T>(s, k, grid, (const double*)geo,   \
                                         k_bs, N, nT, D, W, stream);       \
  }

MRPHY_NUFFT_SPREAD_ENTRY(mrphy_nufft_spread_f32, float)
MRPHY_NUFFT_SPREAD_ENTRY(mrphy_nufft_spread_f64, double)
