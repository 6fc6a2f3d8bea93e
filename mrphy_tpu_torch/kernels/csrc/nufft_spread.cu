// nufft_spread: the spread (type-1 interpolation) of the gridding NUFFT on
// Hopper (sm_90a), the exact transpose of nufft_sample, as a deterministic
// binned spread: no atomics, the same grid from every launch.
//
// Replaces the TPU kernel `_adj3d_kernel` (launched by `scatter3d`,
// mrphy_tpu/ops/nufft_pallas.py), which adds the samples in order into a
// grid held whole in VMEM (its wrap-pad folding `fold_grid3d` is not
// needed: the taps are wrapped here), and serves D = 1, 2 and 3. For every
// sample t of batch entry n and each of its W^D taps:
//   grid[n, tap] += ((w_0·w_1)·w_2)(k_t) · s[n, t]        (re and im)
//
// What bounds it on the H100: device memory would allow ~0.03 ms at the
// recon3d plan (2.3M samples, W 4, a 192³ grid); what costs is where the
// taps meet. Summed by atomics in device memory, 2·W^D adds a sample
// serialise at the grid points that many samples share: every spoke of a
// koosh ball passes through k = 0. The H100 has no VMEM for the whole grid,
// and blocks run in no order, so the TPU kernel's in-order sum does not
// carry over.
//
// Design: cuFINUFFT's shared-memory method (Shih et al., 2021), made
// deterministic. The bin plan (kernels/nufft.py `bin_plan`) bins the
// samples by the grid tile (B_a points an axis: 8³ in 3-D, 16² in 2-D, 256
// in 1-D) that holds their first tap (nufft_bin_keys here), sorts them
// stably by bin (torch.sort) and finds each bin's start and subproblems
// (nufft_bin_offsets here): each bin, in sample order, is cut into
// subproblems of at most P samples,
// so the koosh ball's centre bins become many subproblems, not one block
// that runs alone. Then two kernels:
//  1. nufft_spread_bins_kernel: one warp per (subproblem, batch entry)
//     stages 32 samples at a time in shared memory (a sample a lane: its
//     taps' weights as taps_of computes them, its first tap's place in the
//     tile, its value) and spreads them in order into the bin's padded tile
//     ((B_a + W − 1) points an axis: 11³ = 1,331 at W 4) in shared memory:
//     sample after sample, the lanes take its W^D taps, each a distinct
//     point, and add w·s there. So each point sums its samples in sample
//     order from zero, with no atomics; the warp writes its tile to its slot
//     of a partial buffer.
//  2. nufft_spread_reduce_kernel: a thread per grid point sums the partials
//     that cover it (its own tile's, and the tiles before it on each axis
//     whose padding reaches it, the wrap at the grid's edges included) in a
//     fixed order: by bin, then by subproblem.
// Every sum runs in an order fixed by the trajectory alone, so the grid is
// bitwise the same from launch to launch; it matches the plain version
// (`index_add_`, samples in order) to rounding. Templated on the scalar
// type, D and the width (nufft_common.cuh).
#include "nufft_common.cuh"

namespace mrphy_nufft {

// The tiling (kernels/nufft.py `spread_tiles`, 12 int64s): per axis the
// tile B, the tiles nb = ⌈G/B⌉ and the padded tile Bp = B + W − 1 (1, 1, 1
// past D); the points of a padded tile, the bins Πnb and the subproblems'
// size P.
struct Tiles {
  int64_t B[3], nb[3], Bp[3];
  int64_t npts, nbins, P;
};

__host__ inline bool tiles_of(const int64_t* v, int64_t D, int64_t W,
                              const int64_t* G, Tiles& tl) {
  for (int a = 0; a < 3; ++a) {
    tl.B[a] = v[a];
    tl.nb[a] = v[3 + a];
    tl.Bp[a] = v[6 + a];
  }
  tl.npts = v[9];
  tl.nbins = v[10];
  tl.P = v[11];
  for (int a = 0; a < 3; ++a) {
    const int64_t Ga = a < D ? G[a] : 1;
    if (tl.B[a] < 1 || tl.nb[a] != (Ga + tl.B[a] - 1) / tl.B[a] ||
        tl.Bp[a] != (a < D ? tl.B[a] + W - 1 : 1) ||
        (tl.nb[a] > 1 && tl.B[a] < W - 1))
      return false;
  }
  return tl.npts == tl.Bp[0] * tl.Bp[1] * tl.Bp[2] &&
         tl.nbins == tl.nb[0] * tl.nb[1] * tl.nb[2] && tl.P >= 1 &&
         tl.nbins < 2147483647LL;
}

// The bin of each sample: the tile that holds its first tap on every axis
// (the first tap as taps_of computes it), row-major over the axes; int16
// keys where the bins fit (the sort then takes half the radix passes).
template <typename T, int D, typename K>
__global__ void __launch_bounds__(kThreads)
nufft_bin_keys_kernel(const T* __restrict__ k, int64_t k_bs,
                      K* __restrict__ keys, int64_t nT, Geo<T> g, Tiles tl) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= nT) return;
  const int64_t n = blockIdx.y;
  const T* kn = k + n * k_bs;
  int key = 0;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const T v = (kn[a * nT + t] * g.fov[a]) * g.scl[a];
    const T base = floor_(v - g.half) + T(1);
    const int64_t G = g.G[a];
    int64_t m = (int64_t)base % G;
    if (m < 0) m += G;
    key = key * (int)tl.nb[a] + (int)m / (int)tl.B[a];
  }
  keys[n * nT + t] = (K)key;
}

constexpr int kWarp = 32;  // the bins kernel's block: one warp

// The staged samples of a chunk of kWarp, a row each: the first tap's place
// in the tile on each axis (D ints, then pad), the weights (D·W), the value
// (2); rows of an odd stride, so the lanes' stores fall on distinct banks.
template <typename T, int D>
struct Stage {
  T* base;
  int stride;  // values a row
  int W;
  __device__ __forceinline__ int32_t* off(int q) const {
    return reinterpret_cast<int32_t*>(base + q * stride);
  }
  __device__ __forceinline__ T* w(int q, int a) const {
    return base + q * stride + kOffT + a * W;
  }
  __device__ __forceinline__ T* v(int q) const {
    return base + q * stride + kOffT + D * W;
  }
  // the offsets' room, in values
  static constexpr int kOffT = (D * 4 + sizeof(T) - 1) / sizeof(T);
  __host__ __device__ static int row(int W) {
    const int n = kOffT + D * W + 2;
    return n | 1;
  }
};

template <typename T, int D, int KW>
__global__ void __launch_bounds__(kWarp) nufft_spread_bins_kernel(
    const T* __restrict__ s, const T* __restrict__ k, int64_t k_bs,
    const int64_t* __restrict__ perm, const int32_t* __restrict__ bin_start,
    const int32_t* __restrict__ sub_first, T* __restrict__ part,
    int64_t nsub_max, int64_t nT, int width, Geo<T> g, Tiles tl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = KW > 0 ? KW : width;
  const int lane = threadIdx.x;
  const int64_t n = blockIdx.y, sub = blockIdx.x;
  // a trajectory per entry has its own plan rows; a shared one, row 0
  const int64_t r = k_bs ? n : 0;
  const int32_t* sf = sub_first + r * (tl.nbins + 1);
  const int32_t* bs = bin_start + r * (tl.nbins + 1);
  if (sub >= sf[tl.nbins]) return;  // past this row's subproblems
  // the bin b: sf[b] ≤ sub < sf[b + 1]
  int lo = 0, hi = (int)tl.nbins;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (sf[mid] <= sub)
      lo = mid;
    else
      hi = mid;
  }
  const int b = lo;
  const int64_t i0 = bs[b] + (sub - sf[b]) * tl.P;
  const int64_t i1 = min(i0 + tl.P, (int64_t)bs[b + 1]);
  int start[3];
  {
    int rest = b;
#pragma unroll
    for (int a = 2; a >= 0; --a) {
      start[a] = (rest % (int)tl.nb[a]) * (int)tl.B[a];
      rest /= (int)tl.nb[a];
    }
  }
  const int npts = (int)tl.npts;
  const int P1 = (int)tl.Bp[1], P2 = (int)tl.Bp[2];
  T* const tre = reinterpret_cast<T*>(smem_raw);
  T* const tim = tre + npts;
  const Stage<T, D> sg{tim + npts, Stage<T, D>::row(W), W};
  for (int e = lane; e < npts; e += kWarp) {
    tre[e] = T(0);
    tim[e] = T(0);
  }
  const T* kn = k + n * k_bs;
  const int64_t* pr = perm + r * nT;
  const int taps = D == 1 ? W : (D == 2 ? W * W : W * W * W);
  for (int64_t base = i0; base < i1; base += kWarp) {
    __syncwarp();  // the last chunk's samples are spread
    const int64_t i = base + lane;
    if (i < i1) {
      const int64_t t = pr[i];
      Taps<T, D, KW> tp;
      taps_of<T, D, KW, false>(tp, kn, t, nT, width, g);
      int32_t* off = sg.off(lane);
#pragma unroll
      for (int a = 0; a < D; ++a) {
        off[a] = (int32_t)(tp.idx[a][0] - start[a]);
        T* w = sg.w(lane, a);
#pragma unroll (KW > 0 ? KW : 1)
        for (int j = 0; j < W; ++j) w[j] = tp.w[a][j];
      }
      T* v = sg.v(lane);
      v[0] = s[(n * nT + t) * 2];
      v[1] = s[(n * nT + t) * 2 + 1];
    }
    __syncwarp();
    const int cnt = (int)min((int64_t)kWarp, i1 - base);
    for (int q = 0; q < cnt; ++q) {
      const int32_t* off = sg.off(q);
      const T* w0 = sg.w(q, 0);
      const T sr = sg.v(q)[0], si = sg.v(q)[1];
      // the lanes take the sample's taps, each a distinct point
      for (int u = lane; u < taps; u += kWarp) {
        int e;
        T w;
        if constexpr (D == 1) {
          w = w0[u];
          e = off[0] + u;
        } else if constexpr (D == 2) {
          const int a = u / W, c = u - a * W;
          w = w0[a] * sg.w(q, 1)[c];
          e = (off[0] + a) * P1 + (off[1] + c);
        } else {
          const int a = u / (W * W), bc = u - a * (W * W);
          const int bb = bc / W, c = bc - bb * W;
          // (w_0·w_1)·w_2, as the plain version's product weights
          w = (w0[a] * sg.w(q, 1)[bb]) * sg.w(q, 2)[c];
          e = ((off[0] + a) * P1 + (off[1] + bb)) * P2 + (off[2] + c);
        }
        tre[e] = tre[e] + w * sr;
        tim[e] = tim[e] + w * si;
      }
      __syncwarp();  // the next sample may add at the same points
    }
  }
  __syncwarp();
  T* const out = part + ((n * nsub_max + sub) * tl.npts) * 2;
  for (int e = lane; e < npts; e += kWarp) {
    out[2 * e] = tre[e];
    out[2 * e + 1] = tim[e];
  }
}

// One grid point of one batch entry: the sum of the partials that cover it.
// Per axis the candidate bins are the point's own tile and the one or two
// before it (with the wrap; at most nb distinct ones), each at every place
// j < Bp of its padded tile that lands on the point (j and j + G where a
// padded tile wraps onto itself); bins by axis 0 first, then each bin's
// subproblems in order. Index arithmetic in 32 bits (the wrapper bounds the
// grid), the divisions hoisted out of the loops.
template <typename T>
__global__ void __launch_bounds__(kThreads)
nufft_spread_reduce_kernel(const T* __restrict__ part,
                           const int32_t* __restrict__ sub_first,
                           T* __restrict__ grid, int64_t k_bs,
                           int64_t nsub_max, int64_t nG, Geo<T> g,
                           int64_t D, Tiles tl) {
  const int64_t gi = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (gi >= nG) return;
  const int64_t n = blockIdx.y;
  const int32_t* sf = sub_first + (k_bs ? n : 0) * (tl.nbins + 1);
  const T* pn = part + n * nsub_max * tl.npts * 2;
  const int npts = (int)tl.npts;
  const int G0 = (int)g.G[0], G1 = D > 1 ? (int)g.G[1] : 1,
            G2 = D > 2 ? (int)g.G[2] : 1;
  const int B0 = (int)tl.B[0], B1 = (int)tl.B[1], B2 = (int)tl.B[2];
  const int nb0 = (int)tl.nb[0], nb1 = (int)tl.nb[1], nb2 = (int)tl.nb[2];
  const int P0 = (int)tl.Bp[0], P1 = (int)tl.Bp[1], P2 = (int)tl.Bp[2];
  int rest = (int)gi;
  const int g2 = rest % G2;
  rest /= G2;
  const int g1 = rest % G1, g0 = rest / G1;
  const int bb0 = g0 / B0, bb1 = g1 / B1, bb2 = g2 / B2;
  const int dm0 = nb0 - 1 < 2 ? nb0 - 1 : 2, dm1 = nb1 - 1 < 2 ? nb1 - 1 : 2,
            dm2 = nb2 - 1 < 2 ? nb2 - 1 : 2;
  T ar = T(0), ai = T(0);
  for (int d0 = dm0; d0 >= 0; --d0) {
    const int b0 = bb0 - d0 < 0 ? bb0 - d0 + nb0 : bb0 - d0;
    int j0 = g0 - b0 * B0;
    for (j0 += j0 < 0 ? G0 : 0; j0 < P0; j0 += G0) {
      for (int d1 = dm1; d1 >= 0; --d1) {
        const int b1 = bb1 - d1 < 0 ? bb1 - d1 + nb1 : bb1 - d1;
        int j1 = g1 - b1 * B1;
        for (j1 += j1 < 0 ? G1 : 0; j1 < P1; j1 += G1) {
          for (int d2 = dm2; d2 >= 0; --d2) {
            const int b2 = bb2 - d2 < 0 ? bb2 - d2 + nb2 : bb2 - d2;
            int j2 = g2 - b2 * B2;
            for (j2 += j2 < 0 ? G2 : 0; j2 < P2; j2 += G2) {
              const int bin = (b0 * nb1 + b1) * nb2 + b2;
              const int loc = (j0 * P1 + j1) * P2 + j2;
              const int s1 = sf[bin + 1];
              for (int sb = sf[bin]; sb < s1; ++sb) {
                const auto v = ld2(pn, (int64_t)sb * npts + loc);
                ar = ar + v.x;
                ai = ai + v.y;
              }
            }
          }
        }
      }
    }
  }
  grid[(n * nG + gi) * 2] = ar;
  grid[(n * nG + gi) * 2 + 1] = ai;
}

// The bins' starts in the sorted keys skeys (Nk, nT) of each row:
// bin_start[b] is the first place whose key is b or more, nT past the
// last key; each entry is written by exactly one thread (the place where
// the key passes it, or the last place for the bins past the last key).
template <typename K>
__global__ void __launch_bounds__(kThreads)
nufft_bin_starts_kernel(const K* __restrict__ skeys,
                        int32_t* __restrict__ bin_start, int64_t nT,
                        int64_t nbins) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= nT) return;
  const K* kr = skeys + blockIdx.y * nT;
  int32_t* bs = bin_start + blockIdx.y * (nbins + 1);
  const int64_t key = kr[i], prev = i > 0 ? (int64_t)kr[i - 1] : -1;
  for (int64_t b = prev + 1; b <= key; ++b) bs[b] = (int32_t)i;
  if (i == nT - 1)
    for (int64_t b = key + 1; b <= nbins; ++b) bs[b] = (int32_t)nT;
}

// Each bin's first subproblem, one block a row: the exclusive sum of
// ⌈count/P⌉ over the bins, each thread summing its run of bins, the block
// adding the runs' sums in a fixed order (integers: every order is exact).
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kScanThreads)
nufft_sub_first_kernel(const int32_t* __restrict__ bin_start,
                       int32_t* __restrict__ sub_first, int64_t nbins,
                       int64_t P) {
  __shared__ int32_t sums[kScanThreads];
  const int32_t* bs = bin_start + blockIdx.x * (nbins + 1);
  int32_t* out = sub_first + blockIdx.x * (nbins + 1);
  const int tid = threadIdx.x;
  const int64_t run = (nbins + kScanThreads - 1) / kScanThreads;
  const int64_t b0 = tid * run, b1 = min(b0 + run, nbins);
  int32_t acc = 0;
  for (int64_t b = b0; b < b1; ++b)
    acc += (int32_t)((bs[b + 1] - bs[b] + P - 1) / P);
  sums[tid] = acc;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {
    const int32_t v = tid >= o ? sums[tid - o] : 0;
    __syncthreads();
    sums[tid] += v;
    __syncthreads();
  }
  int32_t at = tid > 0 ? sums[tid - 1] : 0;  // the subproblems before b0
  for (int64_t b = b0; b < b1; ++b) {
    out[b] = at;
    at += (int32_t)((bs[b + 1] - bs[b] + P - 1) / P);
  }
  if (tid == kScanThreads - 1) out[nbins] = sums[kScanThreads - 1];
}

template <typename T>
int launch_bin_keys(const void* k, void* keys, const double* geo,
                    const int64_t* tiles, int64_t k_bs, int64_t Nk,
                    int64_t nT, int64_t D, int64_t W, int64_t key_bytes,
                    void* stream) {
  dim3 blocks;
  if (!grid_of(Nk, nT, blocks) || D < 1 || D > 3 ||
      (key_bytes != 2 && key_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const Geo<T> g = geo_of<T>(geo);
  Tiles tl;
  if (!tiles_of(tiles, D, W, g.G, tl) ||
      (key_bytes == 2 && tl.nbins > 32767))
    return (int)cudaErrorInvalidValue;
  return dispatch(D, W, [&](auto d, auto) {
    constexpr int DD = decltype(d)::value;
    if (key_bytes == 2)
      nufft_bin_keys_kernel<T, DD, int16_t><<<blocks, kThreads, 0,
                                              (cudaStream_t)stream>>>(
          (const T*)k, k_bs, (int16_t*)keys, nT, g, tl);
    else
      nufft_bin_keys_kernel<T, DD, int32_t><<<blocks, kThreads, 0,
                                              (cudaStream_t)stream>>>(
          (const T*)k, k_bs, (int32_t*)keys, nT, g, tl);
    return (int)cudaGetLastError();
  });
}

inline int launch_bin_offsets(const void* skeys, void* bin_start,
                              void* sub_first, int64_t Nk, int64_t nT,
                              int64_t nbins, int64_t P, int64_t key_bytes,
                              void* stream) {
  dim3 blocks;
  if (!grid_of(Nk, nT, blocks) || nT > 2147483647LL || nbins < 1 ||
      nbins > 2147483646LL || P < 1 || (key_bytes != 2 && key_bytes != 4) ||
      (key_bytes == 2 && nbins > 32767))
    return (int)cudaErrorInvalidValue;
  if (key_bytes == 2)
    nufft_bin_starts_kernel<int16_t><<<blocks, kThreads, 0,
                                       (cudaStream_t)stream>>>(
        (const int16_t*)skeys, (int32_t*)bin_start, nT, nbins);
  else
    nufft_bin_starts_kernel<int32_t><<<blocks, kThreads, 0,
                                       (cudaStream_t)stream>>>(
        (const int32_t*)skeys, (int32_t*)bin_start, nT, nbins);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nufft_sub_first_kernel<<<(unsigned)Nk, kScanThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)bin_start, (int32_t*)sub_first, nbins, P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_spread(const void* s, const void* k, const void* perm,
                  const void* bin_start, const void* sub_first, void* part,
                  void* grid, const double* geo, const int64_t* tiles,
                  int64_t k_bs, int64_t N, int64_t nT, int64_t D, int64_t W,
                  int64_t nsub_max, void* stream) {
  dim3 rblocks;
  if (!grid_of(N, nT, rblocks) || D < 1 || D > 3 || nsub_max < 1 ||
      nsub_max > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const Geo<T> g = geo_of<T>(geo);
  Tiles tl;
  if (!tiles_of(tiles, D, W, g.G, tl)) return (int)cudaErrorInvalidValue;
  int64_t nG = 1;
  for (int a = 0; a < D; ++a) nG *= g.G[a];
  // the reduction's index arithmetic is 32-bit
  if (nG > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int64_t nrb = (nG + kThreads - 1) / kThreads;
  return dispatch(D, W, [&](auto d, auto w) {
    constexpr int DD = decltype(d)::value, KW = decltype(w)::value;
    auto* kern = nufft_spread_bins_kernel<T, DD, KW>;
    // the padded tile (re, im), then a chunk's staged samples
    const size_t smem =
        (size_t)(2 * tl.npts + kWarp * Stage<T, DD>::row((int)W)) *
        sizeof(T);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kern<<<dim3((unsigned)nsub_max, (unsigned)N), kWarp, smem,
           (cudaStream_t)stream>>>(
        (const T*)s, (const T*)k, k_bs, (const int64_t*)perm,
        (const int32_t*)bin_start, (const int32_t*)sub_first, (T*)part,
        nsub_max, nT, (int)W, g, tl);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    nufft_spread_reduce_kernel<T><<<dim3((unsigned)nrb, (unsigned)N),
                                    kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)part, (const int32_t*)sub_first, (T*)grid, k_bs, nsub_max,
        nG, g, D, tl);
    return (int)cudaGetLastError();
  });
}

}  // namespace mrphy_nufft

// The bins of k (Nk, D, nT): keys (Nk, nT), int16 (key_bytes 2) or
// int32 (4); geo the 17 doubles of kernels/nufft.py `Geom.consts` and
// tiles the 12 int64s of `spread_tiles` (host memory); k_bs: k's batch
// stride. Returns the cudaError_t of the launch.
#define MRPHY_NUFFT_BIN_KEYS_ENTRY(NAME, T)                                  \
  extern "C" int NAME(const void* k, void* keys, const void* geo,           \
                      const void* tiles, int64_t k_bs, int64_t Nk,          \
                      int64_t nT, int64_t D, int64_t W, int64_t key_bytes,  \
                      void* stream) {                                        \
    return mrphy_nufft::launch_bin_keys<T>(k, keys, (const double*)geo,     \
                                           (const int64_t*)tiles, k_bs,     \
                                           Nk, nT, D, W, key_bytes, stream); \
  }

MRPHY_NUFFT_BIN_KEYS_ENTRY(mrphy_nufft_bin_keys_f32, float)
MRPHY_NUFFT_BIN_KEYS_ENTRY(mrphy_nufft_bin_keys_f64, double)

// The sorted keys skeys (Nk, nT) (int16 or int32 by key_bytes) → each
// row's bin starts bin_start and first subproblems sub_first (Nk, nbins +
// 1) int32, subproblems of at most P samples. Returns the cudaError_t of
// the launches.
extern "C" int mrphy_nufft_bin_offsets(const void* skeys, void* bin_start,
                                       void* sub_first, int64_t Nk,
                                       int64_t nT, int64_t nbins, int64_t P,
                                       int64_t key_bytes, void* stream) {
  return mrphy_nufft::launch_bin_offsets(skeys, bin_start, sub_first, Nk, nT,
                                         nbins, P, key_bytes, stream);
}

// s (N, nT, 2), k (Nk, D, nT), the plan of kernels/nufft.py `bin_plan`
// (perm (Nk, nT) int64, bin_start and sub_first (Nk, nbins + 1) int32; Nk
// rows, or one row shared when k_bs is 0), the partial buffer part (N,
// nsub_max, npts, 2) and the grid (N, ΠG, 2), every point of which is
// written; geo, tiles and k_bs as above. Launches the subproblems' kernel,
// then the reduction. Returns the cudaError_t of the launches.
#define MRPHY_NUFFT_SPREAD_ENTRY(NAME, T)                                    \
  extern "C" int NAME(const void* s, const void* k, const void* perm,       \
                      const void* bin_start, const void* sub_first,         \
                      void* part, void* grid, const void* geo,              \
                      const void* tiles, int64_t k_bs, int64_t N,           \
                      int64_t nT, int64_t D, int64_t W, int64_t nsub_max,   \
                      void* stream) {                                        \
    return mrphy_nufft::launch_spread<T>(                                    \
        s, k, perm, bin_start, sub_first, part, grid, (const double*)geo,   \
        (const int64_t*)tiles, k_bs, N, nT, D, W, nsub_max, stream);        \
  }

MRPHY_NUFFT_SPREAD_ENTRY(mrphy_nufft_spread_f32, float)
MRPHY_NUFFT_SPREAD_ENTRY(mrphy_nufft_spread_f64, double)
